"""The traced run's instruments, each over a stretch of the window's calls
that the cell's file names (``trace``):

  * ``Profiled``: one torch.profiler session (CPU and CUDA activity) over
    ``lead_calls`` unmeasured calls and then ``calls`` measured ones, inside
    a ``bench.measured`` range that starts and ends on a device
    synchronisation.  The profiler drops a trace's first launches (the H100
    with torch 2.11, PERF.md), which the lead takes.  Only the measured
    calls' own device activity is read: each host launch call of the
    measured range (a kernel, graph, copy or memset launch) is matched to
    its device events by correlation id, and the reading starts after the
    last measured call that has a launch with no device event, so that it
    comes from whole calls only (none whole: no reading).  One session
    only: a profiled replay of a graph captured before an earlier session
    crashed the profiler there.  ``summary`` reduces the trace to busy and
    window seconds, kernels, each kernel's events (all, and those of graph
    replays: the step's own), and the longest idle gaps by the host-side
    range that held them;
  * ``SyncCounted``: ``torch.cuda.set_sync_debug_mode("warn")`` over
    ``calls`` calls, every host synchronisation counted by its source line.

Spans: each call of the program's entry is a ``bench.call`` range and each
of the program's host passes a ``host_pass.<name>`` range (its
``simulation._HostPass`` timer, wrapped while the stretch is profiled).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import os
import warnings

import torch


class Stretch:
    """Calls ``first_call`` .. ``first_call + calls - 1`` of pass
    ``pass_no`` (after ``lead_calls`` more before them)."""

    def __init__(self, spec: dict):
        self.pass_no = spec["pass"]
        self.first = spec["first_call"]
        self.calls = spec["calls"]
        self.lead = spec.get("lead_calls", 0)
        self.done = False
        self.started = False
        self.call_ids = []

    def _starts(self, p, k):
        return p == self.pass_no and k == self.first - self.lead

    def _measuring(self, p, k):
        return p == self.pass_no and self.first <= k < self.first + self.calls

    def _ends(self, p, k):
        return p == self.pass_no and k == self.first + self.calls - 1

    def before(self, p, k):
        if self.done:
            return
        if self._starts(p, k):
            self.start()
            self.started = True
        if self.started and p == self.pass_no and k == self.first:
            self.begin_measured()

    def after(self, p, k):
        if not self.started or self.done:
            return
        if self._measuring(p, k):
            self.call_ids.append((p, k))
        if self._ends(p, k):
            self.end_measured()
            self.stop()
            self.done = True

    def start(self):
        pass

    def begin_measured(self):
        pass

    def end_measured(self):
        pass

    def stop(self):
        pass


class Profiled(Stretch):
    def __init__(self, spec, simulation_module, on_measured=None):
        super().__init__(spec)
        self.sm = simulation_module
        self.on_measured = on_measured   # (when, ) -> None: "start" / "end"
        self.prof = None
        self._ranges = contextlib.ExitStack()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._wrap_host_passes()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def begin_measured(self):
        from torch.profiler import record_function

        torch.cuda.synchronize()
        if self.on_measured is not None:
            self.on_measured("start")
        self._ranges.enter_context(record_function("bench.measured"))

    def end_measured(self):
        torch.cuda.synchronize()
        self._ranges.close()
        if self.on_measured is not None:
            self.on_measured("end")

    def stop(self):
        self.prof.__exit__(None, None, None)
        self._unwrap_host_passes()

    def _wrap_host_passes(self):
        from torch.profiler import record_function

        cls = self.sm._HostPass
        self._saved = (cls.__enter__, cls.__exit__)
        enter, exit_ = self._saved

        def wrapped_enter(hp):
            hp._bench_range = record_function(f"host_pass.{hp.name}")
            hp._bench_range.__enter__()
            return enter(hp)

        def wrapped_exit(hp, *exc):
            out = exit_(hp, *exc)
            hp._bench_range.__exit__(None, None, None)
            return out

        cls.__enter__, cls.__exit__ = wrapped_enter, wrapped_exit

    def _unwrap_host_passes(self):
        self.sm._HostPass.__enter__, self.sm._HostPass.__exit__ = self._saved

    def summary(self, top: int = 10) -> dict:
        """Busy and window seconds of the measured range's whole calls,
        kernels and other device activity of theirs, events by kernel name,
        and the longest idle gaps, each named by the innermost host range
        that held its midpoint (with the outermost one before it).  None
        where no measured call is whole."""
        from torch.autograd import DeviceType

        ev = self.prof.profiler.kineto_results.events()
        span = next(e for e in ev if e.name() == "bench.measured")
        t0, t1 = span.start_ns(), span.end_ns()
        calls = sorted(e.start_ns() for e in ev if e.name() == "bench.call"
                       and e.device_type() == DeviceType.CPU and t0 <= e.start_ns() <= t1)
        launches = [(e.start_ns(), e.correlation_id(), e.name()) for e in ev
                    if e.device_type() == DeviceType.CPU and _is_launch(e.name())
                    and t0 <= e.start_ns() <= t1]
        on_card = collections.defaultdict(list)
        for e in ev:
            if e.device_type() == DeviceType.CUDA and not _annotation(e):
                on_card[e.correlation_id()].append(e)
        missing = [s for s, c, _ in launches if c not in on_card]
        first = bisect.bisect_right(calls, max(missing)) if missing else 0
        if first >= len(calls):
            return None
        if first:
            t0 = calls[first]
        kept = [(c, n) for s, c, n in launches if s >= t0]
        graph_launch = {c for c, n in kept if "GraphLaunch" in n}
        dev, dev_graph, host = [], [], []
        for c, _ in kept:
            for e in on_card[c]:
                s = e.start_ns()
                dev.append((s, s + e.duration_ns(), e.name()))
                if c in graph_launch:
                    dev_graph.append((s, s + e.duration_ns(), e.name()))
        for e in ev:
            s = e.start_ns()
            if e.device_type() == DeviceType.CPU and e.duration_ns() > 0:
                if s <= t1 and s + e.duration_ns() >= t0:
                    host.append((s, s + e.duration_ns(), e.name()))
        dev.sort()
        kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
        by_kernel = collections.defaultdict(list)
        for s, e, n in kernels:
            by_kernel[n].append((e - s) * 1e-9)
        by_kernel_graph = collections.defaultdict(list)
        for s, e, n in dev_graph:
            by_kernel_graph[n].append((e - s) * 1e-9)
        # busy: the union of the device's activity; idle gaps between
        busy, gaps, cur_s, cur_e = 0, [], None, None
        for s, e, _ in dev:
            if cur_e is None:
                cur_s, cur_e = s, e
                if s > t0:
                    gaps.append((t0, s))
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            if t1 > cur_e:
                gaps.append((cur_e, t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:top]:
            mid = (a + b) // 2
            holding = [h for h in host if h[0] <= mid <= h[1] and h[2] != "bench.measured"]
            holding.sort(key=lambda h: h[1] - h[0])
            if holding:
                label = holding[0][2] if len(holding) == 1 else f"{holding[-1][2]} > {holding[0][2]}"
            else:
                label = "host: no traced range"
            named.append([label, (b - a) * 1e-9])
        ops = sorted(((n, sum(d)) for n, d in by_kernel.items()), key=lambda x: -x[1])
        return {"window_s": (t1 - t0) * 1e-9, "busy_s": busy * 1e-9,
                "calls": len(calls) - first, "calls_dropped": first,
                "launches": len(launches), "launches_without_event": len(missing),
                "kernels": len(kernels), "device_events": len(dev),
                "by_kernel": dict(by_kernel), "by_kernel_graph": dict(by_kernel_graph),
                "device_ops": [[n[:200], s] for n, s in ops[:top]],
                "idle_gaps": named}


def _is_launch(name: str) -> bool:
    """A host call of the CUDA runtime or driver that puts work on the
    device: a kernel, a graph, a copy or a memset."""
    return name.startswith("cu") and any(k in name for k in ("Launch", "Memcpy", "Memset"))


def _annotation(e) -> bool:
    """A device-side copy of a host ``record_function`` range (the trace
    puts one on the device's timeline), not device activity."""
    if getattr(e, "is_user_annotation", None) is not None and e.is_user_annotation():
        return True
    kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") else ""
    return "annotation" in kind or e.name().startswith(("bench.", "host_pass."))


class SyncCounted(Stretch):
    """Host synchronisations over the stretch's calls, by source line."""

    def __init__(self, spec):
        super().__init__(spec)
        self.by_line = collections.Counter()
        self._rec = None

    def begin_measured(self):
        torch.cuda.synchronize()
        self._cw = warnings.catch_warnings(record=True)
        self._rec = self._cw.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def end_measured(self):
        # switching the mode back synchronises once itself: not counted
        rec = list(self._rec)
        torch.cuda.set_sync_debug_mode("default")
        self._cw.__exit__(None, None, None)
        for w in rec:
            if "synchroniz" in str(w.message):
                self.by_line[f"{os.path.relpath(w.filename)}:{w.lineno}"] += 1
