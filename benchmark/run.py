"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python -m benchmark.run --workload shear_flow.scan --seed 7 --seconds 30 --trace 0

Builds the cell's field from ``--seed``, loads the kernels, captures the
step's graphs and warms up (set-up), then drives the program's public entry
for ``--seconds`` (the window, ``benchmark.harness``), then holds the
program's answers to the plain reference (``benchmark.check``).  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled and a
sync-counted stretch of the window (``benchmark.trace``).

The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error, each beside its limit.  It exits
with another code than 0 and prints no result where no CUDA card is there,
or fewer than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``subzero_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
_CACHE = ROOT / ".bench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402

import torch  # noqa: E402

from . import check, harness
from .inputs import make_inputs  # noqa: E402
from .trace import Profiled, SyncCounted  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "subzero_tpu")


def since_process_start() -> float:
    """Seconds since this process started (/proc, 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def load_reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "benchmark.metrics"
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end ones, or with a trace
    its per-layer ones (those that list it, or list no cells)."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Run:
    """What a finished run holds for the metrics' readers."""
    cell: harness.Cell
    window: harness.Window
    setup_s: float
    setup_split: dict
    memory_peak_bytes: int
    profile: dict = None
    profiled_steps: int = 0
    syncs: dict = None
    roofline: dict = dataclasses.field(default_factory=dict)
    traced_calls: set = dataclasses.field(default_factory=set)

    def plain_calls(self) -> list:
        """The window's calls outside the traced stretches."""
        return [r for r in self.window.records
                if (r.pass_no, r.call_no) not in self.traced_calls]


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device: str, clock=since_process_start):
    """One run of ``cell``: set-up, window, check.  Returns (Run, the
    check's numbers, correct, the numbers beside their limits, failed)."""
    on_card = device == "cuda"
    # the interpreter's start and torch's import, then the port's
    split = {"torch_import_s": clock()}
    port = harness.port_package()
    split["port_import_s"] = clock() - split["torch_import_s"]
    t = time.perf_counter()
    if on_card:
        from subzero_tpu_torch import native
        from subzero_tpu_torch.geometry import regions, two_cross

        # nvcc and g++ run only where the checkout has no build yet
        two_cross.build()
        regions.build()
        native.build()
        split["kernel_build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        two_cross._load()
        regions._load()
        native.get_lib()
    split["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    inp = make_inputs(cell.cfg, seed)
    sim = harness.build_program(cell, inp, device)
    split["field_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    driver = harness.Driver(sim, cell, port.simulation)
    harness.warm_up(driver)
    graph = sim._graph
    split["graph_capture_s"] = graph.stats["capture_seconds"] if graph is not None else 0.0
    split["warm_up_s"] = time.perf_counter() - t - split["graph_capture_s"]
    program_caps = check.capacities(sim)

    samples = harness.sample_calls(cell, seed)
    states = {}
    stretches = []
    if trace:
        tr = cell.spec["trace"]

        def keep(when):
            states[when] = sim.model

        prof = Profiled(tr["profile"], port.simulation, keep)
        syncs = SyncCounted(tr["syncs"])
        stretches = [prof, syncs]
    hooks = harness.Hooks(driver, samples, stretches)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.synchronize()
    setup_s = clock()
    window = harness.run_window(driver, seconds, hooks, sync)
    peak = torch.cuda.max_memory_reserved() if on_card else 0
    run = Run(cell, window, setup_s, split, peak)
    if trace:
        run.profile = prof.summary()
        run.profiled_steps = (run.profile or {}).get("calls", 0) * cell.call_steps
        run.syncs = {"steps": len(syncs.call_ids) * cell.call_steps,
                     "by_line": dict(syncs.by_line.most_common())}
        run.traced_calls = set(prof.call_ids) | set(syncs.call_ids)
    snaps = hooks.snapshots()
    initial = driver.initial
    # the program's state is freed before the reference runs
    sim._graph = None
    del driver, sim, graph, hooks
    harness.free()

    t = time.perf_counter()
    ref_sim = harness.build_reference(cell, inp, device)
    numbers = check.start_numbers(initial, program_caps, ref_sim.model,
                                  check.capacities(ref_sim))
    numbers.update(check.step_numbers(ref_sim, cell, snaps))
    numbers["check_seconds"] = time.perf_counter() - t
    if trace:
        run.roofline = roofline_bounds(states, ref_sim, device)
    ok, shown, failed = check.verdict(numbers, cell.spec["check"]["limits"])
    return run, numbers, ok, shown, failed


def roofline_bounds(states: dict, ref_sim, device: str) -> dict:
    """Each kernel's bound (``roofline/<kernel>.py``), the mean over the
    profiled stretch's first and last states, on a card the peaks table
    holds."""
    import pkgutil

    from . import peaks, roofline

    pk = peaks.of(torch.cuda.get_device_name()) if device == "cuda" else None
    if pk is None or set(states) != {"start", "end"}:
        return {}
    out = {}
    for info in pkgutil.iter_modules(roofline.__path__):
        mod = importlib.import_module(f"benchmark.roofline.{info.name}")
        bs = [mod.bound(mod.launch_inputs(check.as_reference_model(states[w], ref_sim.model),
                                          ref_sim), pk)
              for w in ("start", "end")]
        out[info.name] = dict(bs[0], bound_s=sum(b["bound_s"] for b in bs) / 2,
                              bound_s_at=[b["bound_s"] for b in bs])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    err = sys.stderr

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload named {args.workload!r} in BENCHMARK.json", file=err)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=err)
        return 3
    if torch.cuda.device_count() < wl["chips"]:
        print(f"the cell asks for {wl['chips']} cards, {torch.cuda.device_count()} here",
              file=err)
        return 3
    cell = harness.load_cell(args.workload)
    wanted = cell_metrics(bench, args.workload, bool(args.trace))
    readers = {m["name"]: load_reader(m["name"]) for m in wanted}
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=err)

    warnings.filterwarnings("ignore", module="subzero_tpu_torch")
    with contextlib.redirect_stdout(err):
        run, numbers, ok, shown, failed = run_cell(
            cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded once the window closed: {found}", file=err)
        return 4

    if args.trace and run.profile is None:
        print("trace: no measured call has every launch in the trace, so no per-layer "
              "metric can be read", file=err)
        return 5
    w = run.window
    print(f"setup: {json.dumps(run.setup_split)} setup_s {run.setup_s}", file=err)
    print(f"window: {w.seconds} s, {len(w.records)} calls of {cell.call_steps} steps, "
          f"{w.steps} steps, {1 + max(r.pass_no for r in w.records)} passes begun, "
          f"overflow steps {sum(r.overflow_steps for r in w.records)}, graph captures "
          f"{sum((r.graph_stats or {}).get('captures', 0) for r in w.records)}", file=err)
    print(f"intervals: count {len(w.records)}, median ms "
          f"{1e3 * harness.percentile([r.seconds for r in w.records], 50)}", file=err)
    if run.profile is not None:
        print("trace: " + json.dumps({k: run.profile[k] for k in (
            "launches", "launches_without_event", "calls", "calls_dropped")}), file=err)
    if run.syncs is not None:
        print(f"host syncs in {run.syncs['steps']} steps, by line: "
              f"{json.dumps(run.syncs['by_line'])}", file=err)
    for k, b in run.roofline.items():
        print(f"roofline {k}: " + json.dumps({x: b[x] for x in (
            "bytes", "operations", "rows", "live_rows", "bound_s", "bound_s_at", "bound_by")}),
            file=err)
    print("check details: " + json.dumps(
        {k: v for k, v in numbers.items() if k != "answers"}), file=err)

    metrics = {}
    for m in wanted:
        v = readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
              "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": ok, "attempted": len(w.records), "failed": failed,
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = shown
    for k, v in shown.items():
        print(f"check {k}: {v['value']} limit {v['limit']}", file=err)
    err.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
