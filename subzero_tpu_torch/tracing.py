"""The port's instrumentation: layer marks inside the device step, the
step's work counters, and host spans.

**Marks** (``Marks``).  A ``StepGraph`` owns one ``Marks``, and the step's
bodies call it at each boundary between two of the step's layers, in step
order (``LAYERS``): mark k closes layer k.

  ====  ===============================================  ===========
  mark  after                                            closes
  ====  ===============================================  ===========
  0     the previous step's last mark (or collide's)     ``gap``
  1     open-boundary removal and ``narrow_phase_batch``  ``broad``
  2     the narrow phase (B1) and the slow clip (B2)     ``clip``
  3     the sides' gather, both force laws, the marking  ``force``
  4     the contact sums, stress, ``update_boundaries``  ``sums``
  5     the coupling (or nothing, on a step without it)  ``couple``
  6     integrate, wrap, remove, the flags' writes       ``integrate``
  ====  ===============================================  ===========

On the card a mark is a one-block kernel of the port's own library
(``csrc/marks.cu``, one name a mark: ``subzero_mark<k>``), launched on the
current stream, so a CUDA graph captures it with the step.  It reads the
device's clock (``%globaltimer``), adds the time since the previous mark to
the layer's accumulator and keeps the new time; mark 6 counts the step.
``gap`` is the device's time between steps: the host's turn between
replays and between calls, and between the two halves of a split step.  On
the CPU the same marks read ``time.perf_counter_ns()`` (the step is
synchronous there).

Mark 1 also counts the candidate pairs (the broad phase's valid rows) and,
on the binned broad phase, reads its two counts (``bins``: the slot tests
of the step, each live floe against the occupied slots of its neighbour
bins, and the fullest bin's floes, beside the bins' capacity M); mark 2
reads the slow rows (``n_slow``): each adds to a sum and to the largest
value since ``begin_call`` zeroed it.  The dense broad phase hands mark 1
no bin counts, and those counters stay 0.  One counter is added to by a
kernel of its layer itself (``window_cells``): the coupling's cell clip
adds the (floe, window cell) pairs it clipped (a sum only).  Everything
sits in one small buffer on the pool's device, beside the step's flags
(fuse marked, overflow) and its overflow count, so it reaches the host only
in the reads that the run loops make anyway (``read``; ``stats`` gives what
it read).
The marks are always on: a step runs its 7 mark kernels whether or not a
profiler records.

**Spans** (``span``, ``Span``).  A span times a block of host code: its
count and ``perf_counter`` seconds go into the accumulator given (a
StepGraph's own spans go into its ``stats``) and into the one that the
innermost ``collecting`` opened (a run's ``run_stats["spans"]``).  While a
torch.profiler session records, a span also opens a ``record_function``
range of its name, which the trace puts on the device trace's clock; with
no session it makes no ``record_function`` call.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import time

import numpy as np
import torch

from .geometry import two_cross

LAYERS = ("gap", "broad", "clip", "force", "sums", "couple", "integrate")
MARK_STEP = len(LAYERS) - 1    # the mark that closes a step

# int64 slots of the marks' buffer (csrc/marks.cu): nanoseconds by layer
# (0-6), then these: each counter's sum, then each one's largest value, the
# overflow count, and the sums that a kernel of the step adds to itself
SLOTS = {"last": 7, "steps": 8, "pairs": 9, "slow_rows": 10, "bin_tests": 11,
         "bin_fill": 12, "pairs_max": 13, "slow_rows_max": 14, "bin_tests_max": 15,
         "bin_fill_max": 16, "n_over": 17, "window_cells": 18}
N_SLOTS = 19
COUNTERS = ("pairs", "slow_rows", "bin_tests", "bin_fill")
N_FLAGS = 2    # bool, after the int64 slots: fuse marked, overflow
# what ``Marks.stats`` gives of one call, not counts to take differences of:
# the counters' maxima since ``begin_call``, and the rows, slow rows and
# bin slots they are measured against
GAUGES = (*(name + "_max" for name in COUNTERS), "pair_rows", "slow_cap", "bin_cap")
# the slots that ``begin_call`` zeroes: the maxima and the overflow count
_CALL = slice(SLOTS["pairs_max"], SLOTS["n_over"] + 1)

SOURCES = (two_cross.CSRC_DIR / "marks.cu",)

_lib = None


def build(force: bool = False) -> dict:
    """Compile the marks' library if it is missing or older than its
    source."""
    return two_cross.build_library("marks", SOURCES, force)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        # k acc valid n n_slow bins stream
        lib.sz_mark.argtypes = [i, p, p, i, p, p, p]
        lib.sz_mark.restype = ctypes.c_int
        lib.sz_cuda_error_string.argtypes = [i]
        lib.sz_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class Marks:
    """The step's layer marks and work counters on ``device`` (see the
    module's docstring).  ``flags`` and ``n_over`` are views of the same
    buffer that the step writes.  ``on``: whether a call marks (a graph's
    warm-up turns it off, so that the run the warm-up throws away is not
    counted)."""

    def __init__(self, device):
        self.device = torch.device(device)
        nbytes = 8 * N_SLOTS + N_FLAGS
        self.raw = torch.zeros(nbytes, dtype=torch.uint8, device=self.device)
        self.acc = self.raw[:8 * N_SLOTS].view(torch.int64)
        self.flags = self.raw[8 * N_SLOTS:].view(torch.bool)
        self.n_over = self.acc[SLOTS["n_over"]]
        self.on = True
        self.pair_rows = 0
        self.slow_cap = 0
        self.bin_cap = 0
        self._card = self.device.type == "cuda"
        # the buffer as the host sees it: a pinned copy that ``read`` fills
        # on the card; on the CPU the buffer itself, which the marks write
        # through a numpy view (no torch op, no read)
        host = (torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
                if self._card else self.raw)
        self._host_raw = host
        self._host_slots = host.numpy()[:8 * N_SLOTS].view(np.int64)
        self._host_flags = host.numpy()[8 * N_SLOTS:]
        self._zeros = torch.zeros(_CALL.stop - _CALL.start, dtype=torch.int64,
                                  pin_memory=self._card)

    def __call__(self, k: int, pairs=None, slow=None, slow_cap: int = 0,
                 bins=None, bin_cap: int = 0) -> None:
        """Mark ``k``.  ``pairs``: the candidate rows' validity (bool) to
        count; ``slow``: the number of slow rows (a 0-d int64 tensor) of a
        clip with ``slow_cap`` rows; ``bins``: the binned broad phase's
        slot tests and fullest bin (a [2] int64 tensor) over bins of
        ``bin_cap`` slots."""
        if not self.on:
            return
        if pairs is not None:
            self.pair_rows = pairs.shape[0]
        if slow is not None:
            self.slow_cap = slow_cap
        if bins is not None:
            self.bin_cap = bin_cap
        if self._card:
            self._launch(k, pairs, slow, bins)
            return
        h = self._host_slots
        now = time.perf_counter_ns()
        last = h[SLOTS["last"]]
        if last:
            h[k] += now - last
        h[SLOTS["last"]] = now
        if k == MARK_STEP:
            h[SLOTS["steps"]] += 1
        if pairs is not None:
            self._count("pairs", pairs.sum())
        if slow is not None:
            self._count("slow_rows", slow)
        if bins is not None:
            self._count("bin_tests", bins[0])
            self._count("bin_fill", bins[1])

    def window_cells(self):
        """The slot that the coupling's cell clip adds the cells it clipped
        to, a 0-d int64 view of the buffer (the plain path on the CPU adds
        by a torch op), or None while marking is off."""
        return self.acc[SLOTS["window_cells"]] if self.on else None

    def _count(self, name: str, value) -> None:
        """Add ``value`` to a counter and its maximum, by torch ops, so that
        the CPU's step reads nothing on the host either."""
        acc, top = self.acc, SLOTS[name + "_max"]
        acc[SLOTS[name]] += value
        acc[top] = torch.maximum(acc[top], value)

    def _launch(self, k, pairs, slow, bins) -> None:
        lib = _load()
        valid, n = None, 0
        if pairs is not None:
            if pairs.dtype != torch.bool or not pairs.is_contiguous():
                raise ValueError("a mark counts a contiguous bool tensor")
            valid, n = pairs.data_ptr(), pairs.shape[0]
        n_slow = None
        if slow is not None:
            if slow.dtype != torch.int64 or slow.dim() != 0:
                raise ValueError("a mark reads a 0-d int64 count of slow rows")
            n_slow = slow.data_ptr()
        bin_counts = None
        if bins is not None:
            if bins.dtype != torch.int64 or bins.shape != (2,) or not bins.is_contiguous():
                raise ValueError("a mark reads the bins' two counts as a contiguous "
                                 "[2] int64 tensor")
            bin_counts = bins.data_ptr()
        rc = lib.sz_mark(k, self.acc.data_ptr(), valid, n, n_slow, bin_counts,
                         torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mark {k} launch failed: "
                               f"{lib.sz_cuda_error_string(rc).decode()} ({rc})")

    def begin_call(self) -> None:
        """Start a call: zero the counters' maxima and the overflow count,
        in the host's copy and on the device, by a copy from the host
        (no kernel: the step's kernels and the marks are all a trace
        counts)."""
        self._host_slots[_CALL] = 0
        self.acc[_CALL].copy_(self._zeros, non_blocking=True)

    def read(self) -> tuple[list, int]:
        """The buffer on the host, in one read (on the card the only read
        of the device in this module): returns (flags, overflow count);
        ``stats`` then gives the counters read."""
        if self._card:
            self._host_raw.copy_(self.raw)
        return self._host_flags.tolist(), int(self._host_slots[SLOTS["n_over"]])

    def stats(self) -> dict:
        """The numbers of the last ``read``: seconds by layer, steps marked,
        the ``COUNTERS`` (candidate pairs, slow rows, bin slot tests,
        fullest bins) and the window cells clipped, cumulative; and the
        ``GAUGES``."""
        s = self._host_slots.tolist()
        return {"layer_s": {name: 1e-9 * s[k] for k, name in enumerate(LAYERS)},
                "steps_marked": s[SLOTS["steps"]],
                **{name: s[SLOTS[name]] for name in (*COUNTERS, "window_cells")},
                **{name + "_max": s[SLOTS[name + "_max"]] for name in COUNTERS},
                "pair_rows": self.pair_rows, "slow_cap": self.slow_cap,
                "bin_cap": self.bin_cap}


# ---------------------------------------------------------------------------
# host spans

def new_spans() -> dict:
    """An empty accumulator of spans: seconds and count by name."""
    return {"seconds": {}, "count": {}}


def _add(into: dict, name: str, seconds: float) -> None:
    into["seconds"][name] = into["seconds"].get(name, 0.0) + seconds
    into["count"][name] = into["count"].get(name, 0) + 1


_collecting = contextvars.ContextVar("subzero_spans", default=None)


@contextlib.contextmanager
def collecting(into: dict):
    """Spans that name no accumulator go into ``into`` inside this block."""
    token = _collecting.set(into)
    try:
        yield into
    finally:
        _collecting.reset(token)


_autograd_profiler = torch.autograd.profiler


def profiling() -> bool:
    """Whether a torch.profiler session is recording."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """Times a block into ``into`` (an accumulator of ``new_spans``, or
    None) and into the one ``collecting`` opened, and, while a profiler
    records, opens a ``record_function`` range of ``range_name()``."""

    def __init__(self, name: str, into: dict | None = None):
        self.name = name
        self.into = into

    def __enter__(self):
        self._range = None
        if profiling():
            self._range = torch.profiler.record_function(self.range_name())
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.record(time.perf_counter() - self.t0)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False

    def range_name(self) -> str:
        return self.name

    def record(self, seconds: float) -> None:
        if self.into is not None:
            _add(self.into, self.name, seconds)
        cur = _collecting.get()
        if cur is not None and cur is not self.into:
            _add(cur, self.name, seconds)


def span(name: str, into: dict | None = None) -> Span:
    return Span(name, into)
