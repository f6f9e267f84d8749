"""The device step as a captured CUDA graph: the port's counterpart of the
JAX package's jitted ``lax.scan`` (``subzero_tpu/simulation.py:231-252``)
and ``lax.while_loop`` (``:433-500``).

A step is ~2 700 small kernels; launched one by one from Python the host
spends ~13 us on each, and the card idles most of the step.  On the card a
``StepGraph`` captures the step once and replays it: one graph launch a
step, no host read between steps.  The step's body is the eager one
(``simulation.build_step_bodies``): every shape is fixed and nothing in it
reads the device, so the same function runs on the CPU and is captured on
the card.

A ``StepGraph`` owns static buffers: its own copies of the floe pool, the
ocean and the domain, and a few scalars.  A program reads them and writes
its outputs back into them, inside the graph, so a replay leaves the next
step's inputs in place.  The caller's tensors are never written: the state
it hands in is copied in (``load``) and the state it gets back is a copy
(``state``).  Programs, each captured on first need and sharing one memory
pool:

  * ``("step", couple)``: the whole step, with or without the coupling
    (its cadence is a host branch on the Python ``tstep``);
  * ``("collide",)`` and ``("finish", couple)``: the two halves, for the
    step that runs the host's ridge/raft pass between them (``run``).

A program is warmed up once before its capture (run eagerly on a side
stream, outputs dropped: cuBLAS handles, the kernels' libraries, the
allocator), as ``torch.cuda.graphs`` asks.  The launches of the step's
hand-written kernels (``KERNELS``: the narrow phase, the slow clip, the
force law and the coupling's cell clip) are counted where they run: the warm-up's by the kernel's
wrapper, a replay's by the graph (``add_replayed``, the launches the
program captured; ``chip_smoke.py``'s ``graph`` phase holds that count
against the kernels' runs on the card, by torch.profiler).

The step's bodies carry the graph's layer marks (``tracing.Marks``): a
mark opens each program and one closes each step, and the bodies mark the
layers between, inside the capture.  Their buffer holds the step's flags
and overflow count too, so ``marks.read``, the one host read of a call
(``run_scan``) or of a step (``run``), brings every counter with it;
``stats`` gives what it last read (seconds by layer, steps marked, candidate
pairs, slow rows, the binned broad phase's slot tests and fullest bins and
the window cells the coupling clipped, cumulative; the counters' maxima since the call's
``marks.begin_call``) and the graph's own host spans.

A Simulation keeps its StepGraph (``Simulation.step_graph``), so a later
``run_scan`` or ``run`` replays the captures of an earlier one; a state of
another shape is captured again, and other settings make a new StepGraph.

On the CPU there is nothing to capture: a "replay" calls the program
directly on the same buffers, so the CPU tests run the buffers, the
copy-back and the choice of program.  On the card ``_eager=True`` does the
same (the private reference that ``chip_smoke.py`` and the card's tests
hold the graph against).  A capture that fails raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from . import tracing
from .core.fields import OceanState
from .core.floes import FloeState
from .geometry import regions as _regions
from .geometry import two_cross as _two_cross
from .physics import cell_clip as _cell_clip
from .physics import forces as _forces

# the step's hand-written kernels, whose wrappers count their launches
KERNELS = {"two_cross": _two_cross, "regions": _regions, "forces": _forces,
           "cell_clip": _cell_clip}

_warmup_launches = dict.fromkeys(KERNELS, 0)


def warmup_launch_count(kernel: str = "two_cross") -> int:
    """Launches of one of ``KERNELS`` made by every StepGraph's warm-ups so
    far (each program runs once eagerly before its capture; the launches
    are real and counted by the kernel's wrapper too).  Never reset."""
    return _warmup_launches[kernel]


def _leaves(floes, ocean, domain) -> list:
    """The state's tensors in a fixed order."""
    return [*floes, *ocean, domain.vals, domain.velocities, *domain.topography]


def _rebuild(leaves, floes_t, ocean_t, domain_t):
    """(floes, ocean, domain) from ``_leaves``-ordered tensors."""
    nf, no = len(floes_t), len(ocean_t)
    floes = FloeState(*leaves[:nf])
    ocean = OceanState(*leaves[nf:nf + no])
    vals, vel, *topo = leaves[nf + no:]
    domain = dataclasses.replace(domain_t, vals=vals, velocities=vel,
                                 topography=type(domain_t.topography)(*topo))
    return floes, ocean, domain


def _signature(leaves, domain) -> tuple:
    return (domain.kinds,) + tuple((t.shape, t.dtype, t.device) for t in leaves)


def _settings(sim) -> tuple:
    """What the step's bodies take from ``sim`` besides the state: objects
    (compared by identity: the settings are frozen, so a change is a new
    object) and values."""
    m = sim.model
    return ((m.grid, m.atmos, sim.consts, sim.floe_settings, sim.coupling_settings,
             sim.collision_settings),
            (sim.dt, sim.pair_cap, sim.cell_cap, sim.clip_cap, sim.bins,
             m.floes.verts.device))


class StepGraph:
    """The step of ``sim`` as CUDA graphs over static buffers (see the
    module's docstring).  ``load`` copies a state in, ``replay`` runs one
    program, ``state`` copies the state out.  ``flags`` holds the last
    step's (fuse marked, overflow) and ``n_over`` counts overflowed steps,
    both on the device, in the buffer of the step's marks (``marks``),
    which ``marks.read`` brings to the host.  ``stats`` counts captures,
    recaptures (after a state of another shape was loaded), their seconds,
    the warm-ups' kernel launches and the replays, and gives what
    ``marks.read`` last read and the graph's host spans (``spans``:
    ``step_graph.prepare``, ``.load``, ``.state``); ``capture_pool_bytes`` says by how much each
    program's capture grew the card's reserved memory (the programs share
    one pool, so a later capture reuses what an earlier one freed).  It
    holds what it reads of ``sim``, never ``sim``, so that ``sim`` can keep
    it (``Simulation.step_graph``)."""

    def __init__(self, sim, *, _eager: bool = False):
        from .simulation import build_step_bodies, couples

        m = sim.model
        self._settings = _settings(sim)
        self.device = m.floes.verts.device
        self.marks = tracing.Marks(self.device)
        self.collide, self.finish = build_step_bodies(sim, mark=self.marks)
        cps = sim.coupling_settings
        self.couples: Callable[[int], bool] = lambda t: couples(cps, t)
        self.capture = self.device.type == "cuda" and not _eager
        self._stats = {"captures": 0, "recaptures": 0, "capture_seconds": 0.0,
                       "warmup_launches": dict.fromkeys(KERNELS, 0), "replays": 0,
                       "spans": tracing.new_spans()}
        self._graphs = {}
        self._captured_launches = {}
        self.capture_pool_bytes = {}
        self._ever_captured = set()
        self._alloc(m.floes, m.ocean, m.domain)

    def made_for(self, sim) -> bool:
        """Whether this graph steps ``sim``: the same settings, device and
        grid (the state may differ, ``load`` takes it)."""
        (objs, vals), (objs2, vals2) = self._settings, _settings(sim)
        return all(a is b for a, b in zip(objs, objs2)) and vals == vals2

    @property
    def stats(self) -> dict:
        """The counters (see the class's docstring), with the marks' as
        their last ``marks.read`` brought them."""
        return {**self._stats, **self.marks.stats()}

    def snapshot(self) -> dict:
        """A copy of ``stats`` that later runs do not change."""
        return _copy(self.stats)

    def stats_since(self, before: dict) -> dict:
        """``stats`` less an earlier ``snapshot``: one run's counters (the
        warm-ups' launches by kernel, seconds by layer and by span), with
        the marks' ``GAUGES`` as they are."""
        return {k: v if k in tracing.GAUGES else _less(v, before.get(k))
                for k, v in self.stats.items()}

    # ------------------------------------------------------------------
    # static buffers
    def _alloc(self, floes, ocean, domain):
        leaves = _leaves(floes, ocean, domain)
        self._sig = _signature(leaves, domain)
        self._static = [t.clone() for t in leaves]
        self._ptrs = {t.untyped_storage().data_ptr() for t in self._static}
        self.floes, self.ocean, self.domain = _rebuild(
            self._static, floes, ocean, domain)
        dev = self.device
        self.stress_instant = torch.zeros_like(floes.stress_accum)
        self.ov1 = torch.zeros((), dtype=torch.bool, device=dev)
        self.flags, self.n_over = self.marks.flags, self.marks.n_over
        for t in (self.stress_instant, self.ov1, self.marks.raw):
            self._ptrs.add(t.untyped_storage().data_ptr())
        # graphs read and write these addresses: a new set drops them
        self._graphs.clear()
        self._captured_launches.clear()
        self.capture_pool_bytes.clear()
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None

    def load(self, floes=None, ocean=None, domain=None) -> None:
        """Copy a state into the static buffers (None: that part is
        unchanged).  A state of another shape reallocates them, and each
        program is captured again at its next replay."""
        with tracing.span("step_graph.load", self._stats["spans"]):
            self._load(floes, ocean, domain)

    def _load(self, floes, ocean, domain) -> None:
        floes = self.floes if floes is None else floes
        ocean = self.ocean if ocean is None else ocean
        domain = self.domain if domain is None else domain
        leaves = _leaves(floes, ocean, domain)
        if _signature(leaves, domain) != self._sig:
            self._alloc(floes, ocean, domain)
            return
        self._copy_in(zip(self._static, leaves))

    def state(self):
        """A copy of the current (floes, ocean, domain), which no replay
        writes."""
        with tracing.span("step_graph.state", self._stats["spans"]):
            return _rebuild([t.clone() for t in self._static], self.floes,
                            self.ocean, self.domain)

    def own(self, x):
        """``x`` (a tensor, or tuples, NamedTuples and dicts of them) with
        every tensor that shares memory with a static buffer copied, so a
        later replay does not change it."""
        if isinstance(x, torch.Tensor):
            return x.clone() if x.untyped_storage().data_ptr() in self._ptrs else x
        if isinstance(x, dict):
            return {k: self.own(v) for k, v in x.items()}
        if isinstance(x, tuple):
            parts = [self.own(v) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x

    # ------------------------------------------------------------------
    # programs
    def _compute(self, prog):
        """A program's outputs as (destination, value) pairs, without
        writing any static buffer."""
        kind = prog[0]
        f, o, d = self.floes, self.ocean, self.domain
        if kind == "collide":
            f2, d2, si, ov1 = self.collide(f, o, d)
            return (list(zip(_leaves(f, o, d), _leaves(f2, o, d2)))
                    + [(self.stress_instant, si), (self.ov1, ov1)])
        if kind == "step":
            f1, d1, si, ov1 = self.collide(f, o, d)
        else:
            f1, d1, si, ov1 = f, d, self.stress_instant, self.ov1
        f2, o2, d2, ov2 = self.finish(f1, o, d1, si, prog[1])
        ov = ov1 | ov2
        flags = torch.stack([torch.any(f2.fuse_with >= 0), ov])
        return (list(zip(_leaves(f, o, d), _leaves(f2, o2, d2)))
                + [(self.flags, flags), (self.n_over, self.n_over + ov.long())])

    def _copy_in(self, pairs) -> None:
        """Copy each (destination, source) pair.  A source that is its
        destination is left in place; one that shares memory with another
        static buffer is copied before any buffer is written, so that no
        copy reads what an earlier one wrote (``finish`` hands the stress
        buffer on as the pool's ``stress_instant``; a state loaded in may
        swap fields)."""
        pairs = [(dst, src) for dst, src in pairs if src is not dst]
        pairs = [(dst, src.clone() if src.untyped_storage().data_ptr() in self._ptrs
                  else src) for dst, src in pairs]
        for dst, src in pairs:
            dst.copy_(src)

    def _run(self, prog) -> None:
        """One program, eagerly: its outputs copied into the static
        buffers, between the program's first mark and, unless the program
        is the step's first half, the step's last."""
        self.marks(0)
        self._copy_in(self._compute(prog))
        if prog[0] != "collide":
            self.marks(tracing.MARK_STEP)

    def prepare(self, progs) -> None:
        """Capture every program of ``progs`` that has no graph yet (each
        warmed up first).  On the CPU, or with ``_eager``, nothing to do."""
        if not self.capture:
            return
        with tracing.span("step_graph.prepare", self._stats["spans"]):
            for prog in progs:
                if prog not in self._graphs:
                    self._capture(prog)

    def _capture(self, prog) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        n0 = {k: m.launch_count() for k, m in KERNELS.items()}
        self.marks.on = False
        try:
            with torch.cuda.stream(side):
                self._compute(prog)  # warm-up: outputs dropped, nothing marked
        finally:
            self.marks.on = True
        cur.wait_stream(side)
        n = {k: m.launch_count() - n0[k] for k, m in KERNELS.items()}
        for k in KERNELS:
            self._stats["warmup_launches"][k] += n[k]
            _warmup_launches[k] += n[k]
        graph = torch.cuda.CUDAGraph()
        c0 = {k: m.captured_count() for k, m in KERNELS.items()}
        # torch.cuda.graph empties the allocator's cache as it starts; done
        # here first, the reserved memory's growth is the pool's own
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(self.device)
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                self._run(prog)
        except Exception as e:
            raise RuntimeError(
                f"capturing the step's program {prog} as a CUDA graph failed"
            ) from e
        self.capture_pool_bytes[prog] = torch.cuda.memory_reserved(self.device) - r0
        self._captured_launches[prog] = {
            k: m.captured_count() - c0[k] for k, m in KERNELS.items()}
        self._graphs[prog] = graph
        self._stats["captures"] += 1
        if prog in self._ever_captured:
            self._stats["recaptures"] += 1
        self._ever_captured.add(prog)
        self._stats["capture_seconds"] += time.perf_counter() - t0

    def replay(self, prog) -> None:
        """Run one program: its graph on the card (captured first if it has
        none), the program itself on the CPU or with ``_eager``."""
        self._stats["replays"] += 1
        if not self.capture:
            self._run(prog)
            return
        if prog not in self._graphs:
            self._capture(prog)
        self._graphs[prog].replay()
        for k, m in KERNELS.items():
            m.add_replayed(self._captured_launches[prog][k])

    def captured_launches(self, kernel: str = "two_cross") -> dict:
        """Each captured program with the launches of one of ``KERNELS`` it
        holds: what one replay of it adds to the kernel's count."""
        return {p: n[kernel] for p, n in self._captured_launches.items()}

    def step_prog(self, tstep: int) -> tuple:
        return ("step", self.couples(tstep))

    def step(self, tstep: int) -> None:
        """One whole step at ``tstep``."""
        self.replay(self.step_prog(tstep))


def _copy(d: dict) -> dict:
    """``d`` with every dict in it copied (the values are numbers)."""
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in d.items()}


def _less(now, before):
    """``now`` less ``before``, numbers or dicts of them by key (a key that
    ``before`` lacks counts from 0)."""
    if isinstance(now, dict):
        before = before or {}
        return {k: _less(v, before.get(k)) for k, v in now.items()}
    return now - (before or 0)
