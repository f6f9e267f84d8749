"""The simulation loops (port of ``subzero_tpu/simulation.py``).

One step is the reference's process order for the device state:
collisions -> moving walls -> coupling (at its cadence) -> integration ->
periodic wrap -> removal/dissolution.  ``tstep`` is a Python int, so the
coupling cadence is a branch on the host.  ``run_scan`` runs device steps
only; ``run`` adds the host life cycle at its cadences (ridging/rafting,
fracture, welding, smoothing, fusing), the callback, the output writers
(``io.writers``) and the logger.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from .constants import Constants
from .core.domain import Domain
from .core.model import Model
from .geometry import two_cross as _two_cross
from .physics import collisions as _collisions
from .physics import coupling as _coupling
from .physics import lifecycle_host as _lifecycle
from .physics import simplification as _simplification
from .physics import update_floe as _update_floe
from .step_graph import StepGraph
from .settings import (
    CollisionSettings,
    CouplingSettings,
    FloeSettings,
    FractureSettings,
    RidgeRaftSettings,
    SimplificationSettings,
    WeldSettings,
)


# Dense-vs-binned crossover for bins="auto" (active floe count).  The value
# is the reference package's, kept so that a given Simulation takes the same
# broad-phase path in both packages; where the crossover lies on an H100 is
# what ``chip_smoke.py``'s ``binned`` phase measures.
AUTO_BINS_MIN_N = 6000


@dataclasses.dataclass
class Simulation:
    model: Model
    consts: Constants = Constants()
    dt: int = 10
    n_dt: int = 7500
    verbose: bool = False
    name: str = "sim"
    seed: int = 0
    floe_settings: FloeSettings = FloeSettings()
    coupling_settings: CouplingSettings = CouplingSettings()
    collision_settings: CollisionSettings = CollisionSettings()
    fracture_settings: FractureSettings = FractureSettings()
    simp_settings: SimplificationSettings = SimplificationSettings()
    ridgeraft_settings: RidgeRaftSettings = RidgeRaftSettings()
    weld_settings: WeldSettings = WeldSettings()
    # io.writers.OutputWriters (or None): run calls its write_data at each
    # writer interval and close at the end
    writers: Any = None
    # saved numpy Generator state (bit_generator.state dict) applied at the
    # start of run(), so a resumed run continues the exact RNG stream
    rng_state: Optional[dict] = None
    # run the host ridge/raft pass at the reference's mid-step position
    # (between collisions and coupling, simulation.jl:121-135); False keeps
    # ridge/raft with the other host passes at end of step
    interleave_ridge_raft: bool = True
    # capacities (static shapes)
    pair_cap: Optional[int] = None
    cell_cap: Optional[int] = None
    clip_cap: int = 16
    # (nbx, nby, M) spatial broad-phase binning.  "auto" (the default)
    # enables binning when the active floe count reaches AUTO_BINS_MIN_N
    # (parameters from _auto_bins); None forces the dense broad phase; an
    # explicit tuple forces those bin parameters.
    bins: Any = "auto"
    # steps of the last run / run_scan whose capacities overflowed (output)
    n_overflow: int = dataclasses.field(default=0, init=False)
    # what the last run() did (output): steps, segments, and the seconds,
    # count and kernel launches of each host pass
    run_stats: dict = dataclasses.field(default_factory=dict, init=False)
    # the step's CUDA graphs (``step_graph``): made by the first run_scan or
    # run and kept, so that later runs replay its captures
    _graph: Optional[StepGraph] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        N = self.model.floes.capacity
        if self.pair_cap is None:
            self.pair_cap = max(8 * N, 256)
        if self.cell_cap is None:
            # enough line-centered cells to cover the largest floe
            rmax = float(torch.max(self.model.floes.rmax))
            g = self.model.grid
            cap = int(2 * np.ceil(1.5 * rmax / min(g.dx, g.dy)) + 3)
            self.cell_cap = min(cap, max(g.Nx, g.Ny) + 1)
        if isinstance(self.bins, str) and self.bins == "auto":
            n_act = int(torch.sum(self.model.floes.active))
            self.bins = (
                _auto_bins(self.model) if n_act >= AUTO_BINS_MIN_N else None
            )

    def step_graph(self) -> StepGraph:
        """The step's graphs, holding the model's state: the kept
        StepGraph, or a new one where none was made yet or a setting the
        step reads changed since (``StepGraph.made_for``).  A state of
        another shape is captured again at its next replay
        (``StepGraph.load``)."""
        g = self._graph
        if g is None or not g.made_for(self):
            self._graph = StepGraph(self)
        else:
            m = self.model
            g.load(m.floes, m.ocean, m.domain)
        return self._graph


def _auto_bins(model: Model) -> Optional[tuple]:
    """Choose static (nbx, nby, M) bin parameters from the initial field:
    bin size >= 2.2 * max rmax (so the bin neighbourhoods capture all pairs,
    with growth headroom), per-bin capacity 2x the initial max occupancy."""
    floes = model.floes
    act = floes.active.cpu().numpy()
    if act.sum() == 0:
        return None
    rmax = float(np.max(floes.rmax.cpu().numpy()[act]))
    vals = model.domain.vals.cpu().numpy().astype(float)
    Lx = vals[2] - vals[3]
    Ly = vals[0] - vals[1]
    b = 2.2 * rmax
    nbx = max(int(Lx / b), 1)
    nby = max(int(Ly / b), 1)
    if nbx * nby < 16:
        return None  # too few bins to be worth it
    cx = floes.centroid.cpu().numpy()[act]
    ibx = np.clip(((cx[:, 0] - vals[3]) / (Lx / nbx)).astype(int), 0, nbx - 1)
    iby = np.clip(((cx[:, 1] - vals[1]) / (Ly / nby)).astype(int), 0, nby - 1)
    occ = np.bincount(ibx * nby + iby, minlength=nbx * nby)
    M = int(2 * occ.max() + 8)
    return (nbx, nby, M)


def couples(cps: CouplingSettings, tstep: int) -> bool:
    """Whether the step at ``tstep`` runs the coupling: its cadence is a
    branch on the host, on the Python ``tstep`` (simulation.jl:151-161)."""
    return bool(cps.coupling_on and tstep % cps.dt == 0)


def build_step_bodies(sim: Simulation) -> tuple[Callable, Callable]:
    """The step's two halves as the device runs them; nothing in them reads
    the device, so ``step_graph.StepGraph`` captures them as they are:

      collide(floes, ocean, domain)
          -> (floes, domain, stress_instant, overflow)
      finish(floes, ocean, domain, stress_instant, couple)
          -> (floes, ocean, domain, overflow)

    ``couple``: whether this step runs the coupling (``couples``).  They
    hold what they read of ``sim``, not ``sim`` itself, so a Simulation and
    the graphs it keeps are freed without the cycle collector."""
    grid = sim.model.grid
    atmos = sim.model.atmos
    consts = sim.consts
    dt = float(sim.dt)
    fs = sim.floe_settings
    cps = sim.coupling_settings
    cls = sim.collision_settings
    pair_cap, clip_cap, cell_cap, bins = sim.pair_cap, sim.clip_cap, sim.cell_cap, sim.bins
    # the coupling and accumulation sums are float32 one-hot products on
    # the card; TF32 would keep only about three digits of them
    torch.backends.cuda.matmul.allow_tf32 = False

    def collide(floes, ocean, domain: Domain):
        stress_instant = torch.zeros_like(floes.stress_accum)
        overflow = torch.zeros((), dtype=torch.bool, device=floes.verts.device)
        # --- collisions (simulation.jl:108-117) ---------------------------
        if cls.collisions_on:
            res = _collisions.timestep_collisions(
                floes, domain, consts, dt, cls, pair_cap, clip_cap, bins,
            )
            floes = res.floes
            stress_instant = res.stress_instant
            overflow = overflow | res.overflow
        # moving boundaries advance after collisions (collisions.jl:797)
        domain = domain.update_boundaries(dt)
        return floes, domain, stress_instant, overflow

    def finish(floes, ocean, domain: Domain, stress_instant, couple: bool):
        overflow = torch.zeros((), dtype=torch.bool, device=floes.verts.device)
        # --- coupling (simulation.jl:151-161) -----------------------------
        if couple:
            floes, ocean, cp_overflow = _coupling.timestep_coupling(
                floes, grid, domain, ocean, atmos, consts, cps, fs, dt,
                cell_cap,
            )
            overflow = overflow | cp_overflow
        # --- integrate (simulation.jl:165-170) ----------------------------
        floes = _update_floe.timestep_floe_properties(floes, dt, fs, stress_instant)
        floes = _update_floe.wrap_periodic(floes, domain)
        # --- removal / dissolution (simulation.jl:205-214) ----------------
        floes, ocean = _simplification.remove_and_dissolve(
            floes, ocean, grid, domain, fs
        )
        return floes, ocean, domain, overflow

    return collide, finish


def build_step_parts(sim: Simulation) -> tuple[Callable, Callable]:
    """The step as two halves (the reference splits it so a host pass can
    run between them), eagerly:

      collide(floes, ocean, domain, tstep)
          -> (floes, domain, stress_instant, overflow)
      finish(floes, ocean, domain, stress_instant, tstep)
          -> (floes, ocean, domain, overflow)
    """
    collide_body, finish_body = build_step_bodies(sim)

    def collide(floes, ocean, domain: Domain, tstep: int):
        return collide_body(floes, ocean, domain)

    def finish(floes, ocean, domain: Domain, stress_instant, tstep: int):
        return finish_body(floes, ocean, domain, stress_instant,
                           couples(sim.coupling_settings, tstep))

    return collide, finish


def build_step(sim: Simulation) -> Callable:
    """One simulation step: (floes, ocean, domain, tstep) -> (floes, ocean,
    domain, overflow)."""
    collide, finish = build_step_parts(sim)

    def step(floes, ocean, domain: Domain, tstep: int):
        floes, domain, stress_instant, ov1 = collide(floes, ocean, domain, tstep)
        floes, ocean, domain, ov2 = finish(floes, ocean, domain, stress_instant, tstep)
        return floes, ocean, domain, ov1 | ov2

    return step


def _stack_steps(outs: list):
    """Stack per-step ``collect`` outputs (tensors, tuples, NamedTuples or
    dicts of them) along a new leading step axis."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {k: _stack_steps([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple):
        parts = [_stack_steps([o[i] for o in outs]) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    raise TypeError(f"cannot stack collected values of type {type(first)}")


def run_scan(sim: Simulation, n_steps: int, start_tstep: int = 0,
             collect: Callable | None = None, _eager: bool = False):
    """Run n_steps steps from the model's state.

    On the card the steps replay the step captured as a CUDA graph
    (``Simulation.step_graph``): nothing is read on the host between the
    first step and the last, as under the reference's one jitted
    ``lax.scan``.  The Simulation keeps its graphs, so a later run replays
    them without capturing again.  On the CPU the same loop calls the step
    directly.  ``_eager``: the step without a graph, one launch at a time
    (the reference the graph is held to on the card).

    ``collect(floes, ocean)`` maps each post-step state to small outputs
    that are stacked over steps; it runs after each step, on the card
    eagerly on the replay's output.  Returns (sim, collected) with the
    model advanced.  Steps whose pair/crossing/window capacity overflowed
    are counted on the device and read once at the end, reported as one
    warning like the reference; the count is ``sim.n_overflow``, and
    ``sim.run_stats["graph"]`` holds the graph's counters for this run."""
    floes, ocean, domain = sim.model.floes, sim.model.ocean, sim.model.domain
    outs = []
    if _eager:
        step = build_step(sim)
        n_over = torch.zeros((), dtype=torch.int64, device=floes.verts.device)
        for tstep in range(start_tstep, start_tstep + n_steps):
            floes, ocean, domain, overflow = step(floes, ocean, domain, tstep)
            n_over = n_over + overflow.long()
            if collect is not None:
                outs.append(collect(floes, ocean))
        stats = None
    else:
        graph = sim.step_graph()
        stats0 = dict(graph.stats)
        tsteps = range(start_tstep, start_tstep + n_steps)
        graph.prepare({graph.step_prog(t) for t in tsteps})
        graph.n_over.zero_()
        for tstep in tsteps:
            graph.step(tstep)
            if collect is not None:
                outs.append(graph.own(collect(graph.floes, graph.ocean)))
        n_over = graph.n_over
        floes, ocean, domain = graph.state()
        stats = graph.stats_since(stats0)
    sim.n_overflow = int(n_over)
    if sim.n_overflow:
        warnings.warn(
            f"{sim.n_overflow} steps exceeded pair/crossing capacity; "
            "results may be inaccurate. Increase pair_cap/clip_cap."
        )
    sim.model = sim.model.replace(floes=floes, ocean=ocean, domain=domain)
    sim.run_stats = {"steps": n_steps, "graph": stats}
    collected = _stack_steps(outs) if outs else None
    return sim, collected


HOST_PASSES = ("ridge_raft", "fracture", "weld", "smooth", "fuse")


class _HostPass:
    """Times one host pass into ``state["seconds"][name]`` and counts the
    narrow-phase kernel launches it made into ``state["launches"][name]``.
    A pass starts by pulling the pool, so the time the device still needed
    for the steps queued before it is counted to the pass."""

    def __init__(self, state, name):
        self.state, self.name = state, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.l0 = _two_cross.launch_count()

    def __exit__(self, *exc):
        st = self.state
        st["seconds"][self.name] += time.perf_counter() - self.t0
        st["launches"][self.name] += _two_cross.launch_count() - self.l0
        st["passes"][self.name] += 1
        return False


def _new_run_state(max_floe_id: int) -> dict:
    return {
        "max_floe_id": max_floe_id,
        "n_overflow": 0,
        "seconds": dict.fromkeys(HOST_PASSES, 0.0),
        "launches": dict.fromkeys(HOST_PASSES, 0),
        "passes": dict.fromkeys(HOST_PASSES, 0),
    }


def _warn_overflow_host(overflow, which, tstep, state, logger=None):
    if bool(overflow):
        state["n_overflow"] += 1
        msg = (
            f"pair/crossing capacity exceeded in {which} overlap query; "
            "the overlap list may be incomplete"
        )
        if logger is not None:
            logger.warn(msg, tstep)
        else:
            warnings.warn(msg)


def _host_rows(mask, *cols):
    """The entries of device columns where ``mask`` holds, as a list of
    tuples on the host."""
    m = mask.cpu().numpy()
    return list(zip(*(c.cpu().numpy()[m].tolist() for c in cols)))


def _host_ridge_raft(sim, floes, domain, tstep, rng, state, logger=None):
    """The host ridge/raft pass (simulation.jl:121-135); called either
    mid-step (interleave_ridge_raft) or from _host_lifecycle_passes."""
    rr = sim.ridgeraft_settings
    with _HostPass(state, "ridge_raft"):
        i, j, area, valid, overflow = _collisions.pair_overlaps(
            floes, domain, sim.pair_cap, sim.clip_cap, sim.bins
        )
        _warn_overflow_host(overflow, "ridge/raft", tstep, state, logger)
        overlaps = _host_rows(valid, i, j, area)
        if overlaps:
            floes, state["max_floe_id"] = _lifecycle.timestep_ridging_rafting(
                floes, domain, overlaps, state["max_floe_id"],
                rr, sim.floe_settings, sim.simp_settings, float(sim.dt), rng,
            )
    return floes


def _host_lifecycle_passes(
    sim, floes, domain, tstep, rng, state, logger=None,
    skip_ridge_raft=False,
):
    """Host-orchestrated topology changes at their process cadences
    (timestep_sim! order, simulation.jl:94-220). Returns updated floes."""
    fs = sim.floe_settings
    dt = float(sim.dt)

    # ridging / rafting (simulation.jl:121-135)
    rr = sim.ridgeraft_settings
    if (
        not skip_ridge_raft
        and rr.ridge_raft_on and rr.dt > 0 and tstep % rr.dt == 0 and tstep > 0
    ):
        floes = _host_ridge_raft(sim, floes, domain, tstep, rng, state, logger)

    # fracture (simulation.jl:172-182)
    fr = sim.fracture_settings
    if fr.fractures_on and fr.dt > 0 and tstep % fr.dt == 0 and tstep > 0:
        with _HostPass(state, "fracture"):
            overlaps = None
            if fr.deform_on:
                # materialized interaction rows so each fracturing floe's
                # deformer displacement follows the recorded contact-force
                # vector (fractures.jl:482-507 reads
                # interactions[max_overlap_idx, xforce:yforce])
                rows = _collisions.pair_interactions(
                    floes, domain, sim.consts, dt, sim.pair_cap,
                    sim.clip_cap, sim.bins,
                )
                _warn_overflow_host(
                    rows["overflow"], "fracture deform", tstep, state, logger
                )
                overlaps = _host_rows(
                    rows["valid"], rows["i"], rows["j"], rows["overlap"],
                    rows["fx"], rows["fy"],
                )
            floes, state["max_floe_id"] = _lifecycle.fracture_floes(
                floes, state["max_floe_id"], rng, fr, fs, dt, overlaps
            )

    # welding (simulation.jl:185-202)
    ws = sim.weld_settings
    if ws.weld_on:
        for k, wdt in enumerate(ws.dts):
            if tstep > 0 and tstep % wdt == 0:
                with _HostPass(state, "weld"):
                    floes, state["max_floe_id"] = _lifecycle.timestep_welding(
                        floes, state["max_floe_id"], sim.model.grid, domain,
                        ws, fs, k, dt, rng,
                    )
                break

    # smoothing (simplification.jl:56-121)
    sp = sim.simp_settings
    if (
        sp.smooth_vertices_on
        and sp.dt_smooth > 0
        and tstep > 0
        and tstep % sp.dt_smooth == 0
    ):
        with _HostPass(state, "smooth"):
            floes = _lifecycle.smooth_floes(floes, sp, fs, dt, rng)

    # fusing of >max-overlap pairs flagged by collisions
    if bool(torch.any(floes.fuse_with >= 0)):
        with _HostPass(state, "fuse"):
            floes, state["max_floe_id"] = _lifecycle.fuse_floes(
                floes, state["max_floe_id"], fs, dt, rng
            )
    return floes


def run(sim: Simulation, start_tstep: int = 0, callback=None, collect=None,
        _eager: bool = False):
    """run! (simulation.jl:287-297): step the simulation n_dt times, with
    the host life cycle at its cadences.

    ``callback(tstep, floes, ocean, domain)`` is invoked before each step
    (write_data!'s position in timestep_sim!, simulation.jl:105); with a
    callback every step is a host event.

    ``collect(floes, ocean)`` maps the post-step state to small per-step
    outputs that stay on the device and are returned stacked over steps,
    like ``run_scan``'s.  When given, ``run`` returns ``(sim, collected)``.

    Between host events (writer intervals, life-cycle cadences) the steps
    form a *segment*: nothing but device steps.  A step that marks a fuse
    pair ends its segment, and ``fuse_floes`` runs before the next step
    (collisions.jl:364-368 -> simulation.jl:205-214).  The fuse flag and the
    step's overflow flag come to the host in one read per step.

    On the card every step replays the step captured as a CUDA graph
    (``Simulation.step_graph``, as ``run_scan`` does; the step that runs
    ridge/raft between its halves replays each half).  The host passes,
    the callback and the writers run eagerly between replays: the callback
    and the writers get a copy of the state, and what a pass returns is
    copied back into the graph's buffers.  On the CPU the same loop calls
    the step directly; ``_eager`` does so on the card too (the reference
    the graph is held to).  ``sim.run_stats`` reports steps, segments, and
    seconds and kernel launches by host pass, and the graph's counters for
    this run."""
    from .io.logger import SimulationLogger

    logger = SimulationLogger(sim.name)
    rr = sim.ridgeraft_settings
    rr_mid_step = (
        sim.interleave_ridge_raft and rr.ridge_raft_on and rr.dt > 0
    )
    graph = StepGraph(sim, _eager=True) if _eager else sim.step_graph()
    stats0 = dict(graph.stats)
    tstep = start_tstep
    n_overflow = 0
    collected = []
    rng = np.random.default_rng(sim.seed)
    if sim.rng_state is not None:
        rng.bit_generator.state = sim.rng_state
    state = _new_run_state(int(torch.max(sim.model.floes.id)))
    has_host_ops = (
        sim.ridgeraft_settings.ridge_raft_on
        or sim.fracture_settings.fractures_on
        or sim.weld_settings.weld_on
        or sim.simp_settings.smooth_vertices_on
        or sim.collision_settings.collisions_on  # fusing flags
    )

    use_segments = callback is None
    pre_cads = []   # host needed BEFORE the step at multiples of these
    post_cads = []  # host needed AFTER the step at multiples of these
    if use_segments:
        if sim.writers is not None:
            for w in (sim.writers.floes, sim.writers.grid,
                      sim.writers.checkpoint):
                if w is not None:
                    pre_cads.append(w.interval)
        if sim.verbose:
            pre_cads.append(50)
        if rr_mid_step:
            pre_cads.append(rr.dt)
        elif rr.ridge_raft_on and rr.dt > 0:
            post_cads.append(rr.dt)
        fr = sim.fracture_settings
        if fr.fractures_on and fr.dt > 0:
            post_cads.append(fr.dt)
        if sim.weld_settings.weld_on:
            post_cads.extend(sim.weld_settings.dts)
        if (
            sim.simp_settings.smooth_vertices_on
            and sim.simp_settings.dt_smooth > 0
        ):
            post_cads.append(sim.simp_settings.dt_smooth)

    def is_event(t):
        # writers and the progress line fire at t == 0 too; life-cycle
        # cadences need t > 0
        return (
            not use_segments
            or any(t % c == 0 for c in pre_cads)
            or (t > 0 and any(t % c == 0 for c in post_cads))
        )

    n_segments = 0
    seg_len = 0   # steps in the open segment (0: no segment is open)
    seg_nov = 0   # of which overflowed

    def close_segment():
        nonlocal seg_len, seg_nov, n_overflow
        if seg_nov:
            n_overflow += seg_nov
            logger.warn(
                f"pair/crossing capacity exceeded on {seg_nov} of the "
                f"last {seg_len} steps; contact forces may be incomplete",
                tstep - 1,
            )
        seg_len = seg_nov = 0

    t_start = time.perf_counter()
    end_tstep = start_tstep + sim.n_dt
    graph.prepare({graph.step_prog(t) for t in range(start_tstep, end_tstep + 1)})
    while tstep <= end_tstep:
        if not is_event(tstep):
            if seg_len == 0:
                n_segments += 1
            graph.step(tstep)
            if collect is not None:
                collected.append(graph.own(collect(graph.floes, graph.ocean)))
            # the step's one read by the loop: fuse flag and overflow flag
            fuse, over = graph.flags.tolist()
            seg_len += 1
            seg_nov += int(over)
            tstep += 1
            if fuse:
                close_segment()
                if has_host_ops:
                    with _HostPass(state, "fuse"):
                        floes, state["max_floe_id"] = _lifecycle.fuse_floes(
                            graph.floes, state["max_floe_id"],
                            sim.floe_settings, float(sim.dt), rng,
                        )
                    graph.load(floes)
            continue
        close_segment()
        if sim.verbose and tstep % 50 == 0:
            print(f"{tstep} timesteps")
        if callback is not None or sim.writers is not None:
            floes, ocean, domain = graph.state()
        if callback is not None:
            callback(tstep, floes, ocean, domain)
        if sim.writers is not None:
            sim.model = sim.model.replace(floes=floes, ocean=ocean, domain=domain)
            sim.writers.write_data(
                sim, tstep, floes, ocean, domain,
                rng_state=rng.bit_generator.state,
            )
        rr_now = rr_mid_step and tstep % rr.dt == 0 and tstep > 0
        if rr_now:
            # mid-step placement: collisions -> ridge/raft ->
            # coupling/integration (simulation.jl:108-135); pieces created
            # mid-step carry zero instantaneous stress this step
            graph.replay(("collide",))
            graph.load(_host_ridge_raft(
                sim, graph.floes, graph.domain, tstep, rng, state, logger
            ))
            graph.replay(("finish", couples(sim.coupling_settings, tstep)))
        else:
            graph.step(tstep)
        if collect is not None:
            collected.append(graph.own(collect(graph.floes, graph.ocean)))
        if bool(graph.flags[1]):
            n_overflow += 1
            logger.warn(
                "pair/crossing capacity exceeded; contact forces may be "
                "incomplete this step",
                tstep,
            )
        if has_host_ops:
            graph.load(_host_lifecycle_passes(
                sim, graph.floes, graph.domain, tstep, rng, state, logger,
                skip_ridge_raft=rr_now,
            ))
        tstep += 1
    close_segment()
    floes, ocean, domain = graph.state()
    n_overflow += state["n_overflow"]
    sim.n_overflow = n_overflow
    if n_overflow:
        warnings.warn(
            f"{n_overflow} steps exceeded pair/crossing capacity; results "
            "may be inaccurate. Increase pair_cap/clip_cap."
        )
    if sim.writers is not None:
        sim.writers.close()
    logger.close()
    sim.model = sim.model.replace(floes=floes, ocean=ocean, domain=domain)
    n_steps = end_tstep - start_tstep + 1
    sim.run_stats = {
        "steps": n_steps,
        "segments": n_segments,
        "seconds": time.perf_counter() - t_start,
        "host_pass_seconds": state["seconds"],
        "host_pass_count": state["passes"],
        "host_pass_launches": state["launches"],
        "rng_state": rng.bit_generator.state,
        "max_floe_id": state["max_floe_id"],
        "graph": graph.stats_since(stats0),
    }
    if collect is not None:
        return sim, (_stack_steps(collected) if collected else None)
    return sim
