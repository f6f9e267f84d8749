"""The simulation loops (a frozen copy of the port's eager path).

One step is the reference's process order for the device state:
collisions -> moving walls -> coupling (at its cadence) -> integration ->
periodic wrap -> removal/dissolution.  ``tstep`` is a Python int, so the
coupling cadence is a branch on the host.  ``run_scan`` runs device steps
only; ``run`` adds the host life cycle at its cadences (ridging/rafting,
fracture, welding, smoothing, fusing).  Every step runs eagerly, in the
program's order of events; the program's CUDA graphs, run segments,
callback, writers and logger have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .constants import Constants
from .core.domain import Domain
from .core.model import Model
from .physics import collisions as _collisions
from .physics import coupling as _coupling
from .physics import lifecycle_host as _lifecycle
from .physics import simplification as _simplification
from .physics import update_floe as _update_floe
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

# float32 one-hot products in the coupling keep about three digits under
# TF32: the reference runs with it off, the control (benchmark.calibrate) on
ALLOW_TF32 = False

# None, or the dtype that every floating tensor of the state is rounded to
# where a step or a host pass stores it, as the program stores it in its
# step's buffers (the bfloat16 control, benchmark.calibrate); the
# arithmetic stays in the state's own dtype
STORE_DTYPE = None


@dataclasses.dataclass
class Simulation:
    model: Model
    consts: Constants = Constants()
    dt: int = 10
    n_dt: int = 7500
    # the program's progress line; the reference prints nothing
    verbose: bool = False
    seed: int = 0
    floe_settings: FloeSettings = FloeSettings()
    coupling_settings: CouplingSettings = CouplingSettings()
    collision_settings: CollisionSettings = CollisionSettings()
    fracture_settings: FractureSettings = FractureSettings()
    simp_settings: SimplificationSettings = SimplificationSettings()
    ridgeraft_settings: RidgeRaftSettings = RidgeRaftSettings()
    weld_settings: WeldSettings = WeldSettings()
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
    # what the last run() ends on (output): its generator state and
    # largest floe id
    run_stats: dict = dataclasses.field(default_factory=dict, init=False)

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
    """The step's two halves as the program's device step runs them:

      collide(floes, ocean, domain)
          -> (floes, domain, stress_instant, overflow)
      finish(floes, ocean, domain, stress_instant, couple)
          -> (floes, ocean, domain, overflow)

    ``couple``: whether this step runs the coupling (``couples``)."""
    grid = sim.model.grid
    atmos = sim.model.atmos
    consts = sim.consts
    dt = float(sim.dt)
    fs = sim.floe_settings
    cps = sim.coupling_settings
    cls = sim.collision_settings
    pair_cap, clip_cap, cell_cap, bins = sim.pair_cap, sim.clip_cap, sim.cell_cap, sim.bins
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32

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


def _stored(x):
    """``x`` (a tensor, a NamedTuple of them or a Domain) as the program's
    step buffers store it: each floating tensor rounded to ``STORE_DTYPE``
    and back, where that is set."""
    if STORE_DTYPE is None:
        return x
    if isinstance(x, torch.Tensor):
        return x.to(STORE_DTYPE).to(x.dtype) if x.is_floating_point() else x
    if isinstance(x, Domain):
        return dataclasses.replace(x, vals=_stored(x.vals), velocities=_stored(x.velocities),
                                   topography=_stored(x.topography))
    return type(x)(*(_stored(t) for t in x))


def _whole_step(sim, collide, finish, floes, ocean, domain, tstep):
    floes, domain, stress_instant, _ = collide(floes, ocean, domain)
    floes, ocean, domain, _ = finish(floes, ocean, domain, stress_instant,
                                     couples(sim.coupling_settings, tstep))
    return _stored(floes), _stored(ocean), _stored(domain)


def run_scan(sim: Simulation, n_steps: int, start_tstep: int = 0):
    """Run n_steps device steps from the model's state; the model is
    advanced in place of ``sim.model``."""
    collide, finish = build_step_bodies(sim)
    m = sim.model
    floes, ocean, domain = m.floes, m.ocean, m.domain
    for tstep in range(start_tstep, start_tstep + n_steps):
        floes, ocean, domain = _whole_step(sim, collide, finish, floes, ocean, domain, tstep)
    sim.model = m.replace(floes=floes, ocean=ocean, domain=domain)
    return sim


def _host_rows(mask, *cols):
    """The entries of device columns where ``mask`` holds, as a list of
    tuples on the host."""
    m = mask.cpu().numpy()
    return list(zip(*(c.cpu().numpy()[m].tolist() for c in cols)))


def _host_ridge_raft(sim, floes, domain, tstep, rng, state):
    """The host ridge/raft pass (simulation.jl:121-135); called either
    mid-step (interleave_ridge_raft) or from _host_lifecycle_passes."""
    rr = sim.ridgeraft_settings
    i, j, area, valid, _ = _collisions.pair_overlaps(
        floes, domain, sim.pair_cap, sim.clip_cap, sim.bins
    )
    overlaps = _host_rows(valid, i, j, area)
    if overlaps:
        floes, state["max_floe_id"] = _lifecycle.timestep_ridging_rafting(
            floes, domain, overlaps, state["max_floe_id"],
            rr, sim.floe_settings, sim.simp_settings, float(sim.dt), rng,
        )
    return floes


def _host_lifecycle_passes(sim, floes, domain, tstep, rng, state, skip_ridge_raft=False):
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
        floes = _host_ridge_raft(sim, floes, domain, tstep, rng, state)

    # fracture (simulation.jl:172-182)
    fr = sim.fracture_settings
    if fr.fractures_on and fr.dt > 0 and tstep % fr.dt == 0 and tstep > 0:
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
        floes = _lifecycle.smooth_floes(floes, sp, fs, dt, rng)

    # fusing of >max-overlap pairs flagged by collisions
    if bool(torch.any(floes.fuse_with >= 0)):
        floes, state["max_floe_id"] = _lifecycle.fuse_floes(
            floes, state["max_floe_id"], fs, dt, rng
        )
    return floes


def run(sim: Simulation, start_tstep: int = 0):
    """run! (simulation.jl:287-297): step the simulation n_dt + 1 times from
    ``start_tstep``, with the host life cycle at its cadences, in the
    program's order of events: after each step the passes whose cadence
    the step meets, then fusing where the step marked a pair (the program
    reads its step's fuse flag for that); at a ridge/raft step with
    ``interleave_ridge_raft`` the pass runs between the step's collisions
    and its coupling (simulation.jl:108-135).  ``sim.run_stats`` holds the
    generator state and the largest floe id at the end."""
    rr = sim.ridgeraft_settings
    rr_mid_step = sim.interleave_ridge_raft and rr.ridge_raft_on and rr.dt > 0
    has_host_ops = (
        rr.ridge_raft_on
        or sim.fracture_settings.fractures_on
        or sim.weld_settings.weld_on
        or sim.simp_settings.smooth_vertices_on
        or sim.collision_settings.collisions_on  # fusing flags
    )
    collide, finish = build_step_bodies(sim)
    rng = np.random.default_rng(sim.seed)
    if sim.rng_state is not None:
        rng.bit_generator.state = sim.rng_state
    m = sim.model
    floes, ocean, domain = m.floes, m.ocean, m.domain
    state = {"max_floe_id": int(torch.max(floes.id))}
    for tstep in range(start_tstep, start_tstep + sim.n_dt + 1):
        rr_now = rr_mid_step and tstep % rr.dt == 0 and tstep > 0
        if rr_now:
            floes, domain, stress_instant, _ = collide(floes, ocean, domain)
            floes, domain = _stored(floes), _stored(domain)
            floes = _stored(_host_ridge_raft(sim, floes, domain, tstep, rng, state))
            floes, ocean, domain, _ = finish(floes, ocean, domain, _stored(stress_instant),
                                             couples(sim.coupling_settings, tstep))
            floes, ocean, domain = _stored(floes), _stored(ocean), _stored(domain)
        else:
            floes, ocean, domain = _whole_step(sim, collide, finish, floes, ocean, domain, tstep)
        if has_host_ops:
            floes = _stored(_host_lifecycle_passes(sim, floes, domain, tstep, rng, state,
                                                   skip_ridge_raft=rr_now))
    sim.model = m.replace(floes=floes, ocean=ocean, domain=domain)
    sim.run_stats = {"rng_state": rng.bit_generator.state,
                     "max_floe_id": state["max_floe_id"]}
    return sim
