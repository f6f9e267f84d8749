"""Rank process of the port's decomposition tests (tests/test_torch_decomp_ranks.py).

    python tests/torch_decomp_worker.py <rank> <world> <port> <out_dir> <scenario,...>

Joins a gloo process group on localhost, runs each named scenario through
``subzero_tpu_torch.parallel`` on CPU tensors (f64), and writes what the
parent compares with the JAX package into ``<out_dir>/<scenario>.npz`` (rank
0) and ``<out_dir>/<scenario>.rank<r>.json`` (every rank).  Imports no JAX:
the configurations are the port's own constructors fed the numpy seeds of
tests/test_parallel.py, which give the JAX package's pools bit for bit.
"""

import json
import os
import sys

import numpy as np
import torch

N_STEPS = 5          # decomposed steps held row for row against the JAX package
MIGRATION_STEPS = 60
FRACTURE_N_DT = 12
RR_N_DT = 7
WRITE_EVERY = 6


def _grid_sim(x1, y1, nx, ny, n_floes, conc, seed, dtype=torch.float64, device="cpu",
              u=0.2, v=0.0, **kw):
    from subzero_tpu_torch.constants import Constants
    from subzero_tpu_torch.core import (BoundaryKind, initialize_floe_field, make_atmos,
                                        make_domain, make_grid, make_model, make_ocean)
    from subzero_tpu_torch.settings import (CouplingSettings, FloeSettings,
                                            SubGridPointsGenerator)
    from subzero_tpu_torch.simulation import Simulation

    grid = make_grid(0.0, x1, 0.0, y1, Nx=nx, Ny=ny)
    ocean = make_ocean(grid, u=u, v=v, temp=0.0, dtype=dtype, device=device)
    atmos = make_atmos(grid, temp=-1.0, dtype=dtype, device=device)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), dtype=dtype, device=device)
    fs = FloeSettings(min_floe_area=1e6,
                      subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2))
    floes = initialize_floe_field(n_floes, [conc], domain, 0.25, 0.0, fs,
                                  rng=np.random.default_rng(seed), dtype=dtype,
                                  device=device)
    return Simulation(
        model=make_model(grid, ocean, atmos, domain, floes),
        consts=Constants(E=1e6), dt=20, n_dt=0, floe_settings=fs,
        coupling_settings=kw.pop("coupling_settings",
                                 CouplingSettings(two_way_coupling_on=True)),
        **kw,
    )


def wide_sim(n_floes=128, **kw):
    """tests/test_parallel.py:make_wide_sim: an 8:1 periodic domain."""
    return _grid_sim(8e5, 1e5, 40, 5, n_floes, 0.45, 3, **kw)


def small_sim(n_floes=16, **kw):
    """tests/test_parallel.py:make_sim: 16 floes in a periodic 1e5 m box."""
    return _grid_sim(1e5, 1e5, 10, 10, n_floes, 0.6, 1, **kw)


def fracture_settings():
    from subzero_tpu_torch.settings import FractureSettings, HiblerYieldCurve

    return FractureSettings(fractures_on=True,
                            criteria=HiblerYieldCurve(pstar=1e-10, c=20.0),
                            dt=4, npieces=2)


def ridge_raft_settings():
    from subzero_tpu_torch.settings import RidgeRaftSettings

    return RidgeRaftSettings(ridge_raft_on=True, dt=3, ridge_probability=1.0,
                             raft_probability=1.0, min_overlap_frac=0.0)


def fuse_sim(device="cpu"):
    """test_parallel.py's test_run_decomp_fuses_marked_pair: two separate
    floes on slab 0 and a 90%-overlap pair on slab 1 of two."""
    from subzero_tpu_torch.constants import Constants
    from subzero_tpu_torch.core import (BoundaryKind, initialize_floe_field_coords,
                                        make_atmos, make_domain, make_grid, make_model,
                                        make_ocean)
    from subzero_tpu_torch.settings import (CollisionSettings, CouplingSettings,
                                            FloeSettings, SubGridPointsGenerator)
    from subzero_tpu_torch.simulation import Simulation

    kw = dict(dtype=torch.float64, device=device)
    grid = make_grid(0.0, 8e5, 0.0, 1e5, Nx=40, Ny=5)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = FloeSettings(min_floe_area=1e6,
                      subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2))

    def sq(x0, y0, s=2e4):
        return [[x0, y0], [x0 + s, y0], [x0 + s, y0 + s], [x0, y0 + s]]

    coords = [sq(0.5e5, 3e4), sq(2.5e5, 3e4), sq(6.0e5, 4e4), sq(6.02e5, 4e4)]
    floes = initialize_floe_field_coords(coords, domain, 0.25, 0.0, fs,
                                         rng=np.random.default_rng(0), **kw)
    return Simulation(
        model=make_model(grid, make_ocean(grid, u=0.0, v=0.0, temp=0.0, **kw),
                         make_atmos(grid, temp=-1.0, **kw), domain, floes),
        consts=Constants(E=1e6), dt=20, n_dt=1, floe_settings=fs,
        coupling_settings=CouplingSettings(coupling_on=False),
        collision_settings=CollisionSettings(),
    )


def conservation(floes, ocean):
    """Per-step sums additive over floes (run_decomp's ``collect``)."""
    m = torch.where(floes.active, floes.mass, 0.0)
    return {"ke": torch.sum(0.5 * m * (floes.u ** 2 + floes.v ** 2)),
            "px": torch.sum(m * floes.u), "mass": torch.sum(m)}


class RecordingWriters:
    """The duck type run_decomp asks of ``sim.writers``; records each call's
    step and generator state."""

    def __init__(self):
        import types

        self.initial_state = object()
        self.floes = types.SimpleNamespace(interval=WRITE_EVERY)
        self.grid = None
        self.checkpoint = None
        self.calls = []
        self.closed = 0

    def write_data(self, sim, tstep, floes, ocean, domain, rng_state=None):
        self.calls.append([int(tstep), str(rng_state["state"]["state"]),
                           int(floes.capacity)])

    def close(self):
        self.closed += 1


def _arrays(prefix, tree):
    return {f"{prefix}.{k}": v.detach().cpu().numpy() for k, v in tree._asdict().items()}


def _steps(sim, dec, n, distribute):
    from subzero_tpu_torch.parallel import build_decomp_step, gather

    m = sim.model
    fd = distribute(m.floes, m.domain, dec)
    step = build_decomp_step(sim, dec)
    od, dd = m.ocean, m.domain
    overflow = []
    for k in range(n):
        fd, od, dd, ov = step(fd, od, dd, k)
        overflow.append(ov)
    return {**_arrays("floes", gather(fd, dec)), **_arrays("ocean", od),
            "overflow": np.array(overflow),
            "layout": np.array([dec.local_cap, dec.halo_cap, dec.mig_cap])}


def scenario_step1d(ctx):
    from subzero_tpu_torch.parallel import distribute, make_decomp

    sim = wide_sim()
    sim.pair_cap = 32 * sim.model.floes.capacity
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=4)
    return _steps(sim, dec, N_STEPS, distribute)


def scenario_step2d(ctx):
    from subzero_tpu_torch.parallel import distribute_2d, make_decomp_2d

    sim = small_sim()
    sim.pair_cap = 32 * sim.model.floes.capacity
    dec = make_decomp_2d(sim.model.floes, sim.model.domain, n_dev=(2, 2))
    return _steps(sim, dec, N_STEPS, distribute_2d)


def migration_sim():
    from subzero_tpu_torch.settings import CollisionSettings, CouplingSettings

    sim = wide_sim(coupling_settings=CouplingSettings(coupling_on=False),
                   collision_settings=CollisionSettings(collisions_on=False))
    fl = sim.model.floes
    # strong eastward drift: floes cross slab edges and the periodic east edge
    floes = fl._replace(u=torch.where(fl.active, 500.0, 0.0),
                        p_dudt=torch.zeros_like(fl.p_dudt))
    sim.model = sim.model.replace(floes=floes)
    return sim


def scenario_migration(ctx):
    from subzero_tpu_torch.parallel import distribute, make_decomp

    sim = migration_sim()
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=4)
    return _steps(sim, dec, MIGRATION_STEPS, distribute)


def scenario_identity(ctx):
    """The drift of ``migration`` with ``decomp.COMM_IDENTITY`` on, 3 steps
    (a floe that left the slab is a migrant again every step, so more steps
    would outgrow mig_cap): every exchange hands a rank its own buffers back,
    so no message is sent and a floe that leaves the slab stays with its
    rank."""
    from subzero_tpu_torch.parallel import build_decomp_step, decomp, distribute, make_decomp

    sim = migration_sim()
    m = sim.model
    dec = make_decomp(m.floes, m.domain, n_devices=4)
    fd = distribute(m.floes, m.domain, dec)
    step = build_decomp_step(sim, dec)
    ids0 = sorted(fd.id[fd.active].tolist())
    od, dd = m.ocean, m.domain
    overflow = []
    decomp.COMM_IDENTITY = True
    try:
        for k in range(3):
            fd, od, dd, ov = step(fd, od, dd, k)
            overflow.append(ov)
    finally:
        decomp.COMM_IDENTITY = False
    slab = 8e5 / 4
    cx = fd.centroid[fd.active, 0]
    lo = ctx["rank"] * slab
    ctx["rank_json"] = {"ids0": ids0, "ids1": sorted(fd.id[fd.active].tolist()),
                        "messages": dec.comm.stats["messages"], "overflow": overflow,
                        "outside": int(((cx < lo) | (cx >= lo + slab)).sum())}
    return None


def scenario_scaling(ctx):
    """measure_decomp_scaling over the 4 ranks, 3 steps: the 1-slab case on
    rank 0 through a one-rank subgroup, then all four."""
    from subzero_tpu_torch.parallel import measure_decomp_scaling
    from subzero_tpu_torch.settings import CouplingSettings

    def make():
        sim = wide_sim(coupling_settings=CouplingSettings(two_way_coupling_on=False))
        sim.pair_cap = 32 * sim.model.floes.capacity
        return sim

    res = measure_decomp_scaling(make, n_steps=3)
    ctx["rank_json"] = {str(k): v for k, v in res.items()}
    return None


def lifecycle_sim(kind):
    """``fracture``: fracture every 4 steps with the recording writers and
    ``collect``; ``rr``: ridge/raft every 3 steps, mid-step.  Two-way
    coupling off, 32 candidate rows a floe, tests/test_parallel.py's small
    periodic box."""
    from subzero_tpu_torch.settings import CouplingSettings

    over = ({"fracture_settings": fracture_settings()} if kind == "fracture"
            else {"ridgeraft_settings": ridge_raft_settings()})
    sim = small_sim(coupling_settings=CouplingSettings(two_way_coupling_on=False), **over)
    sim.pair_cap = 32 * sim.model.floes.capacity
    sim.n_dt = FRACTURE_N_DT if kind == "fracture" else RR_N_DT
    return sim


def _run(ctx, sim, dec, writers=None, collect=None):
    from subzero_tpu_torch.parallel import run_decomp

    sim.writers = writers
    out = run_decomp(sim, dec, collect=collect)
    sim, got = out if collect is not None else (out, None)
    arrays = {**_arrays("floes", sim.model.floes), **_arrays("ocean", sim.model.ocean),
              "n_overflow": np.array(sim.n_overflow)}
    if got is not None:
        arrays.update({f"collect.{k}": v.numpy() for k, v in got.items()})
    ctx["rank_json"] = {"writes": [] if writers is None else writers.calls,
                        "run_stats": {k: sim.run_stats[k] for k in
                                      ("steps", "segments", "host_pass_count", "comm",
                                       "local_cap")}}
    return arrays


def scenario_fracture(ctx):
    from subzero_tpu_torch.parallel import make_decomp

    sim = lifecycle_sim("fracture")
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=4)
    return _run(ctx, sim, dec, RecordingWriters(), conservation)


def scenario_rr(ctx):
    from subzero_tpu_torch.parallel import make_decomp

    sim = lifecycle_sim("rr")
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=4)
    return _run(ctx, sim, dec)


def scenario_fuse(ctx):
    """Two slabs, on ranks 0 and 1 of a subgroup; ranks 2 and 3 sit out."""
    import torch.distributed as dist
    from subzero_tpu_torch.parallel import make_decomp

    pair = dist.new_group([0, 1])
    if ctx["rank"] > 1:
        return None
    sim = fuse_sim()
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=2, group=pair)
    return _run(ctx, sim, dec)


def scenario_card_cpu(ctx):
    """The wide configuration over 2 slabs, 5 steps, with the ranks on the
    card (the gloo transport through host memory) and then on the CPU."""
    from subzero_tpu_torch.parallel import distribute, make_decomp, multihost

    out = {}
    for name, device in (("card", multihost.rank_device(None)), ("cpu", "cpu")):
        sim = wide_sim(device=device)
        sim.pair_cap = 32 * sim.model.floes.capacity
        dec = make_decomp(sim.model.floes, sim.model.domain)
        got = _steps(sim, dec, N_STEPS, distribute)
        out.update({f"{name}.{k}": v for k, v in got.items()})
        if name == "card":
            ctx["rank_json"] = {"staging_copies": dec.comm.stats["staging_copies"]}
    return out


SCENARIOS = {
    "step1d": scenario_step1d,
    "step2d": scenario_step2d,
    "migration": scenario_migration,
    "fracture": scenario_fracture,
    "rr": scenario_rr,
    "fuse": scenario_fuse,
    "card_cpu": scenario_card_cpu,
    "identity": scenario_identity,
    "scaling": scenario_scaling,
}


def main(argv):
    rank, world, port, out_dir, names = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                         argv[4].split(","))
    torch.set_num_threads(1)
    from subzero_tpu_torch.parallel import multihost

    multihost.initialize(backend="gloo", init_method=f"tcp://localhost:{port}",
                         world_size=world, rank=rank)
    for name in names:
        ctx = {"rank": rank}
        arrays = SCENARIOS[name](ctx)
        if arrays is not None and rank == 0:
            np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
        if "rank_json" in ctx:
            with open(os.path.join(out_dir, f"{name}.rank{rank}.json"), "w") as f:
                json.dump(ctx["rank_json"], f)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"[rank {rank}] done", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1:])
