"""What the host life cycle costs a decomposed run: the pool the host passes
work on and their time, at 1 rank and at D ranks (port of
``tools/lifecycle_overhead.py``).

At a life-cycle cadence every rank gathers the active rows of every rank
(``decomp.gather_active``) and runs the host passes on that pool, so the
rows a pass works on follow the active floes, not the number of ranks or
their padding.  This runs the JAX tool's fracture-on field as a 1-rank and a
D-rank decomposition and reports, per host pass, the gathered pool's rows,
and the passes' count and mean time (``sim.run_stats``).  One process a
rank, as ``torchrun`` starts them; every rank runs this file:

    torchrun --nproc_per_node D -m subzero_tpu_torch.tools.lifecycle_overhead
    torchrun --nproc_per_node D -m subzero_tpu_torch.tools.lifecycle_overhead \\
        --backend gloo [--device cpu] [--n-dt N]

The 1-rank run is rank 0's alone, through a one-rank group, while the others
wait.  Seconds are rank 0's, handed to every rank; the gathered rows and the
final active count are each rank's own.  Rank 0 prints a line a run, and
every rank prints its figures as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist


def build_sim(device=None, n_dt=12):
    """The JAX tool's field: f64, a periodic 8e5 x 1e5 m box on a 40 x 5
    grid, 512 floes at concentration 0.45 in a pool of 2 048 (seed 3), E 1e6,
    dt 10, ``n_dt`` steps (the tool's 12), fracture every 4 steps on a
    Hibler curve of pstar 1e-10 and c 20 into 2 pieces, 32 768 candidate
    pairs, two-way coupling off.  ``device=None``: the card."""
    from ..constants import Constants
    from ..core import (BoundaryKind, initialize_floe_field, make_atmos,
                        make_domain, make_grid, make_model, make_ocean)
    from ..settings import (CouplingSettings, FloeSettings, FractureSettings,
                            HiblerYieldCurve, SubGridPointsGenerator)
    from ..simulation import Simulation

    kw = dict(dtype=torch.float64, device=device)
    grid = make_grid(0.0, 8e5, 0.0, 1e5, Nx=40, Ny=5)
    ocean = make_ocean(grid, u=0.2, v=0.0, temp=0.0, **kw)
    atmos = make_atmos(grid, temp=-1.0, **kw)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = FloeSettings(
        min_floe_area=1e6,
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2),
    )
    floes = initialize_floe_field(
        512, [0.45], domain, 0.5, 0.1, fs, rng=np.random.default_rng(3),
        N=2048, **kw,
    )
    model = make_model(grid, ocean, atmos, domain, floes)
    return Simulation(
        model=model, consts=Constants(E=1e6), dt=10, n_dt=n_dt, seed=1,
        floe_settings=fs,
        coupling_settings=CouplingSettings(two_way_coupling_on=False),
        fracture_settings=FractureSettings(
            fractures_on=True, criteria=HiblerYieldCurve(pstar=1e-10, c=20.0),
            dt=4, npieces=2,
        ),
        pair_cap=32 * 1024,
    )


def run_at(n_ranks: int, group=None, device=None, n_dt=12) -> dict:
    """``run_decomp`` of ``build_sim(n_dt=n_dt)`` over ``n_ranks`` x-slabs on the
    ranks of ``group`` (None: the default group): the rows of every pool
    ``_host_lifecycle_passes`` is handed, and the passes' count and mean
    seconds by pass from ``sim.run_stats``."""
    from .. import simulation
    from ..parallel import make_decomp, multihost, run_decomp

    dev = multihost.rank_device(device)
    sim = build_sim(dev, n_dt)
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=n_ranks, group=group)
    real = simulation._host_lifecycle_passes
    rows = []

    def counted(sim, floes, *a, **kw):
        rows.append(int(floes.capacity))
        return real(sim, floes, *a, **kw)

    # run_decomp takes _host_lifecycle_passes from simulation when it runs
    simulation._host_lifecycle_passes = counted
    try:
        t0 = time.perf_counter()
        sim = run_decomp(sim, dec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        simulation._host_lifecycle_passes = real
    st = sim.run_stats
    passes = {k: {"count": n, "mean_ms": 1e3 * st["host_pass_seconds"][k] / n}
              for k, n in st["host_pass_count"].items() if n}
    return {"ranks": n_ranks, "seconds": wall, "gathered_rows": rows,
            "host_passes": passes,
            "host_pass_seconds": sum(st["host_pass_seconds"].values()),
            "local_cap": st["local_cap"], "steps": st["steps"],
            "kernel_launches": st["kernel_launches"],
            "host_pass_launches": sum(st["host_pass_launches"]["two_cross"].values()),
            "final_active": int(sim.model.floes.active.sum()),
            "n_overflow": sim.n_overflow}


def measure(device=None, n_dt=12) -> dict:
    """``run_at`` 1 rank (rank 0, its figures handed to every rank) and every
    rank of the default group (rank 0's seconds, each rank's own rows)."""
    rank = dist.get_rank()
    one = dist.new_group([0])
    got = [run_at(1, one, device, n_dt) if rank == 0 else None]
    dist.broadcast_object_list(got, src=0)
    every = run_at(dist.get_world_size(), None, device, n_dt)
    timed = [{k: every[k] for k in ("seconds", "host_passes", "host_pass_seconds")}]
    dist.broadcast_object_list(timed, src=0)
    every.update(timed[0])
    return {"1": got[0], str(every["ranks"]): every}


def main(argv=None) -> dict:
    from ..parallel import multihost

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: this rank's card)")
    ap.add_argument("--n-dt", type=int, default=12, help="steps (the JAX tool's 12)")
    a = ap.parse_args(argv)
    multihost.initialize(backend=a.backend)
    try:
        res = measure(a.device, a.n_dt)
        if dist.get_rank() == 0:
            for r in res.values():
                passes = ", ".join(f"{k} {v['count']} x {v['mean_ms']:.1f} ms"
                                   for k, v in r["host_passes"].items())
                print(f"D={r['ranks']}: total {r['seconds']:.2f}s, host passes "
                      f"{passes}; gathered rows {r['gathered_rows']} (local_cap "
                      f"{r['local_cap']}), final active {r['final_active']}", flush=True)
        print(json.dumps({"rank": dist.get_rank(), "backend": dist.get_backend(),
                          "runs": res}), flush=True)
    finally:
        dist.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
