"""Benchmark of the port: floe-pair contact interactions per second on one
NVIDIA GPU (the port of the repository's ``bench.py``).

The same five configurations as ``bench.py``, built bitwise as it builds them
(seed 1, f32, periodic square box, 2 km grid, concentration 0.8, mean height
0.25, E from the floe areas, dt 20, two-way coupling on):

  * shear_flow_500   - the reference's largest example scale, dense broad
    phase, 400 steps a run;
  * many_floes_2000  - 4x the floes on a 2x box, dense, 150 steps;
  * many_floes_8000  - 16x the floes on a 4x box, binned broad phase with 8
    candidate rows a floe, 50 steps;
  * many_floes_16000 - 32x, binned, 20 steps;
  * many_floes_32000 - 64x, binned, 10 steps.

Each configuration runs the full device step (collide, couple at its
cadence, integrate, remove) through ``simulation.run_scan``: one warm-up run
of ``n_steps``, which captures the step as CUDA graphs
(``step_graph.StepGraph``), then four timed runs from the same initial
state that replay them, each ending in a device synchronisation; the
fastest counts (as bench.py's timed runs reuse the scan its warm-up
compiled).  The capture's seconds are reported apart (``capture_s``).  ``pairs_per_s`` is the
broad phase's valid candidate pairs at step 0 times steps per second, as
``bench.py`` counts it.  The step's split by layer is the StepGraph's layer
marks' (``tracing``), in each run's ``run_stats["graph"]``.

    python -m subzero_tpu_torch.bench

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
Runs on the card and raises without one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time

import numpy as np
import torch

SEED = 1
DX = 2e3
CONFIGS = {
    "shear_flow_500": dict(n=500, L=1e5, bins=False, n_steps=400),
    "many_floes_2000": dict(n=2000, L=2e5, bins=False, n_steps=150),
    "many_floes_8000": dict(n=8000, L=4e5, bins=True, n_steps=50),
    "many_floes_16000": dict(n=16000, L=5.66e5, bins=True, n_steps=20),
    "many_floes_32000": dict(n=32000, L=8e5, bins=True, n_steps=10),
}
REPS = 4
BASELINE_PAIRS_PER_S = 1e6  # BASELINE.json's target


def build_sim(n_floes, L, dx, *, device=None, dtype=torch.float32, seed=SEED,
              coupling=True, collisions=True, bins=False):
    """``bench.build_sim(n_floes, L, dx, bins=)``'s field with the port's own
    host setup: periodic box, shear ocean, Voronoi floes at concentration
    0.8 and mean height 0.25, E from the floe areas, dt 20, two-way coupling
    on; dense broad phase, or with ``bins`` the binned one (``_auto_bins``
    of the field and 8 candidate rows a floe).  ``device=None``: the card."""
    from .constants import Constants
    from .core import (BoundaryKind, initialize_floe_field, make_atmos,
                       make_domain, make_grid, make_model, make_ocean)
    from .settings import (CollisionSettings, CouplingSettings, FloeSettings,
                           SubGridPointsGenerator)
    from .simulation import Simulation, _auto_bins

    kw = dict(dtype=dtype, device=device)
    grid = make_grid(0.0, L, 0.0, L, dx=dx, dy=dx)
    ny = grid.Ny + 1
    half = ny // 2 + 1
    uvels = np.concatenate([np.linspace(0, 0.5, half), np.linspace(0.5, 0, ny - half)])
    u_field = np.broadcast_to(uvels[None, :], (grid.Nx + 1, ny))
    ocean = make_ocean(grid, u=u_field, v=0.0, temp=0.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=-1.0, **kw)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = FloeSettings(
        min_floe_area=1e6,
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2),
    )
    floes = initialize_floe_field(n_floes, [0.8], domain, 0.25, 0.0, fs,
                                  rng=np.random.default_rng(seed), **kw)
    area = floes.area[floes.active].cpu().numpy()
    modulus = 1.5e3 * (np.mean(np.sqrt(area)) + np.min(np.sqrt(area)))
    sim = Simulation(
        model=make_model(grid, ocean, atmos, domain, floes),
        consts=Constants(E=float(modulus)),
        dt=20,
        n_dt=0,
        floe_settings=fs,
        coupling_settings=CouplingSettings(coupling_on=coupling,
                                           two_way_coupling_on=True),
        collision_settings=CollisionSettings(collisions_on=collisions),
        bins=None,  # pinned per configuration, as bench.py pins it
    )
    if bins:
        sim.bins = _auto_bins(sim.model)
        sim.pair_cap = 8 * sim.model.floes.capacity
    return sim


def _finite(sim) -> bool:
    return all(bool(torch.isfinite(x).all())
               for tree in (sim.model.floes, sim.model.ocean)
               for x in tree if x.is_floating_point())


def measure(sim, n_steps=50, reps=REPS, _eager=False):
    """bench.py's ``measure`` on the port: candidate pairs at step 0, one
    warm-up run of ``n_steps`` (on the card it captures the step's graphs),
    then ``reps`` timed runs from the same initial state (replaying them),
    each ending in a device synchronisation; the fastest counts.  Adds the
    overflow steps of a timed run, whether its end state is finite, its
    active floes, the capture's seconds and count, and on the card the peak
    device memory over the timed runs: allocated by tensors, and reserved
    (which holds the graphs' private pool), and how much each program's
    capture added to the reserved memory.  The runs step a copy of ``sim``,
    which keeps the graphs its warm-up captured.  ``_eager``: every run
    steps without a graph (the reference the graph is timed against)."""
    from .physics.collisions import find_candidate_pairs
    from .simulation import run_scan

    fl = sim.model.floes
    on_card = fl.verts.is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    pairs = find_candidate_pairs(fl, sim.model.domain, sim.pair_cap, sim.bins)
    pairs_per_step = int(pairs.valid.sum())

    end = dataclasses.replace(sim)
    run_scan(end, n_steps, _eager=_eager)
    sync()
    captured = end.run_stats["graph"]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    elapsed = math.inf
    for _ in range(reps):
        end.model = sim.model
        t0 = time.perf_counter()
        run_scan(end, n_steps, _eager=_eager)
        sync()
        elapsed = min(elapsed, time.perf_counter() - t0)
        if not _eager and end.run_stats["graph"]["captures"]:
            raise AssertionError("a timed run captured the step again")
    pool = {} if _eager else end.step_graph().capture_pool_bytes
    steps_per_s = n_steps / elapsed
    return {
        "pairs_per_s": pairs_per_step * steps_per_s,
        "steps_per_s": round(steps_per_s, 3),
        "step_ms": round(1e3 / steps_per_s, 4),
        "pairs_per_step": pairs_per_step,
        "n_floes": int(fl.count()),
        "binned": sim.bins is not None,
        "two_way_coupling": bool(sim.coupling_settings.two_way_coupling_on),
        "n_steps": n_steps,
        "n_overflow": end.n_overflow,
        "finite": _finite(end),
        "n_floes_end": int(end.model.floes.count()),
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else None),
        "peak_reserved_gib": (torch.cuda.max_memory_reserved() / 2**30
                              if on_card else None),
        "graph": not _eager,
        "capture_s": None if _eager else captured["capture_seconds"],
        "captures": None if _eager else captured["captures"],
        "recaptures": None if _eager else captured["recaptures"],
        "capture_pool_gib": {str(p): b / 2**30 for p, b in pool.items()},
    }


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def result_line(detail: dict) -> dict:
    """bench.py's JSON line over the measured configurations in ``detail``."""
    best_name = max((k for k in CONFIGS if k in detail),
                    key=lambda k: detail[k]["pairs_per_s"])
    best = detail[best_name]["pairs_per_s"]
    return {
        "metric": ("floe-pair interactions/s/chip "
                   f"(full step, two-way coupling on, best config: {best_name})"),
        "value": best,
        "unit": "pairs/s",
        "vs_baseline": round(best / BASELINE_PAIRS_PER_S, 3),
        "detail": detail,
    }


def main() -> dict:
    """Runs every configuration on the card (raising without one) and
    prints the JSON line; returns it."""
    from .device import resolve_device

    device = resolve_device(None)
    detail = {"device": {"name": torch.cuda.get_device_name(device),
                         "nvidia_smi": nvidia_smi()}}
    for name, cfg in CONFIGS.items():
        sim = build_sim(cfg["n"], cfg["L"], DX, bins=cfg["bins"], device=device)
        r = measure(sim, cfg["n_steps"])
        r["pairs_per_s"] = round(r["pairs_per_s"], 1)
        detail[name] = r
    line = result_line(detail)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
