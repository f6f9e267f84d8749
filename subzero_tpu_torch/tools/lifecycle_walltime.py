"""Wall time of the host life-cycle passes on an 8 016-floe pool (port of
``tools/lifecycle_walltime.py``).

The device step handles collisions, coupling and integration; fracture,
welding, smoothing and fusing are host passes at low cadences (simulation.jl
process order).  Each pass here pulls the pool from the card, works on it
with numpy and the native clip, and pushes it back, as it does inside
``run``.  Its time is set against the device step's budget at the pass's
cadence, ``cadence x step_ms``, where ``step_ms`` is many_floes_8000's step
as ``subzero_tpu_torch.bench`` measures it on the same card: the pass is
sub-dominant when its time is well under that budget.

    python -m subzero_tpu_torch.tools.lifecycle_walltime [N_FLOES]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# the passes' cadences in steps, as the JAX tool sets them against the step
CADENCE = {"weld": 150, "smooth": 20, "fracture": 75}


def _timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def walltime(n_floes=8000, step_ms=None, device=None) -> dict:
    """Times weld (one pass on a 25 x 25 grid), smooth (the scan), a
    fracture of 5% of the pool (Hibler curve, 3 pieces) and fuse (100
    marked pairs) on ``bench.build_sim(n_floes, 4e5, 2e3, bins=True,
    coupling=False)``'s pool on ``device`` (None: the card).  ``step_ms``
    defaults to ``bench.measure`` of many_floes_8000 on the same device.
    The pool is full (bench.build_sim's capacity is its floe count), so the
    fracture pass drops its pieces, as in the JAX tool."""
    from .. import bench
    from ..device import resolve_device
    from ..physics import lifecycle_host as lh
    from ..settings import (FractureSettings, HiblerYieldCurve,
                            SimplificationSettings, WeldSettings)

    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if step_ms is None:
        cfg = bench.CONFIGS["many_floes_8000"]
        step_ms = bench.measure(bench.build_sim(cfg["n"], cfg["L"], bench.DX,
                                                bins=True, device=device),
                                cfg["n_steps"])["step_ms"]
    sim = bench.build_sim(n_floes, 4e5, bench.DX, bins=True, coupling=False,
                          device=device)
    fl, fs, dt = sim.model.floes, sim.floe_settings, float(sim.dt)
    N = fl.capacity
    act = fl.active.cpu().numpy()
    n_act = int(act.sum())
    max_id = int(fl.id.max())
    rng = np.random.default_rng(0)
    rows = np.flatnonzero(act)[:: max(n_act // 400, 1)][:400]
    out = {"n_floes": n_act, "capacity": N, "step_ms": step_ms, "passes": {}}

    def record(name, seconds, **kw):
        cad = CADENCE.get(name)
        budget = None if cad is None else cad * step_ms / 1e3
        out["passes"][name] = {"seconds": seconds, "cadence": cad,
                               "budget_seconds": budget, **kw}

    # welding: one pass of the multi-scale schedule
    ws = WeldSettings(weld_on=True, dts=(150,), nxs=(25,), nys=(25,),
                      min_weld_area=1e6, max_weld_area=1e9, welding_coeff=150.0)
    (welded, _), s = _timed(lambda: lh.timestep_welding(
        fl, max_id, sim.model.grid, sim.model.domain, ws, fs, 0, dt, rng), sync)
    record("weld", s, floes_welded=n_act - int(welded.active.sum()))

    # smoothing: the scan over the pool (no floe is over the vertex cap)
    sp = SimplificationSettings(smooth_vertices_on=True, dt_smooth=20)
    over = int((fl.nverts.cpu().numpy()[act] > sp.max_vertices).sum())
    _, s = _timed(lambda: lh.smooth_floes(fl, sp, fs, dt, rng), sync)
    record("smooth", s, floes_over_cap=over)

    # fracture: 5% of the pool marked by a stress beyond the yield curve
    frs = FractureSettings(fractures_on=True, criteria=HiblerYieldCurve(),
                           dt=75, npieces=3)
    stress = torch.zeros_like(fl.stress_accum)
    stress[torch.as_tensor(rows, device=device)] = torch.tensor(
        [[-1e8, 0.0], [0.0, -1e8]], dtype=stress.dtype, device=device)
    (frac, _), s = _timed(lambda: lh.fracture_floes(
        fl._replace(stress_accum=stress), max_id, rng, frs, fs, dt), sync)
    record("fracture", s, marked=len(rows),
           floes_after=int(frac.active.sum()))

    # fusing: 100 marked pairs of neighbouring rows (most are disjoint, so
    # their union fails fast; the machinery runs all the same)
    fw = np.full(N, -1, np.int32)
    act_rows = np.flatnonzero(act)
    fw[act_rows[:200:2]] = act_rows[1:200:2]
    fuse_with = torch.as_tensor(fw, device=device).to(fl.fuse_with.dtype)
    _, s = _timed(lambda: lh.fuse_floes(fl._replace(fuse_with=fuse_with),
                                        max_id, fs, dt, rng), sync)
    record("fuse", s, marked_pairs=100)
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    print(json.dumps(walltime(int(args[0]) if args else 8000)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
