"""End-to-end timed run of the reference's title-scale example on the card
(port of ``tools/e2e_shear_flow.py``): 500-floe shear_flow, 5 000 steps of
``run``, two-way coupling, the floe writer every 50 steps - the
configuration behind the reference's ">35x faster than MATLAB" headline.

The pair budget is 16 candidate rows a floe: at the default 8 the JAX
package's run truncated contact forces on 46 of its 5 000 steps.  Exits 1 if
any step exceeded a capacity.

    python -m subzero_tpu_torch.tools.e2e_shear_flow [OUT_DIR]
"""

from __future__ import annotations

import re
import sys
import time
import warnings

import torch

N_DT = 5000


def build(out_dir, n_dt=N_DT, device=None):
    """``examples.shear_flow.build`` with its writers in ``out_dir``, on
    ``device`` (None: the card), with 16 candidate rows a floe."""
    from ..examples import shear_flow

    sim = shear_flow.build(n_dt=n_dt, out_dir=out_dir, device=device)
    sim.pair_cap = 16 * sim.model.floes.capacity
    return sim


def _mass(floes) -> float:
    return float(torch.where(floes.active, floes.mass, 0.0).double().sum())


def run_counted(sim) -> dict:
    """``run(sim)``; the steps over capacity are counted from run's
    end-of-run warning, as the JAX tool counts them."""
    from ..simulation import run
    from .conservation import floe_energy_momentum

    fl = sim.model.floes
    n0, mass0 = int(fl.count()), _mass(fl)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = run(sim)
    if fl.verts.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_overflow_steps = 0
    for w in caught:
        m = re.match(r"(\d+) steps exceeded", str(w.message))
        if m:
            n_overflow_steps += int(m.group(1))
    fl = sim.model.floes
    em = {k: float(v) for k, v in floe_energy_momentum(fl.to(dtype=torch.float64)).items()}
    return {"sim": sim, "seconds": wall, "steps": sim.run_stats["steps"],
            "steps_per_s": sim.run_stats["steps"] / wall,
            "floes": [n0, int(fl.count())], "mass": [mass0, _mass(fl)],
            "ke": em["ke"], "p": (em["px"] ** 2 + em["py"] ** 2) ** 0.5,
            "n_overflow_steps": n_overflow_steps}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    out_dir = args[0] if args else "output/e2e_shear_flow"
    r = run_counted(build(out_dir))
    (n0, n1), (m0, m1) = r["floes"], r["mass"]
    print(f"{r['steps'] - 1}-step shear_flow (two-way coupling, writers@50): "
          f"{r['seconds']:.1f} s ({r['steps_per_s']:.1f} steps/s wall), "
          f"floes {n0} -> {n1}", flush=True)
    print(f"overflow steps: {r['n_overflow_steps']}; mass {m0:.6e} -> {m1:.6e} "
          f"({(m1 - m0) / m0 * 100:+.4f}%); final KE {r['ke']:.4e}, "
          f"|p| {r['p']:.4e}", flush=True)
    if r["n_overflow_steps"]:
        print(f"FAIL: {r['n_overflow_steps']} steps truncated contact forces",
              flush=True)
        return 1
    print("PASS: capacity-clean (0 overflow steps)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
