"""The JAX package's run of examples/distributed_shear_flow.py on the CPU, the
figures the port's ``chip_smoke.py`` ``decomp`` phase is held to.

    python tests/jax_decomp_reference.py              # the example's run
    python tests/jax_decomp_reference.py --vs-single  # decomposed vs one device

The first runs ``run_decomp`` over 4 x-slabs of an 8-device virtual CPU mesh
on the example's configuration (examples/shear_flow.py's build: 500 floes,
f32, two-way coupling, 500 steps, its writers into a temporary directory),
and prints one JSON line: the capacities, ``n_overflow`` (the steps the run
warned about), the active floes, the ids that left and joined the pool, and
the floe mass before and after.  The second (f64) steps the example's field
5 times at 32 candidate rows a floe on one device and over 4 x-slabs, and
prints each prognostic field's largest difference by floe id, relative to
the single device's value (tests/test_parallel.py's comparison).
"""

import json
import os
import sys
import tempfile
import time
import warnings

VS_SINGLE = "--vs-single" in sys.argv[1:]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_ENABLE_X64"] = "true" if VS_SINGLE else "false"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "examples")]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from shear_flow import build  # noqa: E402
from subzero_tpu.parallel import (build_decomp_step, distribute, gather,  # noqa: E402
                                  make_decomp, run_decomp)
from subzero_tpu.simulation import build_step  # noqa: E402


def main(n_dt=500, n_floes=500, n_slabs=4):
    with tempfile.TemporaryDirectory() as out:
        sim = build(n_dt=n_dt, out_dir=out, n_floes=n_floes)
        sim.verbose = False
        dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=n_slabs)
        f0 = sim.model.floes
        ids0 = set(np.asarray(f0.id)[np.asarray(f0.active)].tolist())
        mass0 = float(np.asarray(f0.mass, np.float64)[np.asarray(f0.active)].sum())
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            sim = run_decomp(sim, dec)
        seconds = time.perf_counter() - t0
    over = [str(r.message) for r in rec if "exceeded a decomposition capacity" in str(r.message)]
    f1 = sim.model.floes
    ids1 = set(np.asarray(f1.id)[np.asarray(f1.active)].tolist())
    mass1 = float(np.asarray(f1.mass, np.float64)[np.asarray(f1.active)].sum())
    print(json.dumps({
        "config": f"examples/distributed_shear_flow.py: {n_floes} floes, f32, "
                  f"{n_slabs} x-slabs, {n_dt} steps, 8-device virtual CPU mesh",
        "local_cap": dec.local_cap, "halo_cap": dec.halo_cap, "mig_cap": dec.mig_cap,
        "margin": dec.margin,
        "n_overflow": int(over[0].split()[0]) if over else 0,
        "active": [len(ids0), len(ids1)],
        "ids_gone": sorted(ids0 - ids1), "ids_new": sorted(ids1 - ids0),
        "floe_mass": [mass0, mass1], "seconds": seconds,
    }))


def vs_single(n_steps=5, n_slabs=4):
    sim = build(dtype=jnp.float64, n_dt=0, n_floes=500)
    sim.pair_cap = 32 * sim.model.floes.capacity
    m = sim.model
    step = build_step(sim)
    f1, o1, d1 = m.floes, m.ocean, m.domain
    dec = make_decomp(m.floes, m.domain, n_devices=n_slabs)
    dstep = build_decomp_step(sim, dec)
    fd, od, dd = distribute(m.floes, m.domain, dec), m.ocean, m.domain
    for k in range(n_steps):
        f1, o1, d1, _ = step(f1, o1, d1, jnp.asarray(k))
        fd, od, dd, _ = dstep(fd, od, dd, jnp.asarray(k))

    def rows(f):
        act = np.asarray(f.active)
        order = np.argsort(np.asarray(f.id)[act])
        return {k: np.asarray(getattr(f, k))[act][order]
                for k in ("id", "centroid", "u", "v", "xi", "height")}

    a, b = rows(f1), rows(gather(fd))
    assert np.array_equal(a["id"], b["id"])
    print(json.dumps({
        "config": f"examples/shear_flow.py's field, 500 floes, f64, pair_cap 32N, "
                  f"{n_slabs} x-slabs against one device, {n_steps} steps",
        "max_rel_err": {k: float((np.abs(b[k] - a[k]) / (np.abs(a[k]) + 1e-300)).max())
                        for k in ("centroid", "u", "v", "xi", "height")},
    }))


if __name__ == "__main__":
    vs_single() if VS_SINGLE else main()
