"""Full-physics stress test: maximum floe count with fracture, ridging,
and welding enabled.

The scaling configuration of the repository's examples/many_floes.py (cf.
the reference's examples/many_floes.jl): open boundaries, strong ocean
forcing, full life-cycle physics.
"""

import numpy as np
import torch

from ..constants import Constants
from ..core import (
    BoundaryKind,
    initialize_floe_field,
    make_atmos,
    make_domain,
    make_grid,
    make_model,
    make_ocean,
)
from ..io import FloeOutputWriter, InitialStateOutputWriter, OutputWriters
from ..settings import (
    CouplingSettings,
    FloeSettings,
    FractureSettings,
    HiblerYieldCurve,
    RidgeRaftSettings,
    SubGridPointsGenerator,
    WeldSettings,
)
from ..simulation import Simulation, run
from .common import modulus_from_floes


def build(dtype=torch.float32, n_dt=4000, out_dir=None, n_floes=1000, device=None):
    kw = dict(dtype=dtype, device=device)
    Lx = Ly = 1e5
    grid = make_grid(-Lx, Lx, -Ly, Ly, dx=1e4, dy=1e4)
    ocean = make_ocean(grid, u=-0.2, v=0.0, temp=-1.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=-3.0, **kw)
    domain = make_domain(grid, *([BoundaryKind.OPEN] * 4), **kw)
    fs = FloeSettings(
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2)
    )
    floes = initialize_floe_field(
        n_floes, [0.8], domain, 0.25, 0.0, fs,
        rng=np.random.default_rng(1), N=2 * n_floes, **kw,
    )
    model = make_model(grid, ocean, atmos, domain, floes)
    writers = None
    if out_dir:
        writers = OutputWriters(
            initial_state=InitialStateOutputWriter(dir=out_dir, overwrite=True),
            floes=FloeOutputWriter(100, dir=out_dir, overwrite=True),
        )
    return Simulation(
        model=model,
        consts=Constants(E=modulus_from_floes(floes)),
        dt=20,
        n_dt=n_dt,
        verbose=True,
        floe_settings=fs,
        coupling_settings=CouplingSettings(two_way_coupling_on=False),
        fracture_settings=FractureSettings(
            fractures_on=True, criteria=HiblerYieldCurve(), dt=75, npieces=3
        ),
        ridgeraft_settings=RidgeRaftSettings(ridge_raft_on=True, dt=150),
        weld_settings=WeldSettings(weld_on=True, dts=(500,), nxs=(4,), nys=(4,)),
        writers=writers,
    )


if __name__ == "__main__":
    import time

    sim = build(out_dir="output/many_floes")
    t0 = time.time()
    run(sim)
    print(f"ran in {time.time() - t0:.2f}s")
