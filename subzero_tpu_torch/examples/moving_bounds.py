"""Compression by moving boundaries with ridging/rafting and welding.

Port of the reference's examples/moving_bounds.jl: northern and southern
MovingBoundary walls compress the floe field while ridging and welding are
active.
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
    FloeSettings,
    RidgeRaftSettings,
    SubGridPointsGenerator,
    WeldSettings,
)
from ..simulation import Simulation, run
from .common import modulus_from_floes


def build(dtype=torch.float32, n_dt=2500, out_dir=None, n_floes=100, device=None):
    kw = dict(dtype=dtype, device=device)
    Lx = Ly = 1e5
    grid = make_grid(0.0, Lx, 0.0, Ly, dx=2e3, dy=2e3)
    ocean = make_ocean(grid, u=0.0, v=0.0, temp=0.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=-1.0, **kw)
    # compressing north/south walls at -/+ 0.1 m/s
    velocities = np.zeros((4, 2))
    velocities[0] = (0.0, -0.1)  # north moving south
    velocities[1] = (0.0, 0.1)   # south moving north
    domain = make_domain(
        grid,
        BoundaryKind.MOVING,
        BoundaryKind.MOVING,
        BoundaryKind.PERIODIC,
        BoundaryKind.PERIODIC,
        velocities=velocities,
        **kw,
    )
    fs = FloeSettings(
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2)
    )
    floes = initialize_floe_field(
        n_floes, [0.7], domain, 0.25, 0.0, fs,
        rng=np.random.default_rng(1), N=2 * n_floes, **kw,
    )
    model = make_model(grid, ocean, atmos, domain, floes)
    writers = None
    if out_dir:
        writers = OutputWriters(
            initial_state=InitialStateOutputWriter(dir=out_dir, overwrite=True),
            floes=FloeOutputWriter(50, dir=out_dir, overwrite=True),
        )
    return Simulation(
        model=model,
        consts=Constants(E=modulus_from_floes(floes)),
        dt=20,
        n_dt=n_dt,
        verbose=True,
        floe_settings=fs,
        ridgeraft_settings=RidgeRaftSettings(ridge_raft_on=True, dt=150),
        weld_settings=WeldSettings(
            weld_on=True, dts=(500,), nxs=(2,), nys=(2,)
        ),
        writers=writers,
    )


if __name__ == "__main__":
    import time

    sim = build(out_dir="output/moving_bounds")
    t0 = time.time()
    run(sim)
    print(f"ran in {time.time() - t0:.2f}s")
