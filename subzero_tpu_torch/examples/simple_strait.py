"""Flow through a strait with topography, fracture, and ridging.

Port of the reference's examples/simple_strait.jl: southward ocean flow
pushes 500 floes between two coastal topography features and an island,
with Hibler-criteria fracture every 75 steps and ridging every 150.
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
    make_topography,
)
from ..io import (
    FloeOutputWriter,
    GridOutputWriter,
    InitialStateOutputWriter,
    OutputWriters,
)
from ..settings import (
    CouplingSettings,
    FloeSettings,
    FractureSettings,
    HiblerYieldCurve,
    RidgeRaftSettings,
    SubGridPointsGenerator,
)
from ..simulation import Simulation, run
from .common import modulus_from_floes


def build(dtype=torch.float32, n_dt=5000, out_dir=None, n_floes=500, device=None):
    kw = dict(dtype=dtype, device=device)
    Lx = Ly = 1e5
    grid = make_grid(0.0, Lx, 0.0, Ly, dx=2e3, dy=2e3)
    ocean = make_ocean(grid, u=0.0, v=-0.3, temp=0.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=0.0, **kw)

    island = [[6e4, 4e4], [6e4, 4.5e4], [6.5e4, 4.5e4], [6.5e4, 4e4]]
    topo1 = [[0, 0.0], [0, 1e5], [2e4, 1e5], [3e4, 5e4], [2e4, 0]]
    topo2 = [[8e4, 0], [7e4, 5e4], [8e4, 1e5], [1e5, 1e5], [1e5, 0]]
    topo = make_topography([island, topo1, topo2], **kw)

    domain = make_domain(
        grid,
        BoundaryKind.PERIODIC,
        BoundaryKind.PERIODIC,
        BoundaryKind.COLLISION,
        BoundaryKind.COLLISION,
        topography=topo,
        **kw,
    )
    fs = FloeSettings(
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2)
    )
    floes = initialize_floe_field(
        n_floes, [0.7], domain, 0.25, 0.0, fs,
        rng=np.random.default_rng(3),
        N=2 * n_floes,  # headroom for fracture pieces
        **kw,
    )
    model = make_model(grid, ocean, atmos, domain, floes)
    writers = None
    if out_dir:
        writers = OutputWriters(
            initial_state=InitialStateOutputWriter(dir=out_dir, overwrite=True),
            floes=FloeOutputWriter(50, dir=out_dir, overwrite=True),
            grid=GridOutputWriter(100, dims=(10, 10), dir=out_dir, overwrite=True),
        )
    return Simulation(
        model=model,
        consts=Constants(E=modulus_from_floes(floes)),
        dt=20,
        n_dt=n_dt,
        verbose=True,
        floe_settings=fs,
        coupling_settings=CouplingSettings(two_way_coupling_on=True),
        fracture_settings=FractureSettings(
            fractures_on=True,
            criteria=HiblerYieldCurve(),
            dt=75,
            npieces=3,
            deform_on=False,
        ),
        ridgeraft_settings=RidgeRaftSettings(ridge_raft_on=True, dt=150),
        writers=writers,
    )


if __name__ == "__main__":
    import time

    sim = build(out_dir="output/simple_strait")
    t0 = time.time()
    run(sim)
    print(f"ran in {time.time() - t0:.2f}s")
