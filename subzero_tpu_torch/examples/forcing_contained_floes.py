"""Converging boundary currents with floes seeded in an inner region.

Port of the reference's examples/forcing_contained_floes.jl: inward ocean
currents along all four (open) boundaries push 300 floes that start
contained in the central 80% of the domain; a patch of eastward flow
stirs the middle.
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
    SubGridPointsGenerator,
)
from ..simulation import Simulation, run
from .common import modulus_from_floes


def build(dtype=torch.float64, n_dt=15000, out_dir=None, n_floes=300, device=None):
    kw = dict(dtype=dtype, device=device)
    Lx = Ly = 1e5
    grid = make_grid(0.0, Lx, 0.0, Ly, dx=2e3, dy=2e3)
    nx, ny = grid.Nx + 1, grid.Ny + 1
    # inward currents at all four boundaries + an eastward patch
    # (forcing_contained_floes.jl:16-35)
    u = np.zeros((nx, ny))
    u[:5, :] = 0.2
    u[nx - 5 :, :] = -0.2
    u[19:40, 19:30] = 0.15
    v = np.zeros((nx, ny))
    v[:, :5] = 0.2
    v[:, ny - 5 :] = -0.2
    ocean = make_ocean(grid, u=u, v=v, temp=0.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=-1.0, **kw)
    domain = make_domain(grid, *([BoundaryKind.OPEN] * 4), **kw)
    fs = FloeSettings(
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2)
    )
    bounds = [
        [0.1 * Lx, 0.1 * Ly], [0.9 * Lx, 0.1 * Ly],
        [0.9 * Lx, 0.9 * Ly], [0.1 * Lx, 0.9 * Ly],
    ]
    floes = initialize_floe_field(
        n_floes, [0.4], domain, 0.25, 0.0, fs,
        rng=np.random.default_rng(1), floe_bounds=bounds, **kw,
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
        coupling_settings=CouplingSettings(two_way_coupling_on=False),
        writers=writers,
    )


if __name__ == "__main__":
    import time

    sim = build(out_dir="output/contained")
    t0 = time.time()
    run(sim)
    print(f"ran in {time.time() - t0:.2f}s")
