"""Uniform ocean flow with a few floes (two-way coupling smoke test).

Port of the reference's examples/uniform_flow.jl.
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
from ..settings import CouplingSettings, FloeSettings
from ..simulation import Simulation, run
from .common import modulus_from_floes


def build(dtype=torch.float32, n_dt=20, out_dir=None, device=None):
    kw = dict(dtype=dtype, device=device)
    Lx = Ly = 1e5
    grid = make_grid(0.0, Lx, 0.0, Ly, dx=2e3, dy=2e3)
    ocean = make_ocean(grid, u=0.1, v=0.0, temp=0.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=-1.0, **kw)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = FloeSettings()
    floes = initialize_floe_field(
        5, [0.4], domain, 0.25, 0.0, fs, rng=np.random.default_rng(1), **kw
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
        coupling_settings=CouplingSettings(two_way_coupling_on=True),
        writers=writers,
    )


if __name__ == "__main__":
    import time

    sim = build(out_dir="output/uniform_flow")
    t0 = time.time()
    run(sim)
    print(f"ran in {time.time() - t0:.2f}s")
