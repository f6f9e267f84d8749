"""Run a simulation in three checkpoint/restart parts.

Port of the reference's examples/restart_sim.jl: 20 floes in a doubly
periodic parabolic shear flow, run as three sequential segments, each
restarted from the previous segment's checkpoint.  Unlike the reference
(simulation.jl:306-308 documents restart! as approximate), the resumed
segments continue the exact RNG stream, so the 3-part run is bit-identical
to a single continuous run.
"""

import os

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
from ..io import (
    CheckpointOutputWriter,
    FloeOutputWriter,
    InitialStateOutputWriter,
    OutputWriters,
    restart,
)
from ..settings import (
    CouplingSettings,
    FloeSettings,
    SubGridPointsGenerator,
)
from ..simulation import Simulation, run
from .common import modulus_from_floes

N_PART_SIM = 3
N_DT_PART = 500  # reference runs 5000 per part; trimmed for a quick demo


def _writers(out_dir):
    return OutputWriters(
        initial_state=InitialStateOutputWriter(dir=out_dir, overwrite=True),
        floes=FloeOutputWriter(250, dir=out_dir, overwrite=True),
        checkpoint=CheckpointOutputWriter(250, dir=out_dir, overwrite=True),
    )


def build(dtype=torch.float64, out_dir="output/restart_sim/run_1", device=None):
    kw = dict(dtype=dtype, device=device)
    L = 1e5
    grid = make_grid(0.0, L, 0.0, L, dx=1e4, dy=1e4)
    # parabolic-ish u(y) = umax * (1 - |1 - 2y/L|)  (restart_sim.jl:21-24)
    y = np.linspace(0.0, L, grid.Ny + 1)
    uo = 2.0 * (1.0 - np.abs(1.0 - 2.0 * y / L))
    u_field = np.broadcast_to(uo[None, :], (grid.Nx + 1, grid.Ny + 1))
    ocean = make_ocean(grid, u=u_field, v=0.0, temp=0.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=0.0, **kw)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = FloeSettings(
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2)
    )
    floes = initialize_floe_field(
        20, [0.7], domain, 2.0, 0.0, fs,
        rng=np.random.default_rng(1), **kw,
    )
    model = make_model(grid, ocean, atmos, domain, floes)
    consts = Constants(E=modulus_from_floes(floes), f=0.0, turn_angle=0.0)
    settings = dict(
        consts=consts,
        dt=10,
        floe_settings=fs,
        coupling_settings=CouplingSettings(two_way_coupling_on=False),
    )
    sim = Simulation(
        model=model, n_dt=N_DT_PART, writers=_writers(out_dir), **settings
    )
    return sim, settings


if __name__ == "__main__":
    dirs = [f"output/restart_sim/run_{i + 1}" for i in range(N_PART_SIM)]
    sim, settings = build(out_dir=dirs[0])
    run(sim)
    for prev_dir, next_dir in zip(dirs[:-1], dirs[1:]):
        # the initial state (grid/domain/consts) lives with part 1; each
        # part's checkpoint carries the evolving floes/ocean/atmos/RNG
        sim, last = restart(
            os.path.join(dirs[0], "initial_state.h5"),
            os.path.join(prev_dir, "checkpoint.h5"),
            N_DT_PART,
            writers=_writers(next_dir),
            **settings,
        )
        run(sim, start_tstep=last)
    print(f"ran {N_PART_SIM} parts of {N_DT_PART} steps each")
