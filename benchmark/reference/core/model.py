"""Model container: grid + ocean + atmos + domain + floes.

Port of ``subzero_tpu/core/model.py`` (Subzero.jl's ``Model``,
model.jl:47-119) including its validation: domain within grid, matching
field sizes, temperature sanity.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from .domain import Domain, EAST, NORTH, SOUTH, WEST
from .fields import AtmosState, OceanState
from .floes import FloeState
from .grid import RegRectilinearGrid


@dataclasses.dataclass(frozen=True)
class Model:
    grid: RegRectilinearGrid
    ocean: OceanState
    atmos: AtmosState
    domain: Domain
    floes: FloeState

    def replace(self, **kw) -> "Model":
        return dataclasses.replace(self, **kw)


def make_model(
    grid: RegRectilinearGrid,
    ocean: OceanState,
    atmos: AtmosState,
    domain: Domain,
    floes: FloeState,
) -> Model:
    # domain_in_grid validation (model.jl:16-36)
    vals = domain.vals.detach().cpu().tolist()
    if not (
        vals[NORTH] <= grid.yf
        and vals[SOUTH] >= grid.y0
        and vals[EAST] <= grid.xf
        and vals[WEST] >= grid.x0
        and vals[NORTH] > vals[SOUTH]
        and vals[EAST] > vals[WEST]
    ):
        raise ValueError("domain does not fit within grid")
    if ocean.u.shape != atmos.u.shape:
        raise ValueError("ocean and atmos field sizes must match")
    expected = (grid.Nx + 1, grid.Ny + 1)
    if tuple(ocean.u.shape) != expected:
        raise ValueError(f"ocean fields {tuple(ocean.u.shape)} != grid points {expected}")
    if bool(torch.any(atmos.temp > ocean.temp)):
        warnings.warn(
            "atmosphere temperature above ocean temperature over part of the "
            "grid; ice may melt unexpectedly"
        )
    return Model(grid=grid, ocean=ocean, atmos=atmos, domain=domain, floes=floes)
