"""Ocean and atmosphere state (port of ``subzero_tpu/core/fields.py``).

Prescribed velocity/temperature fields on the ``[Nx+1, Ny+1]`` grid points
(indexed ``[ix, iy]``), the two-way-coupling outputs (stress on the ocean,
sea-ice fraction, heatflux factor) and the dissolved-mass accumulator.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .grid import RegRectilinearGrid


class OceanState(NamedTuple):
    u: torch.Tensor            # [Nx+1, Ny+1]
    v: torch.Tensor
    temp: torch.Tensor
    hflx_factor: torch.Tensor
    tau_x: torch.Tensor        # stress on ocean from ice/atmos (2-way)
    tau_y: torch.Tensor
    si_frac: torch.Tensor      # sea-ice area fraction per (line-centered) cell
    dissolved: torch.Tensor    # mass dissolved into each cell


class AtmosState(NamedTuple):
    u: torch.Tensor            # [Nx+1, Ny+1]
    v: torch.Tensor
    temp: torch.Tensor


def _field(val, shape, dtype, device):
    arr = np.array(val, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full(shape, float(arr))
    if arr.shape != shape:
        raise ValueError(f"field shape {arr.shape} != grid point shape {shape}")
    return torch.as_tensor(arr, dtype=dtype, device=device)


def make_ocean(grid: RegRectilinearGrid, u=0.0, v=0.0, temp=0.0, *,
               dtype, device=None) -> OceanState:
    """Ocean constructor (oceans.jl:207-222). Scalars broadcast to fields.
    ``device=None`` is the card."""
    device = resolve_device(device)
    shape = (grid.Nx + 1, grid.Ny + 1)
    t = _field(temp, shape, dtype, device)
    if bool(torch.any((t < -3) | (t > 0))):
        warnings.warn(
            "Ocean temperatures outside the range [-3, 0] may give unrealistic "
            "freezing behavior"
        )

    def z():
        return torch.zeros(shape, dtype=dtype, device=device)

    return OceanState(
        u=_field(u, shape, dtype, device),
        v=_field(v, shape, dtype, device),
        temp=t,
        hflx_factor=z(),
        tau_x=z(),
        tau_y=z(),
        si_frac=z(),
        dissolved=z(),
    )


def make_atmos(grid: RegRectilinearGrid, u=0.0, v=0.0, temp=0.0, *,
               dtype, device=None) -> AtmosState:
    """Atmos constructor (atmos.jl:108-114).  ``device=None`` is the card."""
    device = resolve_device(device)
    shape = (grid.Nx + 1, grid.Ny + 1)
    return AtmosState(
        u=_field(u, shape, dtype, device),
        v=_field(v, shape, dtype, device),
        temp=_field(temp, shape, dtype, device),
    )
