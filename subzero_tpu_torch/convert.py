"""Bring the JAX reference's state over to the port.

``from_jax_state`` takes the reference's state objects (``FloeState``,
``OceanState``, ``AtmosState``, ``Domain``, ``RegRectilinearGrid``) and
returns the port's, field for field, so both packages compute on the same
numbers (a domain's topography elements included).  Every array field is
read through ``numpy.asarray``, so the reference's arrays, or numpy copies of
them, are both accepted; this module imports no JAX.  ``to_numpy_state`` is
the way back for a floe pool: a dict of numpy arrays by field name, which
the reference's ``FloeState(**...)`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.domain import Domain, TopographyField
from .core.fields import AtmosState, OceanState
from .core.floes import FloeState
from .core.grid import RegRectilinearGrid
from .device import resolve_device


def _tensor(x, device, dtype):
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(np.array(a, dtype=np.float64), device=device).to(dtype)
    if a.dtype == np.bool_:
        return torch.as_tensor(np.array(a), device=device)
    return torch.as_tensor(np.array(a, dtype=np.int32), device=device)


def _convert(cls, obj, device, dtype):
    return cls(*(_tensor(getattr(obj, f), device, dtype) for f in cls._fields))


def from_jax_state(floes, ocean, atmos, domain, grid, device=None, *, dtype):
    """(floes, ocean, atmos, domain, grid) of the reference -> the port's,
    on ``device`` (``None``: the card) with floating fields in ``dtype``."""
    device = resolve_device(device)
    topo = _convert(TopographyField, domain.topography, device, dtype)
    return (
        _convert(FloeState, floes, device, dtype),
        _convert(OceanState, ocean, device, dtype),
        _convert(AtmosState, atmos, device, dtype),
        Domain(
            kinds=tuple(int(k) for k in domain.kinds),
            vals=_tensor(domain.vals, device, dtype),
            velocities=_tensor(domain.velocities, device, dtype),
            topography=topo,
        ),
        RegRectilinearGrid(
            x0=grid.x0, xf=grid.xf, y0=grid.y0, yf=grid.yf, Nx=grid.Nx, Ny=grid.Ny
        ),
    )


def to_numpy_state(floes: FloeState) -> dict:
    """A port floe pool as a dict of numpy arrays keyed by the field names
    the reference's ``FloeState`` shares with the port's (dtypes kept)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in floes._asdict().items()}
