"""Device-side floe-pool maintenance: removal and dissolution (port of
``subzero_tpu/physics/simplification.py``).

The masking part of the reference's simplify_floes! pipeline
(simplification.jl:279-378): floes marked ``remove`` are deactivated; floes
below the minimum area or height are dissolved into the ocean's
``dissolved`` field at their centroid cell.
"""

from __future__ import annotations

import torch

from ..core.domain import Domain
from ..core.fields import OceanState
from ..core.floes import FloeState
from ..core.grid import RegRectilinearGrid
from ..geometry.clip import first_true
from ..settings import FloeSettings


def remove_and_dissolve(
    floes: FloeState,
    ocean: OceanState,
    grid: RegRectilinearGrid,
    domain: Domain,
    floe_settings: FloeSettings,
):
    """remove_floes! (simplification.jl:279-314), batched.

    Returns (floes, ocean) with dissolved mass accumulated."""
    act = floes.active
    dissolve = act & ~floes.remove & (
        (floes.area < floe_settings.min_floe_area)
        | (floes.height < floe_settings.min_floe_height)
    )
    # dissolved mass goes to the grid cell under the centroid
    # (dissolve_floe!, simplification.jl:18-32)
    cx = torch.floor((floes.centroid[:, 0] - grid.x0) / grid.dx).long()
    cy = torch.floor((floes.centroid[:, 1] - grid.y0) / grid.dy).long()
    if domain.ew_periodic:
        cx = torch.remainder(cx, grid.Nx)
    if domain.ns_periodic:
        cy = torch.remainder(cy, grid.Ny)
    in_grid = (cx >= 0) & (cx < grid.Nx) & (cy >= 0) & (cy < grid.Ny)
    NCy = grid.Ny + 1
    ncells = (grid.Nx + 1) * NCy
    N = floes.capacity
    # at most K floes dissolve per step (the rest stay active and dissolve
    # next step, so the mass ledger stays exact); their masses are summed
    # onto the cells by a deterministic one-hot product
    K = min(256, N)
    rank = torch.cumsum(dissolve.long(), 0) - 1
    selected = dissolve & (rank < K)
    sel = first_true(dissolve, K, N)
    valid = sel < N
    safe = torch.clamp(sel, max=N - 1)
    put = valid & in_grid[safe]
    cellk = torch.where(put, cx[safe] * NCy + cy[safe], ncells)
    onehot = (
        cellk[:, None] == torch.arange(ncells, device=cellk.device)
    ).to(floes.mass.dtype)
    massk = torch.where(put, floes.mass[safe], 0.0)
    added = (onehot.T @ massk).reshape(grid.Nx + 1, NCy)
    ocean = ocean._replace(dissolved=ocean.dissolved + added.to(ocean.dissolved.dtype))

    new_active = act & ~(floes.remove | selected)
    # fuse_with is not reset here: the host fusion pass after the device
    # step consumes it; removed floes cannot fuse, so their flags are masked
    floes = floes._replace(
        active=new_active,
        remove=torch.zeros_like(floes.remove),
        fuse_with=torch.where(new_active, floes.fuse_with, -1).to(floes.fuse_with.dtype),
    )
    return floes, ocean
