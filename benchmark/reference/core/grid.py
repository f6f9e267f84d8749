"""Regular rectilinear grid.

Mirrors Subzero.jl's ``RegRectilinearGrid``
(src/simulation_components/grids.jl:106-211): ``Nx x Ny``
cells over ``[x0, xf] x [y0, yf]``; ocean/atmosphere fields live on the
``(Nx+1) x (Ny+1)`` grid points, indexed ``[ix, iy]``.  Pure static config,
identical to ``subzero_tpu/core/grid.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RegRectilinearGrid:
    x0: float
    xf: float
    y0: float
    yf: float
    Nx: int
    Ny: int

    @property
    def dx(self) -> float:
        return (self.xf - self.x0) / self.Nx

    @property
    def dy(self) -> float:
        return (self.yf - self.y0) / self.Ny

    @property
    def Lx(self) -> float:
        return self.xf - self.x0

    @property
    def Ly(self) -> float:
        return self.yf - self.y0

    def __post_init__(self):
        if self.xf <= self.x0 or self.yf <= self.y0:
            raise ValueError("grid extent must have xf > x0 and yf > y0")
        if self.Nx < 1 or self.Ny < 1:
            raise ValueError("grid must have at least one cell per direction")


def make_grid(
    x0: float,
    xf: float,
    y0: float,
    yf: float,
    Nx: int | None = None,
    Ny: int | None = None,
    dx: float | None = None,
    dy: float | None = None,
) -> RegRectilinearGrid:
    """Construct from either cell counts or cell sizes.

    With sizes, the extent is trimmed to a whole number of cells, exactly as
    the reference constructor does (grids.jl:180-211).
    """
    if Nx is None or Ny is None:
        if dx is None or dy is None:
            raise ValueError("provide either (Nx, Ny) or (dx, dy)")
        Nx = int((xf - x0) / dx)
        Ny = int((yf - y0) / dy)
        xf = x0 + Nx * dx
        yf = y0 + Ny * dy
    return RegRectilinearGrid(x0=x0, xf=xf, y0=y0, yf=yf, Nx=Nx, Ny=Ny)
