"""Domain: four directional boundaries + static topography (device half).

Port of ``subzero_tpu/core/domain.py``.  Each wall is one of four kinds:

  * OPEN       - floes touching it are removed
  * PERIODIC   - floes wrap around (minimum-image shifts in collisions)
  * COLLISION  - immovable wall exerting contact forces
  * MOVING     - collision wall translating with (u, v)

Wall kinds are static Python config; wall positions (``vals``: [north,
south, east, west] edge coordinates) are a tensor so MOVING walls advance.
Topography elements are padded rings carried as tensors, built on the host
by ``make_topography`` (or brought over from the reference by
``convert.py``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import host_clip
from ..geometry.polygon import max_radius, pad_polygon_np, poly_area, poly_centroid
from .grid import RegRectilinearGrid


class BoundaryKind(enum.IntEnum):
    OPEN = 0
    PERIODIC = 1
    COLLISION = 2
    MOVING = 3


# directions index the vals array: [north, south, east, west], matching the
# reference's negative interaction indices -1..-4 (domains.jl:150-163)
NORTH, SOUTH, EAST, WEST = 0, 1, 2, 3


class TopographyField(NamedTuple):
    verts: torch.Tensor     # [T, V, 2] padded CCW rings
    nverts: torch.Tensor    # [T] int32
    centroid: torch.Tensor  # [T, 2]
    rmax: torch.Tensor      # [T]
    area: torch.Tensor      # [T]

    @property
    def count(self) -> int:
        return self.verts.shape[0]


def make_topography(coords_list, V: int = 32, *, dtype,
                    device=None) -> TopographyField:
    """Build a topography field from polygon coordinate lists.

    De-intersects overlapping polygons (difference of later ones against
    earlier), as initialize_topography_field does (topography.jl:154-169).
    ``device=None`` is the card."""
    device = resolve_device(device)
    polys: list[np.ndarray] = []
    for c in coords_list:
        c = np.asarray(c, dtype=float)
        if c.ndim == 3:  # PolyVec with ring nesting
            c = c[0]
        ring = host_clip._clean_ring(c)
        pieces = [ring]
        for prev in polys:
            nxt = []
            for p in pieces:
                nxt.extend(host_clip.difference(p, prev))
            pieces = nxt
        polys.extend(pieces)
    return topography_from_polys(polys, V=V, dtype=dtype, device=device)


def topography_from_polys(polys, V: int = 32, *, dtype,
                          device=None) -> TopographyField:
    device = resolve_device(device)
    T = len(polys)
    verts = np.zeros((T, V, 2))
    nverts = np.zeros((T,), np.int32)
    for i, p in enumerate(polys):
        verts[i], nverts[i] = pad_polygon_np(p, V)
    verts_t = torch.as_tensor(verts, dtype=dtype, device=device)
    nverts_t = torch.as_tensor(nverts, device=device)
    # T == 0 gives empty [0, 2] / [0] results from the same expressions
    cent = poly_centroid(verts_t, nverts_t)
    return TopographyField(
        verts=verts_t, nverts=nverts_t, centroid=cent,
        rmax=max_radius(verts_t, nverts_t, cent),
        area=poly_area(verts_t, nverts_t),
    )


def empty_topography(V: int = 32, *, dtype, device=None) -> TopographyField:
    return topography_from_polys([], V=V, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Domain:
    kinds: Tuple[int, int, int, int]   # BoundaryKind per [N, S, E, W]
    vals: torch.Tensor                 # [4] wall edge coordinate [N, S, E, W]
    velocities: torch.Tensor           # [4, 2] (u, v) per wall (MOVING only)
    topography: TopographyField

    @property
    def ns_periodic(self) -> bool:
        return (
            self.kinds[NORTH] == BoundaryKind.PERIODIC
            and self.kinds[SOUTH] == BoundaryKind.PERIODIC
        )

    @property
    def ew_periodic(self) -> bool:
        return (
            self.kinds[EAST] == BoundaryKind.PERIODIC
            and self.kinds[WEST] == BoundaryKind.PERIODIC
        )

    def update_boundaries(self, dt) -> "Domain":
        """Advance MOVING walls by their velocities (boundaries.jl:526-544:
        N/S walls move by v, E/W walls by u)."""
        if not any(k == BoundaryKind.MOVING for k in self.kinds):
            return self
        # which walls move is known on the host: a wall that does not move
        # adds zero, and nothing is uploaded (the step stays capturable)
        vel = self.velocities
        zero = vel.new_zeros(())
        delta = torch.stack([
            vel[w, comp] * dt if k == BoundaryKind.MOVING else zero
            for w, (k, comp) in enumerate(zip(self.kinds, (1, 1, 0, 0)))
        ])
        return dataclasses.replace(self, vals=self.vals + delta)


def make_domain(
    grid: RegRectilinearGrid,
    north: BoundaryKind,
    south: BoundaryKind,
    east: BoundaryKind,
    west: BoundaryKind,
    topography: TopographyField | None = None,
    velocities=None,
    topo_V: int = 32,
    *,
    dtype,
    device=None,
) -> Domain:
    """Build a Domain; validates periodic pairing like the reference
    (domains.jl:19-31).  ``device=None`` is the card."""
    device = resolve_device(device)
    for a, b, name in ((north, south, "north/south"), (east, west, "east/west")):
        if (a == BoundaryKind.PERIODIC) != (b == BoundaryKind.PERIODIC):
            raise ValueError(
                f"{name} boundary pair must both be periodic or both not"
            )
    vals = torch.tensor(
        [grid.yf, grid.y0, grid.xf, grid.x0], dtype=dtype, device=device
    )
    if velocities is None:
        vel = torch.zeros((4, 2), dtype=dtype, device=device)
    else:
        vel = torch.as_tensor(velocities, dtype=dtype, device=device)
    topo = (
        topography if topography is not None
        else empty_topography(topo_V, dtype=dtype, device=device)
    )
    return Domain(
        kinds=(int(north), int(south), int(east), int(west)),
        vals=vals,
        velocities=vel,
        topography=topo,
    )


def wall_rect(domain: Domain, which: int, V: int, dtype):
    """Padded rectangle polygon of one wall, rebuilt from current vals
    (_boundary_info_from_extent, boundaries.jl:29-141): each wall is a
    half-domain-width overlapping rectangle just outside the domain edge.
    Returns ([V, 2] ring, vertex count 4)."""
    n, s, e, w = domain.vals.unbind()
    hx = (e - w) / 2
    hy = (n - s) / 2
    if which == NORTH:
        x0, x1, y0, y1 = w - hx, e + hx, n, n + hy
    elif which == SOUTH:
        x0, x1, y0, y1 = w - hx, e + hx, s - hy, s
    elif which == EAST:
        x0, x1, y0, y1 = e, e + hx, s - hy, n + hy
    else:
        x0, x1, y0, y1 = w - hx, w, s - hy, n + hy
    base = torch.stack(
        [
            torch.stack([x0, y0]),
            torch.stack([x1, y0]),
            torch.stack([x1, y1]),
            torch.stack([x0, y1]),
        ]
    ).to(dtype)
    pad = base[3:4].expand(V - 4, 2)
    return torch.cat([base, pad], dim=0), 4
