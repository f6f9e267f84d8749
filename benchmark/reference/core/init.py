"""Floe-field initialization (port of ``subzero_tpu/core/init.py``).

Host-side (setup-time) equivalents of the reference's
``initialize_floe_field`` (floe.jl:321-634), numpy throughout and driven by
the same numpy ``Generator`` as the JAX package, so both build the same
floe field from the same seed:

  * from explicit polygon coordinates (subtracting topography), and
  * from a target floe count + concentration matrix via Voronoi
    tessellation with rejection-sampled seeds.

Voronoi cells are built by half-plane clipping against perpendicular
bisectors (no external tessellation dependency), then intersected with the
open-water region exactly as the reference does.
"""

from __future__ import annotations

import numpy as np

from ..geometry import host_clip
from ..settings import FloeSettings
from .domain import Domain, NORTH, SOUTH, EAST, WEST
from .floes import FloeState, build_floes


def _np(x):
    return x.detach().cpu().double().numpy()


def _domain_box(domain: Domain):
    vals = _np(domain.vals)
    n, s, e, w = vals[NORTH], vals[SOUTH], vals[EAST], vals[WEST]
    return np.array([[w, s], [e, s], [e, n], [w, n]])


def _topo_rings(domain: Domain):
    rings = []
    T = domain.topography.count
    verts = _np(domain.topography.verts)
    nv = domain.topography.nverts.cpu().numpy()
    for t in range(T):
        rings.append(verts[t, : nv[t]])
    return rings


def _subtract_topo(pieces, topo_rings):
    for tr in topo_rings:
        nxt = []
        for p in pieces:
            nxt.extend(host_clip.difference(p, tr))
        pieces = nxt
    return pieces


def initialize_floe_field_coords(
    coords_list,
    domain: Domain,
    hmean,
    dh,
    floe_settings: FloeSettings = FloeSettings(min_floe_area=0.0),
    rng=None,
    **kwargs,
) -> FloeState:
    """Floes from explicit polygon coordinates (floe.jl:361-411).

    Each entry of ``coords_list`` is either a single exterior ring or a
    PolyVec-style [exterior, hole1, ...] list; polygons with holes are split
    around each hole (poly_to_floes!, floe.jl:274-311: the host difference
    cuts horizontally through a contained hole's centroid) so every
    resulting floe is a simple polygon."""
    if rng is None:
        rng = np.random.default_rng(1)
    topo = _topo_rings(domain)
    pieces = []
    for c in coords_list:
        try:
            a = np.asarray(c, float)
            rings = [a] if a.ndim == 2 else [np.asarray(r, float) for r in c]
        except ValueError:  # ragged [exterior, hole...] list
            rings = [np.asarray(r, float) for r in c]
        parts = [host_clip._clean_ring(rings[0])]
        for hole in rings[1:]:
            hring = host_clip._clean_ring(hole)
            parts = [
                q for p in parts for q in host_clip.difference(p, hring)
            ]
        parts = _subtract_topo(parts, topo)
        for p in parts:
            if host_clip.poly_area_np(p) >= floe_settings.min_floe_area:
                pieces.append(p)
    return build_floes(pieces, hmean, dh, floe_settings, rng, **kwargs)


def voronoi_cells_in_box(seeds, box_lo, box_hi):
    """Convex Voronoi cells of seeds clipped to an axis-aligned box.

    Built by successive half-plane clipping against perpendicular bisectors,
    visiting neighbors in increasing-distance order with an early exit: once
    every cell vertex lies within d_j / 2 of the seed, the bisector of any
    seed at distance >= d_j cannot cut the cell, so the remaining seeds are
    skipped.  Exact same cells as the naive O(k^2) sweep (skipped clips are
    provably no-ops) but ~O(k * m) with m ~ 10-20 actual neighbors - the
    naive version took hours at k = 8000.  The neighbours come in
    ``np.argsort``'s order from a partial sort (``_by_distance``), so the
    cells are the full sort's to the bit, in a third of its time at
    k = 32 000.
    """
    seeds = np.asarray(seeds, float)
    k = len(seeds)
    sx, sy = seeds[:, 0].copy(), seeds[:, 1].copy()
    cells = []
    for i in range(k):
        cell = np.array(
            [
                [box_lo[0], box_lo[1]],
                [box_hi[0], box_lo[1]],
                [box_hi[0], box_hi[1]],
                [box_lo[0], box_hi[1]],
            ]
        )
        si = seeds[i]
        dx, dy = sx - si[0], sy - si[1]
        d = np.sqrt(dx * dx + dy * dy)  # np.linalg.norm(seeds - si, axis=1)
        for j in _by_distance(d, NEAREST):
            if j == i:
                continue
            if len(cell) < 3:
                break
            rmax2 = ((cell - si) ** 2).sum(axis=1).max()
            if d[j] * d[j] >= 4.0 * rmax2:
                break  # all later bisectors miss the cell
            sj = seeds[j]
            # keep points closer to si than sj: n.(x - m) <= 0 with
            # n = sj - si, m = midpoint
            nvec = sj - si
            m = 0.5 * (si + sj)
            cell = _clip_halfplane(cell, nvec, m)
        if len(cell) >= 3:
            cells.append(cell)
    return cells


NEAREST = 64  # a cell is settled after ~15 neighbours (initialize_floe_field)


def _by_distance(d, m):
    """The indices of ``d`` in increasing order, as ``np.argsort(d)`` gives
    them.  The first ``m`` come from a partial sort, as the caller stops
    after a few; the full sort is taken where the partial one could order a
    tie otherwise, and for the indices past the first ``m``."""
    if len(d) > m:
        head = np.argpartition(d, m - 1)[:m]
        head = head[np.argsort(d[head])]
        dh = d[head]
        if np.all(dh[1:] > dh[:-1]) and np.count_nonzero(d <= dh[-1]) == m:
            yield from head
            yield from np.argsort(d)[m:]
            return
    yield from np.argsort(d)


def _clip_halfplane(poly, nvec, m):
    """Sutherland-Hodgman clip of poly to {x : n.(x-m) <= 0}."""
    out = []
    k = len(poly)
    d = (poly - m) @ nvec
    for i in range(k):
        j = (i + 1) % k
        di, dj = d[i], d[j]
        if di <= 0:
            out.append(poly[i])
        if (di < 0) != (dj < 0) and di != dj:
            t = di / (di - dj)
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out) if out else np.zeros((0, 2))


def generate_voronoi_coords(
    desired_points: int,
    scale_fac,
    trans_vec,
    domain_rings,
    rng,
    max_tries: int = 10,
):
    """Rejection-sample seeds inside domain_rings (in the unit square scaled
    by scale_fac + trans_vec), then Voronoi-tessellate the unit square
    (floe.jl:445-506)."""
    total_area = sum(abs(host_clip.poly_area_np(r)) for r in domain_rings)
    box_area = float(scale_fac[0] * scale_fac[1])
    area_frac = max(total_area / box_area, 1e-9)
    npoints = int(np.ceil(desired_points / area_frac))
    xs, ys = [], []
    tries = 0
    while len(xs) < desired_points and tries <= max_tries:
        x = rng.random(npoints)
        y = rng.random(npoints)
        wx = scale_fac[0] * x + trans_vec[0]
        wy = scale_fac[1] * y + trans_vec[1]
        for xi_, yi_, wxi, wyi in zip(x, y, wx, wy):
            if any(host_clip._point_in((wxi, wyi), r) for r in domain_rings):
                xs.append(xi_)
                ys.append(yi_)
        tries += 1
    xs = xs[:desired_points]
    ys = ys[:desired_points]
    if len(xs) <= 1:
        return []
    seeds = np.stack([np.asarray(xs), np.asarray(ys)], axis=-1)
    cells = voronoi_cells_in_box(seeds, np.zeros(2), np.ones(2))
    out = []
    for c in cells:
        scaled = c * np.asarray(scale_fac) + np.asarray(trans_vec)
        out.append(scaled)
    return out


def initialize_floe_field(
    nfloes: int,
    concentrations,
    domain: Domain,
    hmean,
    dh,
    floe_settings: FloeSettings = FloeSettings(min_floe_area=0.0),
    rng=None,
    shrink_frac: float = 1e-4,
    floe_bounds=None,
    **kwargs,
) -> FloeState:
    """Voronoi floe field with per-cell concentrations (floe.jl:548-634).

    ``shrink_frac``: each floe is contracted about its centroid by this
    fraction so adjacent Voronoi cells start with a hairline gap instead of
    exactly shared (degenerate) edges. The reference leaves cells flush -
    identical physics (zero contact force either way), but the gap keeps
    the t=0 contact list from being flooded with degenerate sliver pairs.

    ``floe_bounds``: optional polygon ring restricting floe placement to a
    sub-region of the domain (the reference's floe_bounds keyword, used by
    examples/forcing_contained_floes.jl).
    """
    if rng is None:
        rng = np.random.default_rng(1)
    conc = np.atleast_2d(np.asarray(concentrations, float))
    box = _domain_box(domain)
    topo = _topo_rings(domain)
    open_water = _subtract_topo([box], topo)
    if floe_bounds is not None:
        b = np.asarray(floe_bounds, float)
        if b.ndim == 3:
            b = b[0]
        bring = host_clip._clean_ring(b)
        bounded = []
        for p in open_water:
            bounded.extend(host_clip.intersect(p, bring))
        open_water = bounded
    open_water_area = sum(host_clip.poly_area_np(p) for p in open_water)

    lo = box.min(0)
    hi = box.max(0)
    nrows, ncols = conc.shape
    rowlen = (hi[1] - lo[1]) / nrows
    collen = (hi[0] - lo[0]) / ncols

    floes_polys = []
    for j in range(ncols):
        for i in range(nrows):
            c = float(conc[i, j])
            if c <= 0:
                continue
            c = min(c, 1.0)
            xmin = lo[0] + collen * j
            ymin = lo[1] + rowlen * i
            cell = np.array(
                [
                    [xmin, ymin],
                    [xmin + collen, ymin],
                    [xmin + collen, ymin + rowlen],
                    [xmin, ymin + rowlen],
                ]
            )
            open_cell = []
            for ow in open_water:
                open_cell.extend(host_clip.intersect(cell, ow))
            open_area = sum(host_clip.poly_area_np(p) for p in open_cell)
            if open_area <= 0:
                continue
            ncells = int(np.ceil(nfloes * open_area / open_water_area / c))
            cells = generate_voronoi_coords(
                ncells, [collen, rowlen], [xmin, ymin], open_cell, rng
            )
            if not cells:
                continue
            order = rng.permutation(len(cells))
            floes_area = 0.0
            for idx in order:
                if floes_area / open_area > c:
                    break
                pieces = []
                for oc in open_cell:
                    pieces.extend(host_clip.intersect(cells[idx], oc))
                for p in pieces:
                    a = host_clip.poly_area_np(p)
                    if a >= floe_settings.min_floe_area and a > 0:
                        floes_polys.append(p)
                        floes_area += a
    if shrink_frac > 0:
        shrunk = []
        for p in floes_polys:
            c = host_clip.poly_centroid_np(p)
            shrunk.append(c + (p - c) * (1.0 - shrink_frac))
        floes_polys = shrunk
    return build_floes(floes_polys, hmean, dh, floe_settings, rng, **kwargs)
