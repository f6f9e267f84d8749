"""The inputs of a run, made from ``--seed`` by the benchmark itself: the
initial floe polygons (a NumPy Voronoi tessellation at the configuration's
floe count and concentration), the grid's ocean and atmosphere fields, and
the seeds of the life-cycle generator and of the floe builder.  The program
and the reference are handed the same inputs.

The tessellation is a copy of ``subzero_tpu_torch/core/init.py``'s
(``voronoi_cells_in_box`` and its helpers), so that a change to the program
leaves the benchmark's fields as they are; the field is drawn as the
program's ``initialize_floe_field`` draws one concentration cell over an
open box (``ceil(count / concentration)`` seeds, their Voronoi cells in a
random order, each shrunk about its centroid by ``shrink_frac``), but keeps
exactly ``count`` cells where the program keeps cells until their area
passes the concentration: the concentration is met on average, and every
seed gives a field of the same size, so that seeds change the field and
not the work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEAREST = 64  # a cell is settled after ~15 neighbours


@dataclasses.dataclass
class Inputs:
    coords: list            # [n] rings, each [k, 2] float64, CCW
    u_ocean: np.ndarray     # [Nx + 1, Ny + 1]
    lifecycle_seed: int     # the run's numpy Generator (``Simulation.seed``)
    floe_seed: int          # the floe builder's Generator


def grid_points(cfg) -> tuple:
    """(Nx + 1, Ny + 1): the grid's points along x and y."""
    (x0, x1), (y0, y1) = cfg["domain"]["x"], cfg["domain"]["y"]
    nx = int(round((x1 - x0) / cfg["grid"]["dx"]))
    ny = int(round((y1 - y0) / cfg["grid"]["dy"]))
    return nx + 1, ny + 1


def ocean_u(cfg) -> np.ndarray:
    """The ocean's u on the grid's points: a constant, or a profile across
    y that rises linearly from ``ends`` to ``peak`` over the first ``rise``
    points and falls back over the rest (shear_flow.jl's 0 -> 0.5 -> 0)."""
    npx, npy = grid_points(cfg)
    u = cfg["ocean"]["u"]
    if isinstance(u, (int, float)):
        return np.full((npx, npy), float(u))
    rise = int(u["rise"])
    prof = np.concatenate([np.linspace(u["ends"], u["peak"], rise),
                           np.linspace(u["peak"], u["ends"], npy - rise)])
    return np.broadcast_to(prof[None, :], (npx, npy)).copy()


def seeds(seed: int) -> dict:
    """Independent generators' seeds drawn from ``--seed`` (any whole
    number; taken modulo 2**64)."""
    ss = np.random.SeedSequence(int(seed) % 2**64)
    tess, life, floe, sample = ss.spawn(4)
    return {"tessellation": np.random.default_rng(tess),
            "lifecycle_seed": int(np.random.default_rng(life).integers(2**31)),
            "floe_seed": int(np.random.default_rng(floe).integers(2**31)),
            "sample": np.random.default_rng(sample)}


def make_inputs(cfg, seed: int) -> Inputs:
    s = seeds(seed)
    fl = cfg["floes"]
    (x0, x1), (y0, y1) = cfg["domain"]["x"], cfg["domain"]["y"]
    coords = floe_polygons(fl["count"], fl["concentration"], (x0, y0), (x1, y1),
                           fl["shrink_frac"], fl["min_area"], s["tessellation"])
    return Inputs(coords=coords, u_ocean=ocean_u(cfg),
                  lifecycle_seed=s["lifecycle_seed"], floe_seed=s["floe_seed"])


def floe_polygons(count, conc, lo, hi, shrink_frac, min_area, rng) -> list:
    """``count`` Voronoi floes over the box ``lo``-``hi`` at concentration
    ``conc``: ``ceil(count / conc)`` cells, of which the first ``count``
    in a random order whose area passes ``min_area`` (the floe builder's
    least area, with the shrink's room), so every seed gives a field of the
    same size."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    size = hi - lo
    ncells = int(np.ceil(count / conc))
    pts = np.stack([rng.random(ncells), rng.random(ncells)], axis=-1)
    cells = [c * size + lo for c in voronoi_cells_in_box(pts, np.zeros(2), np.ones(2))]
    polys = [cells[i] for i in rng.permutation(len(cells))
             if ring_area(cells[i]) * (1.0 - shrink_frac) ** 2 > 1.001 * min_area][:count]
    if len(polys) < count:
        raise ValueError(f"{len(polys)} cells of the least area, {count} asked for")
    out = []
    for p in polys:
        c = ring_centroid(p)
        out.append(c + (p - c) * (1.0 - shrink_frac))
    return out


def ring_area(p) -> float:
    x, y = p[:, 0], p[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def ring_centroid(p) -> np.ndarray:
    x, y = p[:, 0], p[:, 1]
    cr = x * np.roll(y, -1) - np.roll(x, -1) * y
    a = 0.5 * cr.sum()
    return np.array([((x + np.roll(x, -1)) * cr).sum() / (6 * a),
                     ((y + np.roll(y, -1)) * cr).sum() / (6 * a)])


def voronoi_cells_in_box(seeds_xy, box_lo, box_hi):
    """Convex Voronoi cells of the seeds clipped to an axis-aligned box, by
    half-plane clipping against the bisectors of the nearest seeds first,
    stopping once no further bisector can reach the cell."""
    seeds_xy = np.asarray(seeds_xy, float)
    sx, sy = seeds_xy[:, 0].copy(), seeds_xy[:, 1].copy()
    cells = []
    for i in range(len(seeds_xy)):
        cell = np.array([[box_lo[0], box_lo[1]], [box_hi[0], box_lo[1]],
                         [box_hi[0], box_hi[1]], [box_lo[0], box_hi[1]]])
        si = seeds_xy[i]
        dx, dy = sx - si[0], sy - si[1]
        d = np.sqrt(dx * dx + dy * dy)
        for j in _by_distance(d, NEAREST):
            if j == i:
                continue
            if len(cell) < 3:
                break
            rmax2 = ((cell - si) ** 2).sum(axis=1).max()
            if d[j] * d[j] >= 4.0 * rmax2:
                break  # all later bisectors miss the cell
            nvec = seeds_xy[j] - si
            cell = _clip_halfplane(cell, nvec, 0.5 * (si + seeds_xy[j]))
        if len(cell) >= 3:
            cells.append(cell)
    return cells


def _by_distance(d, m):
    """The indices of ``d`` in ``np.argsort``'s order, the first ``m`` from
    a partial sort where that order is unambiguous."""
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
    """Sutherland-Hodgman clip of ``poly`` to {x : n.(x - m) <= 0}."""
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
