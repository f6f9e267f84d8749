"""The floe pool: fixed-capacity SoA state for all floes.

Port of ``subzero_tpu/core/floes.py``: every per-floe field is a padded
tensor over a static pool capacity ``N``; polygon vertices are padded rings
``[N, V, 2]``; sub-floe quadrature points are padded ``[N, P]`` in the floe
body frame.  Status is boolean masks (``active`` plus ``remove``/``fuse``
flags).  The host setup (sub-floe points, polygon integrals) is the
reference's numpy code, driven by the same numpy ``Generator`` so both
packages build the same pool from the same seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..settings import FloeSettings, MonteCarloPointsGenerator, SubGridPointsGenerator


class FloeState(NamedTuple):
    # shape/physical properties ------------------------------------------
    verts: torch.Tensor       # [N, V, 2] world-frame CCW rings (padded)
    nverts: torch.Tensor      # [N] int32
    centroid: torch.Tensor    # [N, 2]
    height: torch.Tensor      # [N]
    area: torch.Tensor        # [N]
    mass: torch.Tensor        # [N]
    rmax: torch.Tensor        # [N]
    moment: torch.Tensor      # [N]
    # sub-floe quadrature points (body frame, centered on centroid) -------
    sub_x: torch.Tensor       # [N, P]
    sub_y: torch.Tensor       # [N, P]
    nsub: torch.Tensor        # [N] int32
    # kinematics ----------------------------------------------------------
    alpha: torch.Tensor       # [N] rotation since creation
    u: torch.Tensor           # [N]
    v: torch.Tensor           # [N]
    xi: torch.Tensor          # [N] angular velocity
    # identity / status ---------------------------------------------------
    active: torch.Tensor      # [N] bool - slot holds a live floe
    remove: torch.Tensor      # [N] bool - marked for removal
    fuse_with: torch.Tensor   # [N] int32 - pool index to fuse with, -1 = none
    id: torch.Tensor          # [N] int32 unique floe id (0 = empty slot)
    parent_id: torch.Tensor   # [N] int32 id of parent floe (0 = none)
    # forces / collisions -------------------------------------------------
    fx_oa: torch.Tensor       # [N] ocean+atmos force
    fy_oa: torch.Tensor
    trq_oa: torch.Tensor
    hflx_factor: torch.Tensor
    overarea: torch.Tensor
    collision_force: torch.Tensor  # [N, 2]
    collision_trq: torch.Tensor    # [N]
    stress_accum: torch.Tensor     # [N, 2, 2]
    stress_instant: torch.Tensor   # [N, 2, 2]
    strain: torch.Tensor           # [N, 2, 2]
    damage: torch.Tensor           # [N]
    # previous-step tendencies (semi-implicit integrator) ----------------
    p_dxdt: torch.Tensor
    p_dydt: torch.Tensor
    p_dudt: torch.Tensor
    p_dvdt: torch.Tensor
    p_dxidt: torch.Tensor
    p_dalphadt: torch.Tensor

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.verts.shape[0]

    @property
    def max_verts(self) -> int:
        return self.verts.shape[1]

    @property
    def max_sub(self) -> int:
        return self.sub_x.shape[1]

    def count(self):
        return torch.sum(self.active.to(torch.int32))

    def to(self, device=None, dtype=None) -> "FloeState":
        """Move the pool to ``device``; floating fields cast to ``dtype``."""
        return FloeState(*(
            x.to(device=device, dtype=dtype) if x.is_floating_point()
            else x.to(device=device)
            for x in self
        ))


def empty_floes(N: int, V: int = 32, P: int = 1024, *, dtype,
                device=None) -> FloeState:
    device = resolve_device(device)

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    def zi(*s):
        return torch.zeros(s, dtype=torch.int32, device=device)

    return FloeState(
        verts=z(N, V, 2),
        nverts=zi(N),
        centroid=z(N, 2),
        height=z(N),
        area=z(N),
        mass=z(N),
        rmax=z(N),
        moment=z(N),
        sub_x=z(N, P),
        sub_y=z(N, P),
        nsub=zi(N),
        alpha=z(N),
        u=z(N),
        v=z(N),
        xi=z(N),
        active=torch.zeros((N,), dtype=torch.bool, device=device),
        remove=torch.zeros((N,), dtype=torch.bool, device=device),
        fuse_with=torch.full((N,), -1, dtype=torch.int32, device=device),
        id=zi(N),
        parent_id=zi(N),
        fx_oa=z(N),
        fy_oa=z(N),
        trq_oa=z(N),
        hflx_factor=z(N),
        overarea=z(N),
        collision_force=z(N, 2),
        collision_trq=z(N),
        stress_accum=z(N, 2, 2),
        stress_instant=z(N, 2, 2),
        strain=z(N, 2, 2),
        damage=z(N),
        p_dxdt=z(N),
        p_dydt=z(N),
        p_dudt=z(N),
        p_dvdt=z(N),
        p_dxidt=z(N),
        p_dalphadt=z(N),
    )


# ---------------------------------------------------------------------------
# sub-floe point generation (host, setup-time)
# ---------------------------------------------------------------------------

def _point_in_ring_np(px, py, ring):
    """Vectorized even-odd point-in-polygon for numpy points."""
    x1 = ring[:, 0]
    y1 = ring[:, 1]
    x2 = np.roll(x1, -1)
    y2 = np.roll(y1, -1)
    px = np.asarray(px)[:, None]
    py = np.asarray(py)[:, None]
    cond = (y1 > py) != (y2 > py)
    denom = np.where(y2 == y1, 1.0, y2 - y1)
    xint = x1 + (py - y1) / denom * (x2 - x1)
    return (np.sum(cond & (px < xint), axis=1) % 2) == 1


def generate_mc_points(ring, area, gen: MonteCarloPointsGenerator, rng):
    """Monte-Carlo sub-floe points (coupling.jl:172-208).

    ``ring``: [n,2] vertices translated so the centroid is at the origin.
    Returns (x, y) arrays of accepted points, or (None, None) on failure
    (the floe should then be marked remove).
    """
    xmin, ymin = ring.min(0)
    xmax, ymax = ring.max(0)
    dx, dy = xmax - xmin, ymax - ymin
    for _ in range(gen.ntries):
        mx = xmin + dx * rng.random(gen.npoints)
        my = ymin + dy * rng.random(gen.npoints)
        inside = _point_in_ring_np(mx, my, ring)
        err = abs(inside.mean() * (dx * dy) - area) / area
        if err <= gen.err:
            if not inside.any():
                return None, None
            return mx[inside], my[inside]
    return None, None


def generate_subgrid_points(ring, dg):
    """Deterministic edge+interior lattice points (coupling.jl:235-321).

    ``ring``: [n,2] vertices translated so the centroid is at the origin.
    """
    xs, ys = [], []
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        dx, dy = x2 - x1, y2 - y1
        ell = math.hypot(dx, dy)
        xs.append(x1)
        ys.append(y1)
        if ell <= 2 * dg:
            if ell > dg:
                xs.append(x1 + dx / 2)
                ys.append(y1 + dy / 2)
        else:
            if dx == 0:
                ya = y1 + dg / 2 * np.sign(dy)
                yb = y2 - dg / 2 * np.sign(dy)
                xa, xb = x1, x2
            elif dy == 0:
                xa = x1 + dg / 2 * np.sign(dx)
                xb = x2 - dg / 2 * np.sign(dx)
                ya, yb = y1, y2
            else:
                m = dy / dx
                xsh = math.sqrt(dg**2 / (4 * (1 + m * m)))
                ysh = m * xsh
                xa, ya = x1 + xsh, y1 + ysh
                xb, yb = x2 - xsh, y2 - ysh
            ell2 = math.hypot(xb - xa, yb - ya)
            ne = int(math.ceil(ell2 / dg)) + 1
            xs.extend(np.linspace(xa, xb, ne))
            ys.extend(np.linspace(ya, yb, ne))
    xmin, ymin = ring.min(0)
    xmax, ymax = ring.max(0)
    n_x = int(math.ceil((xmax - xmin) / dg))
    n_y = int(math.ceil((ymax - ymin) / dg))
    gx = np.linspace(xmin + dg / 2, xmax - dg / 2, n_x) if n_x >= 3 else np.zeros(1)
    if n_x < 3:
        n_x = 1
    gy = np.linspace(ymin + dg / 2, ymax - dg / 2, n_y) if n_y >= 3 else np.zeros(1)
    if n_y < 3:
        n_y = 1
    sx = np.tile(gx, n_y)
    sy = np.repeat(gy, n_x)
    inside = _point_in_ring_np(sx, sy, ring)
    xs.extend(sx[inside])
    ys.extend(sy[inside])
    return np.asarray(xs), np.asarray(ys)


def subfloe_points_for_ring(body, area, gen, rng):
    """Sub-floe quadrature points for one ring (centroid at origin),
    dispatching on the generator and applying SubGridPointsGenerator's
    optional ``max_points`` cap: oversized floes keep a deterministic
    proportional subsample of the natural point set (see settings.py for
    why thinning, not lattice coarsening).

    Returns (x, y) arrays, or (None, None) when generation failed (the
    caller should mark the floe remove, coupling.jl:1507-1508)."""
    if isinstance(gen, SubGridPointsGenerator):
        mx, my = generate_subgrid_points(body, gen.dg)
        cap = gen.max_points
        if cap is not None and len(mx) > cap:
            keep = np.unique(
                np.round(np.linspace(0, len(mx) - 1, cap)).astype(int)
            )
            mx, my = mx[keep], my[keep]
        return (mx, my) if len(mx) > 0 else (None, None)
    return generate_mc_points(body, area, gen, rng)


# ---------------------------------------------------------------------------
# host-side floe construction
# ---------------------------------------------------------------------------

def build_floes(
    polys,
    hmean,
    dh,
    floe_settings: FloeSettings = FloeSettings(),
    rng=None,
    N: int | None = None,
    V: int = 32,
    P: int | None = None,
    u=0.0,
    v=0.0,
    xi=0.0,
    *,
    dtype,
    device=None,
) -> FloeState:
    """Create a FloeState pool from a list of polygon coordinate arrays
    (``device=None``: on the card).

    Mirrors the per-floe initialization of ``Floe{FT}(poly, hmean, dh)``
    (floe.jl:144-196): heights drawn as ``hmean ± U(0,1)*dh`` clamped to the
    settings range, mass/moment from polygon integrals, and sub-floe points
    from the configured generator.
    """
    device = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng(0)
    rows = []
    for c in polys:
        c = np.asarray(c, float)
        if c.ndim == 3:
            c = c[0]
        ring = np.asarray(c, float)
        if len(ring) > 1 and np.allclose(ring[0], ring[-1]):
            ring = ring[:-1]
        # drop duplicate adjacent vertices (valid_ringvec! analog)
        keep = [0]
        for k in range(1, len(ring)):
            if not np.allclose(ring[k], ring[keep[-1]]):
                keep.append(k)
        ring = ring[keep]
        if len(ring) > V:
            raise ValueError(f"floe has {len(ring)} vertices > capacity {V}")
        # CCW orientation
        x, y = ring[:, 0], ring[:, 1]
        if 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) < 0:
            ring = ring[::-1]
        area = abs(
            0.5
            * np.sum(
                ring[:, 0] * np.roll(ring[:, 1], -1)
                - np.roll(ring[:, 0], -1) * ring[:, 1]
            )
        )
        height = float(
            np.clip(
                hmean + (-1) ** rng.integers(0, 2) * rng.random() * dh,
                floe_settings.min_floe_height,
                floe_settings.max_floe_height,
            )
        )
        rows.append((ring, area, height))

    count = len(rows)
    if N is None:
        N = max(count, 1)
    if N < count:
        raise ValueError(f"floe pool capacity {N} < number of floes {count}")

    # sub-floe points first (to size P)
    subs = []
    statuses = []
    for ring, area, height in rows:
        cr = np.asarray(poly_centroid_np(ring))
        body = ring - cr
        gen = floe_settings.subfloe_point_generator
        mx, my = subfloe_points_for_ring(body, area, gen, rng)
        ok = mx is not None
        if not ok:
            mx, my = np.zeros(1), np.zeros(1)
        subs.append((mx, my))
        statuses.append(ok)
    maxp = max((len(s[0]) for s in subs), default=1)
    if P is None:
        P = max(maxp, 1)
    if P < maxp:
        raise ValueError(f"subfloe point capacity {P} < generated {maxp}")

    st = empty_floes(N, V=V, P=P, dtype=dtype, device=device)
    verts = np.zeros((N, V, 2))
    nverts = np.zeros((N,), np.int32)
    sub_x = np.zeros((N, P))
    sub_y = np.zeros((N, P))
    nsub = np.zeros((N,), np.int32)
    height_a = np.zeros((N,))
    cent = np.zeros((N, 2))
    area_a = np.zeros((N,))
    moment_a = np.zeros((N,))
    rmax_a = np.zeros((N,))
    active = np.zeros((N,), bool)
    remove = np.zeros((N,), bool)
    ids = np.zeros((N,), np.int32)

    for i, (ring, area, height) in enumerate(rows):
        n = len(ring)
        verts[i, :n] = ring
        verts[i, n:] = ring[-1]
        nverts[i] = n
        cent[i] = poly_centroid_np(ring)
        area_a[i] = area
        moment_a[i] = moment_inertia_np(ring, cent[i], height, floe_settings.rho_i)
        rmax_a[i] = np.sqrt(((ring - cent[i]) ** 2).sum(axis=1).max())
        mx, my = subs[i]
        sub_x[i, : len(mx)] = mx
        sub_y[i, : len(my)] = my
        nsub[i] = len(mx)
        height_a[i] = height
        active[i] = True
        remove[i] = not statuses[i]
        ids[i] = i + 1

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def ti(x):
        return torch.as_tensor(x, device=device)

    return st._replace(
        verts=t(verts),
        nverts=ti(nverts),
        centroid=t(cent),
        height=t(height_a),
        area=t(area_a),
        mass=t(area_a * height_a * floe_settings.rho_i),
        rmax=t(rmax_a),
        moment=t(moment_a),
        sub_x=t(sub_x),
        sub_y=t(sub_y),
        nsub=ti(nsub),
        active=ti(active),
        remove=ti(remove),
        id=ti(ids),
        u=torch.full((N,), u, dtype=dtype, device=device),
        v=torch.full((N,), v, dtype=dtype, device=device),
        xi=torch.full((N,), xi, dtype=dtype, device=device),
    )


def poly_centroid_np(ring):
    x, y = ring[:, 0], ring[:, 1]
    cr = x * np.roll(y, -1) - np.roll(x, -1) * y
    A = 0.5 * np.sum(cr)
    cx = np.sum((x + np.roll(x, -1)) * cr) / (6 * A)
    cy = np.sum((y + np.roll(y, -1)) * cr) / (6 * A)
    return np.array([cx, cy])


def moment_inertia_np(ring, cent, height, rho_i):
    """Reference _calc_moment_inertia (floe_utils.jl:273-298), including its
    double-centroid-shift quirk (see poly_moment_inertia)."""
    xc, yc = cent
    pts = np.concatenate([ring, ring[:1]], axis=0) - np.asarray(cent)
    x1, y1 = pts[:-1, 0], pts[:-1, 1]
    x2, y2 = pts[1:, 0], pts[1:, 1]
    w = (x1 - xc) * (y2 - yc) - (x2 - xc) * (y1 - yc)
    Ixx = np.sum(w * (y1 * y1 + y1 * y2 + y2 * y2)) / 12.0
    Iyy = np.sum(w * (x1 * x1 + x1 * x2 + x2 * x2)) / 12.0
    return abs(Ixx + Iyy) * height * rho_i
