"""Batched fixed-shape polygon primitives (port of
``subzero_tpu/geometry/polygon.py``).

Polygons are padded vertex rings: a tensor ``v`` of shape ``[..., V, 2]``
with vertex counts ``n`` of shape ``[...]`` (``n <= V``).  Rings are open
(the closing edge ``v[n-1] -> v[0]`` is implicit) and counter-clockwise;
every function masks on ``n``, so padding content is irrelevant.  Where the
reference writes one ring and relies on ``vmap``, these functions take the
batch dimensions directly.
"""

from __future__ import annotations


import numpy as np
import torch

from ..device import resolve_device


def edge_mask(n, V):
    """Boolean [..., V] mask of valid edges for rings with n vertices."""
    return torch.arange(V, device=n.device) < n[..., None]


def close_ring(v, n):
    """Per-edge endpoints (a, b) of the closed rings: ``a[i] = v[i]``,
    ``b[i] = v[(i+1) % n]`` for valid ``i < n``; padded edges collapse onto
    the last valid vertex (degenerate)."""
    V = v.shape[-2]
    idx = torch.arange(V, device=v.device)
    nn = n[..., None].long()
    last = torch.clamp(nn - 1, min=0)
    cur = torch.minimum(idx, last)
    nxt = torch.where(
        idx < nn,
        torch.where(idx == nn - 1, 0, torch.minimum(idx + 1, last)),
        last,
    )
    cur = cur.expand(v.shape[:-1])
    nxt = nxt.expand(v.shape[:-1])
    a = torch.gather(v, -2, cur[..., None].expand(v.shape))
    b = torch.gather(v, -2, nxt[..., None].expand(v.shape))
    return a, b


def signed_area(v, n):
    """Signed area via the shoelace formula (CCW positive)."""
    a, b = close_ring(v, n)
    cross = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    m = edge_mask(n, v.shape[-2])
    return 0.5 * torch.sum(torch.where(m, cross, 0.0), dim=-1)


def poly_area(v, n):
    return torch.abs(signed_area(v, n))


def poly_centroid(v, n):
    """Area centroid of the polygon (assumes CCW non-degenerate)."""
    a, b = close_ring(v, n)
    cross = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    m = edge_mask(n, v.shape[-2])
    cross = torch.where(m, cross, 0.0)
    A = 0.5 * torch.sum(cross, dim=-1)
    cx = torch.sum((a[..., 0] + b[..., 0]) * cross, dim=-1) / (6.0 * A)
    cy = torch.sum((a[..., 1] + b[..., 1]) * cross, dim=-1) / (6.0 * A)
    return torch.stack([cx, cy], dim=-1)


def poly_moment_inertia(v, n, centroid, height, rho_i=920.0):
    """Mass moment of inertia about the centroid (floe_utils.jl:273-298),
    including the reference's double centroid shift inside ``w_i``
    (PARITY.md): the points are shifted by the centroid, and ``w_i`` shifts
    them by it once more."""
    c = centroid
    a, b = close_ring(v, n)
    x1, y1 = a[..., 0] - c[..., 0:1], a[..., 1] - c[..., 1:2]
    x2, y2 = b[..., 0] - c[..., 0:1], b[..., 1] - c[..., 1:2]
    xc, yc = c[..., 0:1], c[..., 1:2]
    w = (x1 - xc) * (y2 - yc) - (x2 - xc) * (y1 - yc)
    m = edge_mask(n, v.shape[-2])
    w = torch.where(m, w, 0.0)
    Ixx = torch.sum(w * (y1 * y1 + y1 * y2 + y2 * y2), dim=-1) / 12.0
    Iyy = torch.sum(w * (x1 * x1 + x1 * x2 + x2 * x2), dim=-1) / 12.0
    return torch.abs(Ixx + Iyy) * height * rho_i


def max_radius(v, n, centroid):
    """Distance from centroid to the farthest valid vertex."""
    d2 = torch.sum((v - centroid[..., None, :]) ** 2, dim=-1)
    m = edge_mask(n, v.shape[-2])
    d2 = torch.where(m, d2, -torch.inf)
    return torch.sqrt(torch.amax(d2, dim=-1))


def point_in_polygon(p, v, n, include_boundary=True):
    """Crossing-number test of points p [..., 2] against rings v [..., V, 2]
    (even/odd rule on a ray in +x).  ``include_boundary`` also counts points
    within a small relative tolerance of an edge as inside."""
    a, b = close_ring(v, n)
    m = edge_mask(n, v.shape[-2])
    px = p[..., None, 0]
    py = p[..., None, 1]
    ax, ay = a[..., 0], a[..., 1]
    bx, by = b[..., 0], b[..., 1]
    cond = (ay > py) != (by > py)
    t = (py - ay) / torch.where(by == ay, 1.0, by - ay)
    xint = ax + t * (bx - ax)
    crossings = torch.sum(cond & m & (px < xint), dim=-1)
    inside = (crossings % 2) == 1
    if include_boundary:
        dx, dy = bx - ax, by - ay
        crs = (px - ax) * dy - (py - ay) * dx
        seg_len2 = dx * dx + dy * dy
        scale = torch.sqrt(torch.clamp(seg_len2, min=1e-30))
        dot = (px - ax) * dx + (py - ay) * dy
        on_edge = (
            (torch.abs(crs) <= 1e-9 * torch.clamp(scale, min=1.0) * scale)
            & (dot >= -1e-9 * seg_len2)
            & (dot <= seg_len2 * (1 + 1e-9))
        )
        inside = inside | torch.any(on_edge & m, dim=-1)
    return inside


def pad_polygon(coords, V, *, dtype, device=None):
    """Host helper: list/array of [n, 2] -> (padded [V, 2], n int32 scalar).

    Drops a repeated closing vertex if present.  Pads by repeating the last
    vertex.  ``device=None`` is the card."""
    device = resolve_device(device)
    out, n = pad_polygon_np(coords, V)
    return (torch.as_tensor(out, dtype=dtype, device=device),
            torch.tensor(n, dtype=torch.int32, device=device))


def pad_polygon_np(coords, V):
    """``pad_polygon`` on the host: (padded float64 [V, 2] array, n)."""
    c = np.asarray(coords, dtype=np.float64)
    if c.ndim != 2 or c.shape[-1] != 2:
        raise ValueError(f"expected [n,2] coords, got {c.shape}")
    if len(c) > 1 and np.allclose(c[0], c[-1]):
        c = c[:-1]
    # drop duplicate adjacent vertices (valid_ringvec! analog)
    keep = np.ones(len(c), dtype=bool)
    for i in range(1, len(c)):
        if np.allclose(c[i], c[i - 1]):
            keep[i] = False
    c = c[keep]
    n = len(c)
    if n > V:
        raise ValueError(f"polygon has {n} vertices > capacity {V}")
    if n < 3:
        raise ValueError("polygon needs at least 3 distinct vertices")
    pad = np.repeat(c[-1:], V - n, axis=0)
    return np.concatenate([c, pad], axis=0), n


def rotate_about(v, center, angle):
    """Rotate points v [..., V, 2] by angle [...] about center [..., 2]."""
    ca, sa = torch.cos(angle), torch.sin(angle)
    d = v - center[..., None, :]
    x = ca[..., None] * d[..., 0] - sa[..., None] * d[..., 1]
    y = sa[..., None] * d[..., 0] + ca[..., None] * d[..., 1]
    return torch.stack([x, y], dim=-1) + center[..., None, :]


