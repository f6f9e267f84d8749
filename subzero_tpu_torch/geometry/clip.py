"""Fixed-shape batched polygon-polygon intersection (port of
``subzero_tpu/geometry/clip.py``).

For each pair of padded CCW rings the physics needs aggregate quantities,
not intersection polygons: total intersection area and, per overlap region,
area, centroid, crossing count, chord points and the inward-normal sum of
the region boundary lying on the subject polygon P.

  * ``two_cross_pass``: the fused narrow phase for the common case of
    exactly two proper crossings (one region), on a materialised ring batch.
  * ``two_cross_pairs``: the same over ring pools and a candidate pair list
    (gather, ``two_cross_pass``, invalid rows zeroed).  This is the plain
    PyTorch version of the CUDA kernel in ``csrc/two_cross.cu``.
  * ``intersect_regions``: the general multi-region clip (a data-parallel
    Weiler-Atherton: all crossings, ring-order next pointers, cycle labels
    by pointer doubling, per-region line integrals).
  * ``two_cross_dispatch``: CUDA tensors go to the kernel, CPU tensors to
    ``two_cross_pairs``.

Degeneracies (vertex exactly on an edge, collinear overlapping edges) are
broken by a deterministic perturbation of Q along (0.618..., 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .polygon import close_ring, point_in_polygon, signed_area

# Maximum number of boundary crossings tracked per pair by intersect_regions.
DEFAULT_CAP = 16

# Sliver tolerance of the two-crossing fast path (shared with the CUDA
# kernel, which receives it as an argument): a contact whose chained
# shoelace sum S lands slightly NEGATIVE from roundoff on edge-aligned
# contacts is a zero-area fast contact, not a slow-path bounce.
SLIVER_TOL_F32 = 1e-3
SLIVER_TOL_F64 = 1e-10

# Q-offset direction of the degeneracy-breaking perturbation.
PERTURB_X = 0.6180339887498949

# A crossing is proper when both edge parameters lie in (EPS_T, 1 - EPS_T).
EPS_T = 1e-12


def sliver_tol(dtype) -> float:
    return SLIVER_TOL_F64 if dtype == torch.float64 else SLIVER_TOL_F32


def perturb_offset(perturb, K: int, dtype, device):
    """The degeneracy-breaking offset of Q, ``perturb * (PERTURB_X, 1)``, as
    [K, 1, 2] (``perturb`` a scalar or [K]).  Built from Python scalars on
    the device: a constant uploaded from host memory would synchronise the
    host and could not be captured in a CUDA graph."""
    if isinstance(perturb, torch.Tensor):
        pert = perturb.to(dtype=dtype, device=device).expand(K)
    else:
        pert = torch.full((K,), perturb, dtype=dtype, device=device)
    return torch.stack([pert * PERTURB_X, pert], dim=-1)[:, None, :]


def first_true(mask, size: int, fill: int):
    """Row-wise sized nonzero: for mask [..., L] return [..., size] int64 with
    the indices of the first ``size`` True entries in order, padded with
    ``fill`` (``jnp.nonzero(row, size=size, fill_value=fill)`` per row).
    Stays on the device: no host synchronisation."""
    L = mask.shape[-1]
    pos = torch.arange(L, device=mask.device)
    key = torch.where(mask, pos, L)
    if L < size:
        pad = torch.full(mask.shape[:-1] + (size - L,), L, dtype=key.dtype,
                         device=mask.device)
        key = torch.cat([key, pad], dim=-1)
    first = torch.topk(key, size, dim=-1, largest=False, sorted=True).values
    return torch.where(first < L, first, fill)


def _norm2(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


# ---------------------------------------------------------------------------
# general multi-region clip
# ---------------------------------------------------------------------------

class ClipRegions(NamedTuple):
    """Result of intersect_regions for a batch of K pairs; region arrays have
    a trailing capacity axis CAP, valid where ``valid`` is True."""

    total_area: torch.Tensor  # [K] total intersection area
    area: torch.Tensor        # [K, CAP] per-region area
    centroid: torch.Tensor    # [K, CAP, 2]
    n_cross: torch.Tensor     # [K, CAP] boundary crossings in region
    chord_a: torch.Tensor     # [K, CAP, 2] first crossing point of region
    chord_b: torch.Tensor     # [K, CAP, 2] second crossing point
    p_norm: torch.Tensor      # [K, CAP, 2] inward-normal sum over P-chain
    p_len: torch.Tensor       # [K, CAP] total length of P-chain segments
    p_cnt: torch.Tensor       # [K, CAP] number of P-chain segments
    q_cnt: torch.Tensor       # [K, CAP] number of Q-chain segments
    valid: torch.Tensor       # [K, CAP] region validity
    overflow: torch.Tensor    # [K] more crossings than CAP, or odd parity


def _gather1(x, idx):
    """x [K, L] or [K, L, 2] gathered along dim 1 at idx [K, M]."""
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.gather(x, 1, idx)


def _ring_prefix(v, n):
    """Per-edge integral quantities + doubled prefix sums for run queries:
    the sum of a quantity over ``cnt`` full edges starting at edge ``e0``
    (cyclic, cnt <= n) is ``P[e0 + cnt] - P[e0]``.  v [K, V, 2], n [K]."""
    K, V, _ = v.shape
    a, b = close_ring(v, n)
    cr = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    em = torch.arange(V, device=v.device) < n[:, None]
    q_S = torch.where(em, 0.5 * cr, 0.0)
    q_MX = torch.where(em, (a[..., 0] + b[..., 0]) * cr, 0.0)
    q_MY = torch.where(em, (a[..., 1] + b[..., 1]) * cr, 0.0)
    q_LEN = torch.where(em, _norm2(b - a), 0.0)

    idx2 = torch.arange(2 * V, device=v.device)
    nn = n[:, None].long()
    src = idx2 % torch.clamp(nn, min=1)
    valid2 = idx2 < 2 * nn

    def doubled_prefix(q):
        q2 = torch.where(valid2, torch.gather(q, 1, src), 0.0)
        return torch.cat([torch.zeros_like(q2[:, :1]), torch.cumsum(q2, 1)], 1)

    return {
        "a": a,
        "b": b,
        "P_S": doubled_prefix(q_S),
        "P_MX": doubled_prefix(q_MX),
        "P_MY": doubled_prefix(q_MY),
        "P_LEN": doubled_prefix(q_LEN),
    }


def _seg_quantities(p1, p2):
    """Integral quantities of directed segments p1->p2."""
    cr = p1[..., 0] * p2[..., 1] - p2[..., 0] * p1[..., 1]
    S = 0.5 * cr
    MX = (p1[..., 0] + p2[..., 0]) * cr
    MY = (p1[..., 1] + p2[..., 1]) * cr
    return S, MX, MY, _norm2(p2 - p1)


def _arc_quantities(ring, n, Xk, ek, Xk2, ek2, fwd_same_edge):
    """Line integrals over the ring arcs from crossing Xk (on edge ek)
    forward to crossing Xk2 (on edge ek2); [K, CAP] batched.
    Returns (S, MX, MY, LEN, CNT)."""
    nsafe = torch.clamp(n.long(), min=1)[:, None]
    S1, MX1, MY1, LEN1 = _seg_quantities(Xk, Xk2)

    b_ek = _gather1(ring["b"], ek)
    a_ek2 = _gather1(ring["a"], ek2)
    cnt_full = torch.remainder(ek2 - ek - 1, nsafe)
    e0 = torch.remainder(ek + 1, nsafe)

    def run(P):
        return torch.gather(P, 1, e0 + cnt_full) - torch.gather(P, 1, e0)

    Sp1, MXp1, MYp1, LENp1 = _seg_quantities(Xk, b_ek)
    Sp2, MXp2, MYp2, LENp2 = _seg_quantities(a_ek2, Xk2)
    S2 = Sp1 + run(ring["P_S"]) + Sp2
    MX2 = MXp1 + run(ring["P_MX"]) + MXp2
    MY2 = MYp1 + run(ring["P_MY"]) + MYp2
    LEN2 = LENp1 + run(ring["P_LEN"]) + LENp2
    CNT2 = 2 + cnt_full

    S = torch.where(fwd_same_edge, S1, S2)
    MX = torch.where(fwd_same_edge, MX1, MX2)
    MY = torch.where(fwd_same_edge, MY1, MY2)
    LEN = torch.where(fwd_same_edge, LEN1, LEN2)
    CNT = torch.where(fwd_same_edge, 1, CNT2)
    return S, MX, MY, LEN, CNT


def _next_pointers(key, valid):
    """Next-crossing pointers along one ring from sort keys [K, CAP]:
    nxt[k] follows k walking the ring forward (cyclic among valid
    crossings); invalid -> k."""
    K, CAP = key.shape
    ar = torch.arange(CAP, device=key.device).expand(K, CAP)
    keys = torch.where(valid, key, torch.inf)
    order = torch.argsort(keys, dim=1, stable=True)  # valid first, ring order
    Csafe = torch.clamp(valid.sum(1, keepdim=True), min=1)
    pos = torch.zeros_like(order).scatter_(1, order, ar)
    nxt = torch.gather(order, 1, (pos + 1) % Csafe)
    return torch.where(valid, nxt, ar)


def intersect_regions(pv, pn, qv, qn, CAP: int = DEFAULT_CAP, perturb=0.0) -> ClipRegions:
    """Intersection regions of K pairs of padded CCW rings.

    pv [K, V, 2], pn [K], qv [K, W, 2], qn [K]; ``perturb`` (scalar or [K])
    offsets Q along (0.618..., 1) to break degeneracies.
    """
    K, V, _ = pv.shape
    W = qv.shape[1]
    dtype, dev = pv.dtype, pv.device
    qv = qv + perturb_offset(perturb, K, dtype, dev)
    pn = pn.long()
    qn = qn.long()

    pa, pb = close_ring(pv, pn)
    qa, qb = close_ring(qv, qn)
    pe_m = torch.arange(V, device=dev) < pn[:, None]
    qe_m = torch.arange(W, device=dev) < qn[:, None]

    # ---- 1. all proper edge-pair crossings [K, V, W] ----------------------
    r = (pb - pa)[:, :, None, :]
    s = (qb - qa)[:, None, :, :]
    d0 = qa[:, None, :, :] - pa[:, :, None, :]
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    denom_safe = torch.where(denom == 0, 1.0, denom)
    t = (d0[..., 0] * s[..., 1] - d0[..., 1] * s[..., 0]) / denom_safe
    u = (d0[..., 0] * r[..., 1] - d0[..., 1] * r[..., 0]) / denom_safe
    proper = (
        (denom != 0)
        & (t > EPS_T) & (t < 1 - EPS_T)
        & (u > EPS_T) & (u < 1 - EPS_T)
        & pe_m[:, :, None] & qe_m[:, None, :]
    )
    px = pa[:, :, None, 0] + t * r[..., 0]
    py = pa[:, :, None, 1] + t * r[..., 1]
    # boundary leaves this crossing along P iff P's edge enters Q's interior
    followP_all = denom < 0

    # ---- 2. compact to CAP ------------------------------------------------
    flat = proper.reshape(K, V * W)
    n_cross_total = flat.sum(1)
    overflow = (n_cross_total > CAP) | (n_cross_total % 2 == 1)
    sel = first_true(flat, CAP, V * W)
    valid = sel < V * W

    def takef(x, fill):
        xf = torch.cat(
            [x.reshape(K, -1), torch.full((K, 1), fill, dtype=x.dtype, device=dev)],
            dim=1,
        )
        return torch.gather(xf, 1, sel)

    Xp = torch.stack([takef(px, 0.0), takef(py, 0.0)], dim=-1)  # [K, CAP, 2]
    iv = torch.arange(V, device=dev)[:, None].expand(V, W).expand(K, V, W)
    jw = torch.arange(W, device=dev)[None, :].expand(V, W).expand(K, V, W)
    ek = takef(iv, 0)
    fj = takef(jw, 0)
    tk = takef(t, 0.0)
    uk = takef(u, 0.0)
    followP = takef(followP_all, False) & valid

    # ---- 3. next pointers along each ring ---------------------------------
    nxtP = _next_pointers(ek.to(dtype) + tk, valid)
    nxtQ = _next_pointers(fj.to(dtype) + uk, valid)

    # ---- 4. per-crossing outgoing arc integrals ---------------------------
    ringP = _ring_prefix(pv, pn)
    ringQ = _ring_prefix(qv, qn)

    Xp_k2 = _gather1(Xp, nxtP)
    ek_k2 = _gather1(ek, nxtP)
    same_fwd_P = (ek_k2 == ek) & (_gather1(tk, nxtP) > tk)
    SP, MXP, MYP, LENP, CNTP = _arc_quantities(
        ringP, pn, Xp, ek, Xp_k2, ek_k2, same_fwd_P
    )
    fj_k3 = _gather1(fj, nxtQ)
    same_fwd_Q = (fj_k3 == fj) & (_gather1(uk, nxtQ) > uk)
    SQ, MXQ, MYQ, LENQ, CNTQ = _arc_quantities(
        ringQ, qn, Xp, fj, _gather1(Xp, nxtQ), fj_k3, same_fwd_Q
    )

    ar = torch.arange(CAP, device=dev).expand(K, CAP)
    succ = torch.where(followP, nxtP, nxtQ)
    succ = torch.where(valid, succ, ar)
    arcS = torch.where(valid, torch.where(followP, SP, SQ), 0.0)
    arcMX = torch.where(valid, torch.where(followP, MXP, MXQ), 0.0)
    arcMY = torch.where(valid, torch.where(followP, MYP, MYQ), 0.0)
    # P-chain only quantities
    endpt = torch.where(followP[..., None], Xp_k2, Xp)
    darc = endpt - Xp
    onP = valid & followP
    arcNx = torch.where(onP, -darc[..., 1], 0.0)
    arcNy = torch.where(onP, darc[..., 0], 0.0)
    arcPL = torch.where(onP, LENP, 0.0)
    arcPC = torch.where(onP, CNTP, 0)
    arcQC = torch.where(valid & ~followP, CNTQ, 0)

    # ---- 5. cycle identification (pointer doubling, min-index labels) -----
    lbl = ar
    s2 = succ
    for _ in range(max(1, (CAP - 1).bit_length())):
        lbl = torch.minimum(lbl, torch.gather(lbl, 1, s2))
        s2 = torch.gather(s2, 1, s2)
    seg = torch.where(valid, lbl, CAP)          # invalid -> no region
    member = seg[:, :, None] == torch.arange(CAP, device=dev)  # [K, k, region]

    def ssum(x):
        return torch.where(member, x[:, :, None], 0).sum(1)

    reg_S = ssum(arcS)
    reg_MX = ssum(arcMX)
    reg_MY = ssum(arcMY)
    reg_Nx = ssum(arcNx)
    reg_Ny = ssum(arcNy)
    reg_PL = ssum(arcPL)
    reg_PC = ssum(arcPC)
    reg_QC = ssum(arcQC)
    reg_m = ssum(valid.long())

    # a real overlap region can never exceed either input's area; degenerate
    # tracing can produce phantom cycles, which this clamp discards
    areaP = torch.abs(signed_area(pv, pn))
    areaQ = torch.abs(signed_area(qv, qn))
    max_reasonable = (torch.minimum(areaP, areaQ) * (1 + 1e-6))[:, None]
    reg_valid = (reg_m >= 2) & (reg_S > 0) & (reg_S <= max_reasonable)
    reg_area = torch.where(reg_valid, reg_S, 0.0)
    denom_c = torch.where(reg_valid, 6.0 * reg_S, 1.0)
    reg_cx = torch.where(reg_valid, reg_MX / denom_c, 0.0)
    reg_cy = torch.where(reg_valid, reg_MY / denom_c, 0.0)

    chord_a = Xp
    chord_b = _gather1(Xp, succ)
    total_cross_area = reg_area.sum(1)

    # ---- 6. containment (no crossings) -------------------------------------
    p_in_q = point_in_polygon(pv[:, 0], qv, qn)
    q_in_p = point_in_polygon(qv[:, 0], pv, pn)
    contain_area = torch.where(p_in_q, areaP, torch.where(q_in_p, areaQ, 0.0))
    total_area = torch.where(n_cross_total == 0, contain_area, total_cross_area)

    return ClipRegions(
        total_area=total_area,
        area=reg_area,
        centroid=torch.stack([reg_cx, reg_cy], dim=-1),
        n_cross=reg_m.to(torch.int32),
        chord_a=chord_a,
        chord_b=chord_b,
        p_norm=torch.stack([reg_Nx, reg_Ny], dim=-1),
        p_len=reg_PL,
        p_cnt=reg_PC.to(torch.int32),
        q_cnt=reg_QC.to(torch.int32),
        valid=reg_valid,
        overflow=overflow,
    )


# ---------------------------------------------------------------------------
# two-crossing fast path
# ---------------------------------------------------------------------------

def intersect_area(pv, pn, qv, qn, CAP: int = DEFAULT_CAP):
    """Total intersection area only, per pair of the batch."""
    return intersect_regions(pv, pn, qv, qn, CAP=CAP).total_area


class TwoCrossResult(NamedTuple):
    """Fused crossing count + single-region narrow phase over B pairs.

    ``cnt``/``contain`` give the proper crossing count and the containment
    area (cnt == 0 pairs); where ``ok`` (two crossings, one entering) the
    region's area/centroid/chord/p_norm follow directly.  Pairs with
    ``cnt > 0`` and not ``ok`` need ``intersect_regions``."""

    cnt: torch.Tensor        # [B] int32 number of proper boundary crossings
    contain: torch.Tensor    # [B] containment area for cnt == 0 pairs
    ok: torch.Tensor         # [B] bool: cnt == 2 with clean enter/exit parity
    area: torch.Tensor       # [B] region area (valid where ok)
    centroid: torch.Tensor   # [B, 2]
    chord_a: torch.Tensor    # [B, 2] entering crossing point
    chord_b: torch.Tensor    # [B, 2] exiting crossing point
    p_norm: torch.Tensor     # [B, 2] inward-normal sum over the P-chain


def _ring_pm(v, n):
    """Pair-minor ring edges: v [B, V, 2], n [B] -> (ax, ay, bx, by, em),
    each [V, B]; em masks valid edges."""
    V = v.shape[-2]
    ax = v[..., 0].T
    ay = v[..., 1].T
    idx = torch.arange(V, device=v.device)[:, None]
    em = idx < n[None, :]
    # b[i] = v[i+1], with the ring closed at i == n-1 -> v[0]
    wrap = idx == (n[None, :] - 1)
    bx = torch.where(wrap, ax[0][None, :], torch.roll(ax, -1, 0))
    by = torch.where(wrap, ay[0][None, :], torch.roll(ay, -1, 0))
    return ax, ay, bx, by, em


def _pip_pm(px, py, ax, ay, bx, by, em):
    """Pair-minor point-in-polygon (crossing number): px, py [B]; ring
    arrays [W, B] -> bool [B]."""
    cond = (ay > py[None, :]) != (by > py[None, :])
    dy = by - ay
    tt = (py[None, :] - ay) / torch.where(dy == 0, 1.0, dy)
    xint = ax + tt * (bx - ax)
    hits = torch.sum(cond & em & (px[None, :] < xint), dim=0)
    return (hits % 2) == 1


def _seg_pm(x1, y1, x2, y2):
    cr = x1 * y2 - x2 * y1
    return 0.5 * cr, (x1 + x2) * cr, (y1 + y2) * cr


def _chain_pm(axv, ayv, bxv, byv, n, e_in, t_in, Xin_x, Xin_y,
              e_out, t_out, Xout_x, Xout_y):
    """Line integrals along the ring arc from crossing ``Xin`` (edge
    ``e_in``, parameter ``t_in``) forward to ``Xout`` (edge ``e_out``).
    Ring arrays [V, B]; everything else [B]."""
    V = axv.shape[0]
    nsafe = torch.clamp(n, min=1)
    idx = torch.arange(V, device=axv.device)[:, None]
    same = (e_in == e_out) & (t_out > t_in)

    sel_in = idx == e_in[None, :]
    sel_out = idx == e_out[None, :]
    b_in_x = torch.where(sel_in, bxv, 0.0).sum(0)
    b_in_y = torch.where(sel_in, byv, 0.0).sum(0)
    a_out_x = torch.where(sel_out, axv, 0.0).sum(0)
    a_out_y = torch.where(sel_out, ayv, 0.0).sum(0)

    # full edges strictly between e_in and e_out (cyclic, open interval)
    cnt_full = torch.remainder(e_out - e_in - 1, nsafe)
    e0 = torch.remainder(e_in + 1, nsafe)
    inrun = (
        (torch.remainder(idx - e0[None, :], nsafe[None, :]) < cnt_full[None, :])
        & (idx < n[None, :])
    )
    cr = axv * byv - bxv * ayv
    S_run = 0.5 * torch.where(inrun, cr, 0.0).sum(0)
    MX_run = torch.where(inrun, (axv + bxv) * cr, 0.0).sum(0)
    MY_run = torch.where(inrun, (ayv + byv) * cr, 0.0).sum(0)

    S1, MX1, MY1 = _seg_pm(Xin_x, Xin_y, Xout_x, Xout_y)
    Sp1, MXp1, MYp1 = _seg_pm(Xin_x, Xin_y, b_in_x, b_in_y)
    Sp2, MXp2, MYp2 = _seg_pm(a_out_x, a_out_y, Xout_x, Xout_y)
    S = torch.where(same, S1, Sp1 + S_run + Sp2)
    MX = torch.where(same, MX1, MXp1 + MX_run + MXp2)
    MY = torch.where(same, MY1, MYp1 + MY_run + MYp2)
    return S, MX, MY


def two_cross_pass(pv, pn, qv, qn, perturb) -> TwoCrossResult:
    """Plain PyTorch version of the two-crossing narrow phase.

    pv: [B, V, 2], pn: [B], qv: [B, W, 2] (already shifted), qn: [B],
    perturb: [B] degeneracy-breaking offset applied to Q.

    Exactly two proper boundary crossings => one overlap region bounded by
    the P-chain (enter -> exit along P) and the Q-chain (exit -> enter
    along Q), whose integrals reduce to masked sums.
    """
    dtype = pv.dtype
    qv = qv + perturb_offset(perturb, pv.shape[0], dtype, pv.device)
    pn = pn.long()
    qn = qn.long()

    pax, pay, pbx, pby, pe_m = _ring_pm(pv, pn)   # [V, B]
    qax, qay, qbx, qby, qe_m = _ring_pm(qv, qn)   # [W, B]

    # ---- all proper edge-pair crossings, [V, W, B] -------------------------
    rx = (pbx - pax)[:, None, :]
    ry = (pby - pay)[:, None, :]
    sx = (qbx - qax)[None, :, :]
    sy = (qby - qay)[None, :, :]
    d0x = qax[None, :, :] - pax[:, None, :]
    d0y = qay[None, :, :] - pay[:, None, :]
    denom = rx * sy - ry * sx
    denom_safe = torch.where(denom == 0, 1.0, denom)
    t = (d0x * sy - d0y * sx) / denom_safe
    u = (d0x * ry - d0y * rx) / denom_safe
    proper = (
        (denom != 0)
        & (t > EPS_T) & (t < 1 - EPS_T)
        & (u > EPS_T) & (u < 1 - EPS_T)
        & pe_m[:, None, :] & qe_m[None, :, :]
    )
    cnt = proper.sum((0, 1))

    cxp = pax[:, None, :] + t * rx
    cyp = pay[:, None, :] + t * ry
    enter = proper & (denom < 0)   # boundary leaves along P (P enters Q)
    exit_ = proper & (denom >= 0)

    V, W = pv.shape[1], qv.shape[1]
    iV = torch.arange(V, device=pv.device)[:, None, None]
    iW = torch.arange(W, device=pv.device)[None, :, None]

    def pick(w, x):
        return torch.where(w, x, 0).sum((0, 1))

    n_en = enter.sum((0, 1))
    ok = (cnt == 2) & (n_en == 1)

    Xen_x = pick(enter, cxp)
    Xen_y = pick(enter, cyp)
    Xex_x = pick(exit_, cxp)
    Xex_y = pick(exit_, cyp)
    e_en = pick(enter, iV)
    f_en = pick(enter, iW)
    e_ex = pick(exit_, iV)
    f_ex = pick(exit_, iW)
    t_en = pick(enter, t)
    u_en = pick(enter, u)
    t_ex = pick(exit_, t)
    u_ex = pick(exit_, u)

    # ---- region integrals: P-chain (enter->exit), Q-chain (exit->enter) ----
    S_P, MX_P, MY_P = _chain_pm(
        pax, pay, pbx, pby, pn, e_en, t_en, Xen_x, Xen_y,
        e_ex, t_ex, Xex_x, Xex_y,
    )
    S_Q, MX_Q, MY_Q = _chain_pm(
        qax, qay, qbx, qby, qn, f_ex, u_ex, Xex_x, Xex_y,
        f_en, u_en, Xen_x, Xen_y,
    )
    S = S_P + S_Q

    crP = pax * pby - pbx * pay
    areaP = torch.abs(0.5 * torch.where(pe_m, crP, 0.0).sum(0))
    crQ = qax * qby - qbx * qay
    areaQ = torch.abs(0.5 * torch.where(qe_m, crQ, 0.0).sum(0))
    max_reasonable = torch.minimum(areaP, areaQ) * (1 + 1e-6)
    ok = ok & (S > -sliver_tol(dtype) * max_reasonable) & (S <= max_reasonable)
    pos = ok & (S > 0)
    area = torch.where(pos, S, 0.0)
    denom_c = torch.where(pos, 6.0 * S, 1.0)
    cx = torch.where(pos, (MX_P + MX_Q) / denom_c, 0.0)
    cy = torch.where(pos, (MY_P + MY_Q) / denom_c, 0.0)

    # ---- containment for cnt == 0 ------------------------------------------
    p_in_q = _pip_pm(pax[0], pay[0], qax, qay, qbx, qby, qe_m)
    q_in_p = _pip_pm(qax[0], qay[0], pax, pay, pbx, pby, pe_m)
    contain = torch.where(
        cnt == 0,
        torch.where(p_in_q, areaP, torch.where(q_in_p, areaQ, 0.0)),
        0.0,
    )

    # P-chain inward-normal sum telescopes to rot90(Xex - Xen)
    pnx = -(Xex_y - Xen_y)
    pny = Xex_x - Xen_x

    return TwoCrossResult(
        cnt=cnt.to(torch.int32),
        contain=contain,
        ok=ok,
        area=area,
        centroid=torch.stack([cx, cy], dim=-1),
        chord_a=torch.stack([Xen_x, Xen_y], dim=-1),
        chord_b=torch.stack([Xex_x, Xex_y], dim=-1),
        p_norm=torch.stack([pnx, pny], dim=-1),
    )


# Argument names of the narrow phase over pools and a pair list, in order
# (two_cross_pairs, two_cross_dispatch, two_cross.two_cross_cuda).
TWO_CROSS_ARGS = ("p_verts", "p_n", "q_verts", "q_n", "qi", "qj", "shift",
                  "perturb", "valid")


def gather_rings(p_verts, p_n, q_verts, q_n, qi, qj, shift):
    """The ring batch of a pair list, materialised: (pv [PC, V, 2], pn [PC],
    qv [PC, W, 2] shifted to P's image, qn [PC])."""
    return (p_verts[qi], p_n[qi], q_verts[qj] + shift[:, None, :], q_n[qj])


def two_cross_pairs(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb,
                    valid) -> TwoCrossResult:
    """Plain PyTorch version of the CUDA kernel (``two_cross.two_cross_cuda``),
    with its signature: ring pools p_verts [N, V, 2] / p_n [N] and q_verts
    [NQ, W, 2] / q_n [NQ], and the candidate list qi, qj [PC] (row k pairs
    floe qi[k] with Q slot qj[k]), shift [PC, 2] (the periodic image of Q),
    perturb [PC], valid [PC].  Gathers the rings, runs ``two_cross_pass`` and
    zeroes the rows that are not valid (ok False)."""
    pv, pn, qv, qn = gather_rings(p_verts, p_n, q_verts, q_n, qi, qj, shift)
    # rings that all fit in 16 vertices take the first 16 slots: the masked
    # slots contribute nothing, and the plain version is quadratic in them
    if pv.shape[0] > 0 and not pv.is_cuda:
        if pv.shape[1] > 16 and int(pn.max()) <= 16:
            pv = pv[:, :16]
        if qv.shape[1] > 16 and int(qn.max()) <= 16:
            qv = qv[:, :16]
    r = two_cross_pass(pv, pn, qv, qn, perturb)
    return TwoCrossResult(*(
        torch.where(valid.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
        for x in r
    ))


def two_cross_dispatch(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb,
                       valid) -> TwoCrossResult:
    """The narrow phase on the tensors' device: CUDA tensors go to the
    hand-written kernel (geometry/two_cross.py), which raises on what it
    cannot take; CPU tensors go to the plain ``two_cross_pairs``."""
    if p_verts.is_cuda:
        from .two_cross import two_cross_cuda

        return two_cross_cuda(p_verts, p_n, q_verts, q_n, qi, qj, shift,
                              perturb, valid)
    return two_cross_pairs(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb,
                           valid)


def count_crossings(pv, pn, qv, qn, perturb=0.0):
    """Stage-1 narrow-phase filter for K pairs: number of proper boundary
    crossings, plus the containment intersection area for the zero-crossing
    case.  Returns (count [K], containment_area [K])."""
    dtype = pv.dtype
    K, V, _ = pv.shape
    W = qv.shape[1]
    qv = qv + perturb_offset(perturb, K, dtype, pv.device)
    pa, pb = close_ring(pv, pn)
    qa, qb = close_ring(qv, qn)
    pe_m = torch.arange(V, device=pv.device) < pn[:, None]
    qe_m = torch.arange(W, device=pv.device) < qn[:, None]
    r = (pb - pa)[:, :, None, :]
    s = (qb - qa)[:, None, :, :]
    d0 = qa[:, None, :, :] - pa[:, :, None, :]
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    denom_safe = torch.where(denom == 0, 1.0, denom)
    t = (d0[..., 0] * s[..., 1] - d0[..., 1] * s[..., 0]) / denom_safe
    u = (d0[..., 0] * r[..., 1] - d0[..., 1] * r[..., 0]) / denom_safe
    proper = (
        (denom != 0)
        & (t > EPS_T) & (t < 1 - EPS_T)
        & (u > EPS_T) & (u < 1 - EPS_T)
        & pe_m[:, :, None] & qe_m[:, None, :]
    )
    count = proper.sum((1, 2))
    p_in_q = point_in_polygon(pv[:, 0], qv, qn)
    q_in_p = point_in_polygon(qv[:, 0], pv, pn)
    areaP = torch.abs(signed_area(pv, pn))
    areaQ = torch.abs(signed_area(qv, qn))
    contain = torch.where(
        count > 0, 0.0,
        torch.where(p_in_q, areaP, torch.where(q_in_p, areaQ, 0.0)),
    )
    return count, contain
