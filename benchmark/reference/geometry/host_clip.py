"""Host-side (numpy) exact polygon booleans for the life cycle's passes.

The reference's own plain version of the program's host clip: pure Python
and numpy, where the program runs its native C++ build of the same
algorithm and falls back to Python.  The ladder of retries is the
program's in the same order (``_with_retries``), so the two give the same
rings: the native build's fixed-direction perturbations first, then the
Python version's rotated ones, then the rings cleaned of spikes.

Algorithm: crossing-graph Weiler-Atherton on single-ring CCW polygons,
materializing region polygons.  Degeneracies are broken by retrying with a
tiny deterministic perturbation.
"""

from __future__ import annotations

import numpy as np

__all__ = ["intersect", "union", "difference", "poly_area_np", "poly_centroid_np"]


def poly_area_np(c):
    c = np.asarray(c, float)
    x, y = c[:, 0], c[:, 1]
    return 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)


def poly_centroid_np(c):
    c = np.asarray(c, float)
    x, y = c[:, 0], c[:, 1]
    cr = x * np.roll(y, -1) - np.roll(x, -1) * y
    A = 0.5 * np.sum(cr)
    cx = np.sum((x + np.roll(x, -1)) * cr) / (6 * A)
    cy = np.sum((y + np.roll(y, -1)) * cr) / (6 * A)
    return np.array([cx, cy])


def _clean_ring(c):
    """Open CCW ring as [n,2] float array."""
    c = np.asarray(c, float)
    if len(c) > 1 and np.allclose(c[0], c[-1]):
        c = c[:-1]
    keep = [0]
    for i in range(1, len(c)):
        if not np.allclose(c[i], c[keep[-1]]):
            keep.append(i)
    c = c[keep]
    if poly_area_np(c) < 0:
        c = c[::-1]
    return c


def _point_in(p, ring):
    x, y = p
    n = len(ring)
    inside = False
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
            if x < xin:
                inside = not inside
    return inside


class _Degenerate(Exception):
    pass


def _crossings(S, C, eps=1e-12):
    """All proper crossings between rings S and C.

    Returns list of dicts with point, (edge,param) on each ring and sign of
    cross(r, s). Raises _Degenerate on endpoint/parallel-overlap hits.
    """
    out = []
    nS, nC = len(S), len(C)
    for i in range(nS):
        a0, a1 = S[i], S[(i + 1) % nS]
        r = a1 - a0
        for j in range(nC):
            b0, b1 = C[j], C[(j + 1) % nC]
            s = b1 - b0
            den = r[0] * s[1] - r[1] * s[0]
            d0 = b0 - a0
            if den == 0:
                # check for collinear overlap (degenerate)
                if abs(d0[0] * r[1] - d0[1] * r[0]) < eps * max(
                    1.0, np.abs(r).max()
                ) * max(1.0, np.abs(d0).max()):
                    # collinear; overlap check
                    L2 = r @ r
                    t0 = (d0 @ r) / L2
                    t1 = ((b1 - a0) @ r) / L2
                    lo, hi = min(t0, t1), max(t0, t1)
                    if hi > eps and lo < 1 - eps:
                        raise _Degenerate("collinear overlapping edges")
                continue
            t = (d0[0] * s[1] - d0[1] * s[0]) / den
            u = (d0[0] * r[1] - d0[1] * r[0]) / den
            if -eps < t < eps or 1 - eps < t < 1 + eps or -eps < u < eps or 1 - eps < u < 1 + eps:
                if -eps < t < 1 + eps and -eps < u < 1 + eps:
                    raise _Degenerate("crossing at edge endpoint")
                continue
            if eps < t < 1 - eps and eps < u < 1 - eps:
                out.append(
                    dict(pt=a0 + t * r, ei=i, t=t, ej=j, u=u, d=np.sign(den))
                )
    return out


def _arc_points(ring, e0, t0, e1, t1, forward=True):
    """Vertices strictly between two crossing points along a ring."""
    n = len(ring)
    pts = []
    if forward:
        if e0 == e1 and t1 > t0:
            return pts
        e = (e0 + 1) % n
        while True:
            pts.append(ring[e])
            if e == e1:
                break
            e = (e + 1) % n
        return pts
    else:
        # walking backward: from (e0, t0) back to (e1, t1)
        if e0 == e1 and t1 < t0:
            return pts
        e = e0
        while True:
            pts.append(ring[e])
            if e == (e1 + 1) % n:
                break
            e = (e - 1) % n
        return pts


def _boolean(Sc, Cc, op, rotate=True):
    S = _clean_ring(Sc)
    C = _clean_ring(Cc)
    xs = _crossings(S, C)
    if not xs:
        s_in_c = _point_in(S[0], C)
        c_in_s = _point_in(C[0], S)
        if op == "and":
            if s_in_c:
                return [S.copy()]
            if c_in_s:
                return [C.copy()]
            return []
        if op == "or":
            if s_in_c:
                return [C.copy()]
            if c_in_s:
                return [S.copy()]
            return [S.copy(), C.copy()]
        if op == "diff":
            if s_in_c:
                return []
            if c_in_s:
                # hole: split S horizontally through the hole centroid
                hc = poly_centroid_np(C)
                return _boolean_halfplane(S, hc, C, rotate)
            return [S.copy()]

    # order crossings along each ring
    orderS = sorted(range(len(xs)), key=lambda k: (xs[k]["ei"], xs[k]["t"]))
    orderC = sorted(range(len(xs)), key=lambda k: (xs[k]["ej"], xs[k]["u"]))
    posS = {k: m for m, k in enumerate(orderS)}
    posC = {k: m for m, k in enumerate(orderC)}
    nxtS = {k: orderS[(posS[k] + 1) % len(xs)] for k in range(len(xs))}
    nxtC = {k: orderC[(posC[k] + 1) % len(xs)] for k in range(len(xs))}
    prvC = {k: orderC[(posC[k] - 1) % len(xs)] for k in range(len(xs))}

    if len(xs) % 2 == 1:
        # odd crossing parity = an unresolved tangency; the successor
        # permutation is ill-formed
        raise _Degenerate("odd crossing count")

    regions = []
    visited = set()
    for start in range(len(xs)):
        if start in visited:
            continue
        pts = []
        k = start
        closed = False
        for _ in range(2 * len(xs) + 4):
            if k in visited and k == start and pts:
                closed = True
                break
            if k in visited:
                # walked into a previously traced cycle: the crossing
                # pairing is inconsistent (near-tangent geometry); emitting
                # the open chain would create a self-overlapping ring
                raise _Degenerate("trace entered a visited crossing")
            visited.add(k)
            x = xs[k]
            pts.append(x["pt"])
            d = x["d"]
            if op == "and":
                followS = d < 0
            elif op == "or":
                followS = d > 0
            else:  # diff
                followS = d > 0
            if followS:
                k2 = nxtS[k]
                pts.extend(_arc_points(S, x["ei"], x["t"], xs[k2]["ei"], xs[k2]["t"], True))
            else:
                if op == "diff":
                    k2 = prvC[k]
                    pts.extend(
                        _arc_points(C, x["ej"], x["u"], xs[k2]["ej"], xs[k2]["u"], False)
                    )
                else:
                    k2 = nxtC[k]
                    pts.extend(
                        _arc_points(C, x["ej"], x["u"], xs[k2]["ej"], xs[k2]["u"], True)
                    )
            k = k2
            if k == start:
                closed = True
                break
        if not closed:
            raise _Degenerate("region trace did not close")
        if len(pts) >= 3:
            ring = _clean_ring(np.asarray(pts))
            if len(ring) >= 3 and poly_area_np(ring) > 1e-12:
                if not _is_simple_ring(ring):
                    # near-coincident crossings (e.g. a crossing within eps
                    # of a corner) can mis-pair the successor walk into a
                    # self-intersecting ring that still closes; retry with
                    # a larger perturbation
                    raise _Degenerate("self-intersecting output ring")
                regions.append(ring)
    return regions


def _is_simple_ring(ring):
    """True iff the closed ring has no repeated (non-consecutive) vertices
    and no two non-adjacent edges properly intersect (O(V^2) host check on
    boolean outputs; catches both bowties and doubled cycles like
    [A,B,C,D,A,B], whose coincident edges are collinear, not crossing)."""
    r = np.asarray(ring, float)
    n = len(r)
    scale = max(1.0, np.abs(r).max())
    for i in range(n):
        for j in range(i + 1, n):
            if np.abs(r[i] - r[j]).max() <= 1e-12 * scale:
                return False
    a = r
    b = np.roll(r, -1, axis=0)
    d = b - a
    for i in range(n):
        for j in range(i + 2, n):
            if i == 0 and j == n - 1:
                continue  # adjacent through the wrap
            den = d[i, 0] * d[j, 1] - d[i, 1] * d[j, 0]
            if den == 0:
                continue
            w = a[j] - a[i]
            t = (w[0] * d[j, 1] - w[1] * d[j, 0]) / den
            u = (w[0] * d[i, 1] - w[1] * d[i, 0]) / den
            if 1e-12 < t < 1 - 1e-12 and 1e-12 < u < 1 - 1e-12:
                return False
    return True


def _boolean_halfplane(S, hc, C, rotate=True):
    """diff helper when C is strictly inside S: cut S horizontally through
    hc into top/bottom pieces and subtract C from each (mirrors the
    reference's poly_to_floes! hole handling, floe.jl:274-311).  Under the
    fixed-direction ladder the pieces take that ladder too, and its
    exhaustion is a degeneracy of the outer boolean (as in the native
    build); otherwise they take the whole ladder."""
    xmin = S[:, 0].min() - 1.0
    xmax = S[:, 0].max() + 1.0
    ymin = S[:, 1].min() - 1.0
    ymax = S[:, 1].max() + 1.0
    top = np.array([[xmin, hc[1]], [xmax, hc[1]], [xmax, ymax], [xmin, ymax]])
    bot = np.array([[xmin, ymin], [xmax, ymin], [xmax, hc[1]], [xmin, hc[1]]])
    if rotate:
        sub = _with_retries
    else:
        def sub(a, b, op):
            try:
                return _ladder(a, b, op, rotate=False)
            except RuntimeError as e:
                raise _Degenerate(str(e)) from e
    out = []
    for half in (top, bot):
        for piece in sub(S, half, "and"):
            out.extend(sub(piece, C, "diff"))
    return out


def _ladder(Sc, Cc, op, max_tries=8, rotate=True):
    """The boolean with the degeneracy-perturbation retry loop.

    Attempt 0 is unperturbed, attempt k moves C by ``scale * 1e-9 *
    3**(k-1)``.  The fixed-direction ladder (``rotate=False``, the native
    build's) moves it along (0.618, 1) every time; the rotated one (the
    program's Python version) does so at attempt 1 and then turns the
    offset by the golden angle, so that a degeneracy aligned with one
    direction (collinear shared edges) cannot defeat the whole ladder."""
    S0 = np.asarray(Sc, float)
    C0 = np.asarray(Cc, float)
    scale = max(
        np.abs(S0).max(), np.abs(C0).max(), 1.0
    )
    for attempt in range(max_tries):
        try:
            if attempt == 0:
                return _boolean(S0, C0, op, rotate)
            delta = scale * 1e-9 * (3 ** (attempt - 1))
            if attempt == 1 or not rotate:
                off = np.array([0.6180339887, 1.0]) * delta
            else:
                ang = 2.399963229728653 * attempt  # golden angle
                off = np.array([np.cos(ang), np.sin(ang)]) * delta
            return _boolean(S0, C0 + off, op, rotate)
        except _Degenerate:
            continue
    raise RuntimeError(f"polygon boolean '{op}' failed after {max_tries} perturbations")


def _without_spikes(ring):
    """The ring without repeated vertices and zero-width spikes (a vertex
    whose two neighbours coincide: an edge traced out and back).  Neither
    bounds any area, so the region is the same; no perturbation resolves
    them, since both ends of the spike move together."""
    pts = [tuple(p) for p in np.asarray(ring, float)]
    k = 0
    while len(pts) > 3 and k < len(pts):
        n = len(pts)
        a, b, c = pts[k - 1], pts[k], pts[(k + 1) % n]
        if a == b:
            del pts[k]
            k = max(k - 1, 0)
        elif a == c:
            for i in sorted({k, (k + 1) % n}, reverse=True):
                del pts[i]
            k = max(k - 2, 0)
        else:
            k += 1
    return np.asarray(pts)


def _with_retries(Sc, Cc, op, max_tries=8):
    """The boolean through the program's ladder, in its order: the
    fixed-direction ladder (the program's native build), then the rotated
    ladder (its Python fallback, which breaks alignment-locked cases, seen
    in ridge/raft differences of fracture siblings that share a vertex),
    then, where both fail, the rings cleaned of repeated vertices and
    zero-width spikes and the whole ladder again."""
    try:
        return _ladder(Sc, Cc, op, max_tries, rotate=False)
    except RuntimeError:
        pass
    try:
        return _ladder(Sc, Cc, op, max_tries, rotate=True)
    except RuntimeError:
        S2, C2 = _without_spikes(Sc), _without_spikes(Cc)
        if len(S2) == len(Sc) and len(C2) == len(Cc):
            raise
        return _with_retries(S2, C2, op, max_tries)


def intersect(S, C):
    """List of CCW rings forming S ∩ C."""
    return _with_retries(S, C, "and")


def union(S, C):
    """List of CCW rings forming S ∪ C (disjoint inputs -> both)."""
    return _with_retries(S, C, "or")


def difference(S, C):
    """List of CCW rings forming S \\ C (holes split, as in the reference)."""
    return _with_retries(S, C, "diff")
