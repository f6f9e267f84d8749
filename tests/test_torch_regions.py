"""The slow clip's kernel arithmetic (B2, csrc/intersect_regions.cuh) on the
CPU, through its g++ shim (csrc/intersect_regions_host.cpp: the kernel's
per-row arithmetic, combined serially in the kernel's order, with the
kernel's interface: pools, pair list, slow selection, n_slow), against the
JAX package's ``subzero_tpu.geometry.clip.intersect_regions`` and the port's
plain version (``geometry/regions.py:slow_regions_plain``, which clips
through ``geometry/clip.py:intersect_regions``).

Inputs, made with numpy from a seed: combs against bars (several regions a
pair), combs against combs (more crossings than CAP), containment and
disjoint pairs (no crossing), polygons on a coarse lattice against
translated copies and each other (shared edges and vertices on edges, with
odd crossing parity where the perturbation rounds away), and the slow rows
of the packed fields of tests/test_torch_collisions_slow_path.py
(``parity_retry`` and ``beyond_first_tier``), and combs of up to 10 teeth
(40 vertices) against bars in pools of width 40 (up to 40 crossings a row).
Each at CAP 16 and 32 (the wide combs also at 48), in f64 and f32, at
perturbation scales 1 and -41 (the retry's).

Tolerances:
  * shim against the JAX package, f64: rtol 1e-9 with an absolute floor of
    1e-9 of each field's largest magnitude (the port's standard).  A
    region's centroid is MX / 6S, so its error grows as 1 / S: the
    perturbation leaves sliver regions of area ~1e-9 along shared edges,
    whose centroid moves by ~1e-7 between summation orders (the port's
    plain version differs from the JAX package there as much).  The
    centroid is compared as the first moment, area x centroid, and as
    itself on regions of at least 1e-6 of the batch's largest area.  The
    P-chain normal sums displacement vectors that cancel on a symmetric
    region (a comb's tooth across a bar: ~1e-11 where the coordinates are
    ~1e4), so its floor is 1e-9 of the coordinates' largest magnitude.
  * shim against the plain version: the fields computed elementwise (the
    chords, the counts, the flags) bitwise; the prefix sums accumulate in
    double in both (torch.cumsum on the CPU does), so the arcs agree to the
    bit, and the fields that sum arcs, regions or ring edges (total_area,
    area, centroid, p_norm, p_len) are bitwise where torch.sum adds in the
    header's order (it does in f64 at CAP 16 on an AVX2 CPU), else within
    1e-12 relative (f64, floor 1e-12 of the field's largest magnitude) and
    1e-5 of each field's largest magnitude (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.geometry.clip import intersect_regions as jax_intersect_regions
from subzero_tpu_torch.geometry.clip import ClipRegions, first_true, two_cross_dispatch
from subzero_tpu_torch.geometry import regions
from subzero_tpu_torch.geometry.regions import run_host_shim, slow_regions_plain
from subzero_tpu_torch.physics import collisions as tcol

from test_torch_collisions_slow_path import PACKED_CASES, PERIODIC_DOMAIN, _packed_field
from torch_port_helpers import (
    assert_fields_close,
    build_batch,
    build_regions_shim,
    lattice_pairs,
    port_state,
)

SUMMED = ("total_area", "area", "centroid", "p_norm", "p_len")
CAPS = (16, 32)
# the wide rings at CAP 48 as well: their rows keep up to 40 crossings
CAPS_OF = {"wide_comb_bar": (16, 32, 48)}
SCALES = (1.0, -41.0)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return build_regions_shim(tmp_path_factory.mktemp("regions_shim"))


# ---------------------------------------------------------------------------
# inputs: ring pools, a pair list, a slow selection (f64 numpy / torch)
# ---------------------------------------------------------------------------

def _comb(k, w, h0, H):
    """A CCW comb of k teeth (width w, height H) on a base of height h0:
    4k vertices."""
    L = (2 * k - 1) * w
    pts = [(0.0, 0.0), (L, 0.0)]
    for m in range(k - 1, -1, -1):
        xr, xl = (2 * m + 1) * w, 2 * m * w
        pts += [(xr, h0 + H), (xl, h0 + H)]
        if m > 0:
            pts += [(xl, h0), (xl - w, h0)]
    return np.array(pts)


def _rect(x0, x1, y0, y1):
    return np.array([(x0, y0), (x1, y0), (x1, y1), (x0, y1)])


def _moved(rng, *rings):
    """The rings under one random rotation, scale and translation."""
    th = rng.uniform(0, 2 * np.pi)
    s = 10.0 ** rng.uniform(0, 4)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    t = rng.uniform(-10, 10, 2) * s
    return [s * r @ rot.T + t for r in rings]


def _pools(pairs, V):
    """Pools of one P and one Q ring a pair, and the pair list that pairs
    them (unshifted, small perturbation) with every row slow."""
    K = len(pairs)
    pv = np.zeros((K, V, 2))
    qv = np.zeros((K, V, 2))
    pn = np.zeros(K, np.int32)
    qn = np.zeros(K, np.int32)
    for k, (p, q) in enumerate(pairs):
        for v, n, r in ((pv, pn, p), (qv, qn, q)):
            v[k, :len(r)] = r
            v[k, len(r):] = r[-1]
            n[k] = len(r)
    idx = np.arange(K, dtype=np.int64)
    scale = np.abs(pv).max(axis=(1, 2))
    pert = 1e-9 * scale
    return [torch.from_numpy(x) for x in
            (pv, pn, qv, qn, idx, idx, np.zeros((K, 2)), pert)]


def comb_bar(seed=0):
    """Combs of 2-5 teeth against a bar across the teeth (k regions, 4k
    crossings: 20 > CAP 16 at five teeth)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(24):
        k = int(rng.integers(2, 6))
        w, h0, H = rng.uniform(0.5, 2), rng.uniform(0.5, 2), rng.uniform(3, 10)
        a = rng.uniform(0.1, 0.45) * H
        b = rng.uniform(0.55, 0.9) * H
        L = (2 * k - 1) * w
        pairs.append(_moved(rng, _comb(k, w, h0, H),
                            _rect(-0.5 * w, L + 0.5 * w, h0 + a, h0 + b)))
    return _pools(pairs, 20)


def over_cap(seed=1):
    """Combs of 4 vertical teeth against combs of 3 horizontal ones reaching
    across all of them: 48 crossings, more than either CAP; and combs of 5
    teeth against a bar: 20, more than 16 only."""
    rng = np.random.default_rng(seed)
    pairs = []
    for n in range(12):
        w, h0, H = rng.uniform(0.5, 1.5), rng.uniform(0.5, 1.5), rng.uniform(8, 12)
        if n % 2:
            P = _comb(5, w, h0, H)
            Q = _rect(-0.5 * w, 9.5 * w, h0 + 0.3 * H, h0 + 0.6 * H)
        else:
            L = 7 * w
            P = _comb(4, w, h0, H)
            # three teeth pointing left (a comb turned by 90 degrees), its
            # base right of P, reaching across P's teeth
            w2 = rng.uniform(0.3, 0.5) * H / 5
            Q = _comb(3, w2, 1.0, L + 2.0)[:, ::-1] * np.array([-1.0, 1.0])
            Q = Q + np.array([L + 1.5, h0 + 0.1 * H])
        pairs.append(_moved(rng, P, Q))
    return _pools(pairs, 20)


def wide_comb_bar(seed=4):
    """Combs of 8-10 teeth (32-40 vertices) against a bar across the teeth,
    in pools of width 40: up to 40 crossings a row, so crossings past 31
    (two a lane in the kernel) and past CAP 32, within CAP 48."""
    rng = np.random.default_rng(seed)
    pairs = []
    for n in range(12):
        k = 8 + n % 3
        w, h0, H = rng.uniform(0.5, 2), rng.uniform(0.5, 2), rng.uniform(3, 10)
        a = rng.uniform(0.1, 0.45) * H
        b = rng.uniform(0.55, 0.9) * H
        L = (2 * k - 1) * w
        pairs.append(_moved(rng, _comb(k, w, h0, H),
                            _rect(-0.5 * w, L + 0.5 * w, h0 + a, h0 + b)))
    return _pools(pairs, 40)


def containment(seed=2):
    """Star rings with tiny stars inside them, inside big stars, and apart
    (tests/test_pallas_clip.py's batch): no proper crossing."""
    pv, pn, qv, qn, _ = build_batch(B=64, seed=seed, V=16, nmax=16, dtype=np.float64)
    keep = np.arange(64) % 4 != 0  # disjoint, Q inside P, P inside Q
    pairs = [(pv[k, :pn[k]], qv[k, :qn[k]]) for k in np.nonzero(keep)[0]]
    return _pools(pairs, 16)


# log10 of the shared-edge perturbation relative to the coordinates: near
# the crossing test's eps (1e-12) in f64 and the coordinates' rounding in
# f32, so that at scale 1 some degeneracies survive it and at -41 most do not
SHARED_EDGE_PERTURB = {torch.float64: (-13.5, -12.5), torch.float32: (-8.5, -7.5)}


def shared_edges(seed=3, dtype=torch.float64):
    """Polygons with vertices on a coarse lattice, against translated copies
    of themselves and against each other: collinear shared edges and
    vertices on edges, with a perturbation in SHARED_EDGE_PERTURB[dtype]
    (torch_port_helpers.lattice_pairs), in f64."""
    return list(lattice_pairs(K=64, seed=seed, dtype=torch.float64,
                              perturb=SHARED_EDGE_PERTURB[dtype])[0])


def _packed(case):
    """The slow rows of a packed field of test_torch_collisions_slow_path:
    the narrow phase's pair list (f64) and its slow selection."""
    r0, spike, _, _ = PACKED_CASES[case]
    fl, _, _, dom, _ = port_state(_packed_field(r0, spike), PERIODIC_DOMAIN)
    nb = tcol.narrow_phase_batch(fl, dom, 320)
    tc = two_cross_dispatch(*nb.two_cross_args())
    slow = (tc.cnt > 0) & ~tc.ok
    PC = nb.pairs.qi.shape[0]
    return list(nb.two_cross_args()[:8]), first_true(slow, 32, PC), slow.sum()


INPUTS = {
    "comb_bar": comb_bar,
    "wide_comb_bar": wide_comb_bar,
    "containment": containment,
    "shared_edges": shared_edges,
    "over_cap": over_cap,
    "packed_parity_retry": lambda: _packed("parity_retry"),
    "packed_beyond_first_tier": lambda: _packed("beyond_first_tier"),
}


def _inputs(name):
    out = INPUTS[name]()
    if isinstance(out, tuple):
        return out
    K = out[4].shape[0]
    return out, torch.arange(K, dtype=torch.int64), torch.tensor(K)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def jax_rows(args, ssel, n, cap):
    """The JAX package's intersect_regions on the first n selected rows."""
    p_verts, p_n, q_verts, q_n, qi, qj, shift, pert = (x.numpy() for x in args)
    rows = ssel[:n].numpy()
    i, j = qi[rows], qj[rows]
    return jax.vmap(
        lambda a, b, c, d, p: jax_intersect_regions(a, b, c, d, CAP=cap, perturb=p)
    )(jnp.asarray(p_verts[i]), jnp.asarray(p_n[i]),
      jnp.asarray(q_verts[j] + shift[rows][:, None, :]), jnp.asarray(q_n[j]),
      jnp.asarray(pert[rows]))


def _moments(r):
    """ClipRegions (numpy fields) with the centroid as area x centroid."""
    d = {f: np.asarray(getattr(r, f)) for f in ClipRegions._fields}
    d["centroid"] = d["area"][..., None] * d["centroid"]
    return ClipRegions(**d)


def assert_against_jax(got, ref, n, what):
    got = ClipRegions(*(np.asarray(x)[:n] for x in got))
    coords = np.abs(np.asarray(ref.chord_a)).max(initial=0)
    assert_fields_close(_moments(got), _moments(ref), rtol=1e-9, atol_rel=1e-9,
                        what=what + "(first moments) ",
                        atol={"p_norm": 1e-9 * coords})
    area = np.asarray(ref.area)
    big = area >= 1e-6 * area.max() if area.size else area > 0
    g, r = got.centroid[big], np.asarray(ref.centroid)[big]
    np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-9 * np.abs(r).max(initial=0),
                               err_msg=what + "centroid")


def assert_against_plain(got, ref, f64, what):
    """Elementwise fields bitwise, summed fields bitwise or within the
    stated tolerance; returns the summed fields that were not bitwise."""
    off = []
    for f, g, r in zip(ClipRegions._fields, got, ref):
        if torch.equal(g, r):
            continue
        assert f in SUMMED, f"{what}{f}: not bitwise equal to the plain version"
        off.append(f)
        scale = float(r.abs().max())
        if f64:
            torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12 * scale,
                                       msg=lambda m: what + f + ": " + m)
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * scale,
                                       msg=lambda m: what + f + ": " + m)
    return off


@pytest.mark.parametrize("name", list(INPUTS))
def test_shim_against_jax_and_plain(name, shim):
    args64, ssel, n_slow = _inputs(name)
    n = int(min(int(n_slow), ssel.shape[0]))
    assert n > 0
    seen = {"regions": 0, "overflow": 0, "contained": 0}
    for dtype in (torch.float64, torch.float32):
        for cap in CAPS_OF.get(name, CAPS):
            for scale in SCALES:
                what = f"{name} {dtype} CAP {cap} scale {scale}: "
                args = [x.to(dtype) if x.is_floating_point() else x for x in args64]
                args[7] = args[7] * scale
                got, gbad = run_host_shim(shim, *args, ssel, n_slow, cap, 0)
                ref, rbad = slow_regions_plain(*args, ssel, n_slow, cap, 0)
                assert torch.equal(gbad, rbad), what + "parity_bad"
                assert_against_plain(got, ref, dtype == torch.float64, what)
                for x in got:  # rows past n_slow: zeros
                    assert not bool(x[n:].any()), what + "rows past n_slow"
                if dtype == torch.float64:
                    assert_against_jax(got, jax_rows(args, ssel, n, cap), n, what)
                seen["regions"] = max(seen["regions"], int(got.valid.sum(1).max()))
                seen["overflow"] += int(got.overflow.sum())
                seen["contained"] += int(((got.n_cross[:n].sum(1) == 0)
                                          & (got.total_area[:n] > 0)).sum())
    # each input exercises what it is here for
    if name == "comb_bar":
        assert seen["regions"] >= 4 and seen["overflow"] > 0, seen
    if name == "wide_comb_bar":  # 10 regions of 40 crossings at CAP 48
        assert seen["regions"] == 10 and seen["overflow"] > 0, seen
    if name == "over_cap":
        assert seen["overflow"] > 0 and seen["regions"] >= 2, seen
    if name == "containment":
        assert seen["contained"] > 0, seen
    if name == "shared_edges":
        assert seen["overflow"] > 0, seen
    if name.startswith("packed"):
        assert seen["regions"] >= 2, seen


def test_shared_edges_go_odd_at_scale_1_and_the_retry_resolves_some(shim):
    """On the lattice polygons more than 16 rows come out with odd parity at
    the first perturbation; the retry (-41) of the first 16 resolves some of
    them and changes no other row, and the shim's clip-and-retry equals the
    plain version's on every row."""
    for dtype in (torch.float64, torch.float32):
        args = shared_edges(dtype=dtype)
        args = [x.to(dtype) if x.is_floating_point() else x for x in args]
        K = args[4].shape[0]
        ssel, n_slow = torch.arange(K), torch.tensor(K)
        first, bad = run_host_shim(shim, *args, ssel, n_slow, 16, 0)
        retried, bad2 = run_host_shim(shim, *args, ssel, n_slow, 16, 16)
        ref, rbad = slow_regions_plain(*args, ssel, n_slow, 16, 16)
        assert torch.equal(bad, bad2) and torch.equal(bad2, rbad)
        odd = bad.nonzero().flatten()
        assert odd.numel() > 16, odd.numel()
        resolved = bad & ~retried.overflow
        assert bool(resolved.any())
        # only the first 16 odd rows were retried
        assert not bool(resolved[odd[16]:].any())
        changed = torch.stack([(a != b).reshape(a.shape[0], -1).any(1)
                               for a, b in zip(first, retried)]).any(0)
        assert torch.equal(changed, resolved)
        assert_against_plain(retried, ref, dtype == torch.float64,
                             f"{dtype} retry: ")


@pytest.mark.parametrize("name", list(INPUTS))
def test_shim_held_against_plain_in_f64(name, shim):
    """``regions.held_against_plain`` (the comparison the card's kernel is
    held to in tests/test_torch_cuda.py and chip_smoke.py) passes the shim's
    clip and retry, in f32 and f64, at each CAP and perturbation scale: each
    floating field within regions.LIMIT_SAME eps L^p of the plain version at
    the same dtype, areas and first moments within regions.LIMIT_F64 of it
    in f64.  In f32 the latter is the f32 rounding, not zero."""
    args64, ssel, n_slow = _inputs(name)
    for dtype in (torch.float64, torch.float32):
        for cap in CAPS_OF.get(name, CAPS):
            for scale in SCALES:
                args = [x.to(dtype) if x.is_floating_point() else x for x in args64]
                args[7] = args[7] * scale
                got, gbad = run_host_shim(shim, *args, ssel, n_slow, cap, 16)
                held = regions.held_against_plain(got, gbad, *args, ssel, n_slow, cap, 16)
                wide = held["max_in_eps_L"]["float64"]
                assert max(wide.values()) <= regions.LIMIT_F64
                if dtype == torch.float32:
                    assert max(wide.values()) > 0, held


def _broken(r, field, row, L):
    """r with one entry of ``field`` of the row's first valid region made
    wrong: its area or first moment (area x centroid) moved by 4 LIMIT_SAME
    eps L^p (L the row's largest coordinate), its crossing count off by
    one, its validity flipped."""
    k = int(r.valid[row].nonzero()[0, 0])
    x = getattr(r, field).clone()
    off = 4 * regions.LIMIT_SAME[field if field == "area" else "centroid"] * torch.finfo(
        r.area.dtype).eps
    if field == "n_cross":
        x[row, k] += 1
    elif field == "valid":
        x[row, k] = ~x[row, k]
    elif field == "area":
        x[row, k] += off * L ** 2
    else:
        x[row, k] += off * L ** 3 / float(r.area[row, k])
    return r._replace(**{field: x})


@pytest.mark.parametrize("field", ["area", "centroid", "n_cross", "valid"])
def test_held_against_plain_catches_a_wrong_field(field, shim):
    """A region's area or centroid moved past the floor, a crossing count
    off by one, or a large region's validity flipped, on one row of the
    shim's f32 clip of the combs against bars, is refused."""
    args64, ssel, n_slow = _inputs("comb_bar")
    args = [x.float() if x.is_floating_point() else x for x in args64]
    got, gbad = run_host_shim(shim, *args, ssel, n_slow, 16, 16)
    regions.held_against_plain(got, gbad, *args, ssel, n_slow, 16, 16)
    row = int(got.valid.any(1).nonzero()[0, 0])
    pv, pn, qv, qn, qi, qj, shift = args[:7]
    i, j = int(qi[ssel[row]]), int(qj[ssel[row]])
    L = max(float(pv[i, :pn[i]].abs().max()),
            float((qv[j, :qn[j]] + shift[ssel[row]]).abs().max()))
    with pytest.raises(AssertionError, match=f"slow clip {field}"):
        regions.held_against_plain(_broken(got, field, row, L), gbad, *args, ssel,
                                   n_slow, 16, 16)
