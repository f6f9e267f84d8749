"""The overlap queries of the host passes, the Eulerian OA coupling and the
host topography/clip code of the port against the JAX package's.

``pair_overlaps`` and ``pair_interactions`` run on the shapes of
tests/test_collisions.py (a two-region C-shape contact for the slow path, a
collision wall and a topography polygon in the Q pool) and on a grown Voronoi
field with a binned broad phase: valid rows and partner codes exact, areas,
forces, force points and torques at f64 rtol 1e-9 (absolute floor 1e-9 of
each column's largest magnitude).  ``calc_eulerian_oa_coupling`` runs on the
inputs of tests/test_coupling_golden.py::TestEulerianOA at rtol 1e-9.
``make_topography`` gives the JAX package's field (rtol 1e-12), and the
native clip library gives the Python clip's rings vertex for vertex (1e-6 m)
on synthetic shapes and Voronoi cells."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.constants import Constants
from subzero_tpu.core import make_atmos, make_ocean
from subzero_tpu.core.domain import make_topography as jax_make_topography
from subzero_tpu.core.floes import build_floes
from subzero_tpu.physics import collisions as jcol
from subzero_tpu.physics import coupling as jcpl
from subzero_tpu.settings import CouplingSettings
from subzero_tpu_torch import native as tnative
from subzero_tpu_torch.core.domain import make_topography as torch_make_topography
from subzero_tpu_torch.core.init import voronoi_cells_in_box
from subzero_tpu_torch.geometry import host_clip as thost
from subzero_tpu_torch.geometry.clip import intersect_area
from subzero_tpu_torch.geometry.polygon import (
    ensure_ccw,
    interior_angles,
    pad_polygon,
    poly_area,
    poly_bounds,
    points_in_polygon,
)
from subzero_tpu_torch.physics import collisions as tcol
from subzero_tpu_torch.physics import coupling as tcpl

from test_collisions import (
    CONSTS,
    CORNER_RECT,
    CSHAPE,
    DT,
    FSET,
    TOPO_DOMAIN,
    TRI,
)
from test_coupling_golden import DOMAIN as CPL_DOMAIN
from test_coupling_golden import GRID as CPL_GRID
from test_torch_binned import _bins_for, _field
from torch_port_helpers import assert_fields_close, port_settings, port_state, to_np

# a rectangle over the topography diamond's corner, one over the east
# collision wall (x = 1e5), and the two-region C-shape contact
ON_TOPO = [[1.5e4, 1.2e4], [1.5e4, 1.8e4], [3.0e4, 1.8e4], [3.0e4, 1.2e4]]
ON_WALL = [[9.0e4, -6e4], [9.0e4, -5e4], [10.2e4, -5e4], [10.2e4, -6e4]]
SHAPES = [TRI, CORNER_RECT, CSHAPE, ON_TOPO, ON_WALL]


def _shapes_pool():
    fl = build_floes(SHAPES, 0.25, 0.0, FSET, np.random.default_rng(0), N=8,
                     P=32, dtype=jnp.float64)
    us = [0.1, 0.0, 0.3, -0.2, 0.2, 0.0, 0.0, 0.0]
    fl = fl._replace(u=jnp.asarray(us, jnp.float64))
    tfl, _, _, tdom, _ = port_state(fl, TOPO_DOMAIN)
    return fl, TOPO_DOMAIN, tfl, tdom


def _close(got, ref, what):
    g, r = to_np(got), np.asarray(ref)
    scale = float(np.abs(r).max()) if r.size else 0.0
    np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-9 * scale, err_msg=what)


def _assert_overlaps(got, ref):
    valid = np.asarray(ref[3])
    np.testing.assert_array_equal(to_np(got[3]), valid)
    np.testing.assert_array_equal(to_np(got[0])[valid], np.asarray(ref[0])[valid])
    np.testing.assert_array_equal(to_np(got[1])[valid], np.asarray(ref[1])[valid])
    _close(to_np(got[2])[valid], np.asarray(ref[2])[valid], "area")
    assert bool(got[4]) == bool(ref[4])
    return valid


def test_pair_overlaps_floes_wall_topography_and_two_regions():
    fl, dom, tfl, tdom = _shapes_pool()
    ref = jcol.pair_overlaps(fl, dom, 64, 16)
    got = tcol.pair_overlaps(tfl, tdom, 64, 16)
    valid = _assert_overlaps(got, ref)
    partners = set(np.asarray(ref[1])[valid].tolist())
    assert -3 in partners and -5 in partners          # east wall, topography
    assert any(j >= 0 for j in partners)
    # the C-shape contact has two regions: it came through the slow path
    nb = tcol.narrow_phase_batch(tfl, tdom, 64)
    tc = tcol.two_cross_dispatch(*nb.two_cross_args())
    assert int(((tc.cnt > 0) & ~tc.ok).sum()) >= 1


def test_pair_overlaps_binned_field_matches_jax():
    floes, domain, tfl, tdom = _field("periodic", velocity=True)
    bins = _bins_for(floes)
    pair_cap = 8 * floes.capacity
    ref = jcol.pair_overlaps(floes, domain, pair_cap, 16, bins)
    got = tcol.pair_overlaps(tfl, tdom, pair_cap, 16, bins)
    valid = _assert_overlaps(got, ref)
    assert valid.sum() > 100


def _assert_rows(got, ref):
    valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(to_np(got["valid"]), valid)
    assert set(got) == set(ref)
    for k in ("i", "j"):
        np.testing.assert_array_equal(to_np(got[k])[valid], np.asarray(ref[k])[valid],
                                      err_msg=k)
    for k in ("fx", "fy", "px", "py", "torque", "overlap"):
        _close(to_np(got[k])[valid], np.asarray(ref[k])[valid], k)
    assert bool(got["overflow"]) == bool(ref["overflow"])
    return valid


def test_pair_interactions_floes_wall_topography_and_two_regions():
    fl, dom, tfl, tdom = _shapes_pool()
    ref = jcol.pair_interactions(fl, dom, CONSTS, DT, 64, 16)
    got = tcol.pair_interactions(tfl, tdom, port_settings(CONSTS), DT, 64, 16)
    valid = _assert_rows(got, ref)
    # same length, so the same row order: owner rows, mirror rows, slow rows
    assert got["i"].shape == np.asarray(ref["i"]).shape
    j = np.asarray(ref["j"])[valid]
    assert (j == -3).any() and (j == -5).any() and (j >= 0).any()
    # floe-floe contacts are two-sided: every (i, j) row has its (j, i) row
    i = np.asarray(ref["i"])[valid]
    ff = {(a, b) for a, b in zip(i.tolist(), j.tolist()) if b >= 0}
    assert ff and all((b, a) in ff for a, b in ff)
    # the C-shape's two regions are two rows of one pair
    assert max(list(zip(i.tolist(), j.tolist())).count(p) for p in ff) >= 2


def test_pair_interactions_binned_field_matches_jax():
    floes, domain, tfl, tdom = _field("periodic", velocity=True)
    bins = _bins_for(floes)
    pair_cap = 8 * floes.capacity
    consts = Constants(E=6e6)
    ref = jcol.pair_interactions(floes, domain, consts, 10.0, pair_cap, 16, bins)
    got = tcol.pair_interactions(tfl, tdom, port_settings(consts), 10.0,
                                 pair_cap, 16, bins)
    assert _assert_rows(got, ref).sum() > 100


def _square_floe(u=0.0, v=0.0):
    sq = [[-1e4, -1e4], [1e4, -1e4], [1e4, 1e4], [-1e4, 1e4]]
    return build_floes([sq], 0.25, 0.0, FSET, np.random.default_rng(0),
                       dtype=jnp.float64, N=2, u=u, v=v)


@pytest.mark.parametrize("case", ["uniform_ocean", "moving_floe_wind"])
def test_eulerian_oa_coupling_matches_jax(case):
    consts = Constants()
    if case == "uniform_ocean":
        floes = _square_floe()
        ocean = make_ocean(CPL_GRID, u=0.2, v=0.0, temp=0.0, dtype=jnp.float64)
        atmos = make_atmos(CPL_GRID, u=0.0, v=0.0, temp=-1.0, dtype=jnp.float64)
    else:
        floes = _square_floe(u=0.05, v=0.02)._replace(
            xi=jnp.asarray([1e-6, 0.0], jnp.float64))
        ocean = make_ocean(CPL_GRID, u=0.15, v=-0.1, temp=0.0, dtype=jnp.float64)
        atmos = make_atmos(CPL_GRID, u=5.0, v=0.0, temp=-1.0, dtype=jnp.float64)
    ref = jcpl.calc_eulerian_oa_coupling(floes, CPL_GRID, CPL_DOMAIN, ocean,
                                         atmos, consts, cell_cap=7)
    tfl, toc, tat, tdom, tgrid = port_state(floes, CPL_DOMAIN, ocean, atmos, CPL_GRID)
    got = tcpl.calc_eulerian_oa_coupling(tfl, tgrid, tdom, toc, tat,
                                         port_settings(consts), cell_cap=7)
    assert float(ref.fx_oa[0]) != 0
    # the torque of a symmetric square cancels to roundoff: its floor is that
    # of the forces it sums, times the floe's half-width (1e4 m)
    force = max(abs(float(ref.fx_oa[0])), abs(float(ref.fy_oa[0])))
    trq_floor = {"trq_oa": 1e-9 * 1e4 * force}
    assert_fields_close(got, ref, rtol=1e-9, atol_rel=1e-9, atol=trq_floor)
    # and through timestep_coupling's eulerian branch
    cps = CouplingSettings(eulerian=True)
    ref2, _, _ = jcpl.timestep_coupling(floes, CPL_GRID, CPL_DOMAIN, ocean, atmos,
                                        consts, cps, FSET, 10.0, cell_cap=7)
    got2, toc2, overflow = tcpl.timestep_coupling(
        tfl, tgrid, tdom, toc, tat, port_settings(consts), port_settings(cps),
        port_settings(FSET), 10.0, cell_cap=7)
    assert_fields_close(got2, ref2, rtol=1e-9, atol_rel=1e-9, atol=trq_floor)
    assert toc2 is toc and not bool(overflow)


TOPO_COORDS = [
    [[1e4, 0.0], [0.0, 1e4], [1e4, 2e4], [2e4, 1e4]],
    # overlaps the first: de-intersected against it; given closed and clockwise
    [[1.5e4, 0.5e4], [1.5e4, 2.5e4], [3.5e4, 2.5e4], [3.5e4, 0.5e4], [1.5e4, 0.5e4]],
    [[[-5e4, -5e4], [-4e4, -5e4], [-4e4, -4e4], [-5e4, -4e4]]],  # ring nesting
]


def test_make_topography_matches_jax():
    ref = jax_make_topography(TOPO_COORDS, V=16, dtype=jnp.float64)
    got = torch_make_topography(TOPO_COORDS, V=16, dtype=torch.float64, device="cpu")
    assert got.count == ref.count >= 3
    assert_fields_close(got, ref, rtol=1e-12, atol_rel=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_make_topography(TOPO_COORDS, dtype=torch.float64)
    # a domain with topography comes over from the JAX package as it is
    _, _, _, tdom, _ = port_state(_square_floe(), TOPO_DOMAIN)
    assert_fields_close(tdom.topography, TOPO_DOMAIN.topography, rtol=0, atol_rel=0)


def test_polygon_helpers_match_jax():
    from subzero_tpu.geometry import polygon as jpoly

    cw = np.array(CSHAPE)[::-1]
    jv, jn = jpoly.pad_polygon(np.vstack([cw, cw[:1]]), 12, dtype=jnp.float64)
    tv, tn = pad_polygon(np.vstack([cw, cw[:1]]), 12, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
    assert int(tn) == int(jn) == 8 and tn.dtype == torch.int32
    np.testing.assert_array_equal(to_np(ensure_ccw(tv, tn)),
                                  np.asarray(jpoly.ensure_ccw(jv, jn)))
    ccw = ensure_ccw(tv, tn)
    np.testing.assert_allclose(to_np(interior_angles(ccw, tn)),
                               np.asarray(jpoly.interior_angles(jpoly.ensure_ccw(jv, jn), jn)),
                               rtol=1e-12)
    for g, r in zip(poly_bounds(tv, tn), jpoly.poly_bounds(jv, jn)):
        assert float(g) == float(r)
    pts = np.random.default_rng(0).uniform(0, 4e4, (64, 2))
    np.testing.assert_array_equal(
        to_np(points_in_polygon(torch.from_numpy(pts), ccw, tn)),
        np.asarray(jpoly.points_in_polygon(jnp.asarray(pts), jpoly.ensure_ccw(jv, jn), jn)))
    # intersect_area of a batch: the C-shape against the corner rectangle
    rv, rn = pad_polygon(CORNER_RECT, 12, dtype=torch.float64, device="cpu")
    rv = ensure_ccw(rv, rn)
    got = intersect_area(ccw[None], tn[None], rv[None], rn[None])
    want = sum(thost.poly_area_np(p) for p in thost.intersect(
        to_np(ccw)[:8], to_np(rv)[:4]))
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-9)
    assert float(poly_area(ccw, tn)) > want > 0


def _clip_pairs():
    sq = np.array([[0.0, 0.0], [2e4, 0.0], [2e4, 2e4], [0.0, 2e4]])
    tri = np.array([[1e4, 1e4], [3e4, 1e4], [2e4, 3e4]])
    cshape = np.array(
        [[0.0, 0.0], [2e4, 0.0], [2e4, 5e3], [5e3, 5e3], [5e3, 1.5e4],
         [2e4, 1.5e4], [2e4, 2e4], [0.0, 2e4]])
    pairs = [(sq, tri), (cshape, sq + np.array([1.2e4, 0.0])),
             (sq, sq + np.array([3e4, 3e4])),          # disjoint
             (sq, sq * 0.25 + np.array([5e3, 5e3]))]   # containment
    # Voronoi cells of a seeded field, each against a shifted neighbour
    rng = np.random.default_rng(12)
    cells = voronoi_cells_in_box(rng.uniform(0, 1e5, (14, 2)), np.zeros(2),
                                 np.full(2, 1e5))
    cells = [thost._clean_ring(np.asarray(c, float)) for c in cells if len(c) >= 3]
    for a, b in zip(cells[0::2], cells[1::2]):
        pairs.append((a, b + (a.mean(0) - b.mean(0)) + np.array([137.0, -211.0])))
    return pairs


def _canon(rings):
    return sorted((round(thost.poly_area_np(np.asarray(r)), 6),
                   tuple(sorted(map(tuple, np.round(np.asarray(r), 6)))))
                  for r in rings)


@pytest.mark.parametrize("op", ["and", "or", "diff"])
def test_native_clip_matches_python_clip(op):
    assert tnative.available(), "g++ build of subzero_tpu_torch/native/clip.cpp failed"
    assert "subzero_tpu_torch" in str(tnative.LIB_PATH) and "_build" in str(tnative.LIB_PATH)
    pairs = _clip_pairs()
    assert len(pairs) >= 9
    for a, b in pairs:
        py = thost._with_retries_py(a, b, op)
        nat = tnative.poly_boolean(op, a, b)
        assert nat is not None and _canon(py) == _canon(nat), op
        # and the routed entry point gives the same rings
        routed = {"and": thost.intersect, "or": thost.union,
                  "diff": thost.difference}[op](a, b)
        assert _canon(routed) == _canon(nat)


def test_native_pairwise_intersect_area_matches_python_clip():
    pairs = _clip_pairs()
    V = max(max(len(a), len(b)) for a, b in pairs)
    polys = [p for pair in pairs for p in pair]
    verts = np.zeros((len(polys), V, 2))
    nverts = np.zeros((len(polys),), np.int32)
    for i, p in enumerate(polys):
        verts[i, : len(p)], nverts[i] = p, len(p)
    ia = np.arange(0, len(polys), 2, dtype=np.int32)
    areas = tnative.pairwise_intersect_area(verts, nverts, ia, ia + 1)
    for k, (a, b) in enumerate(pairs):
        want = sum(thost.poly_area_np(r) for r in thost._with_retries_py(a, b, "and"))
        assert areas[k] == pytest.approx(want, rel=1e-9, abs=1e-6)
