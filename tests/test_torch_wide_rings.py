"""Rings wider than 32 vertices and more than 32 crossings a row, through the
port's collision step and overlap query against the JAX package's.

The JAX package takes any ring width and any ``clip_cap``; so does the port,
whose kernels take rings of up to 128 vertices and CAP up to 64 (B1 and B2,
csrc/two_cross.cu and csrc/intersect_regions.cu).  The field here is a pool
of width V = 40 on a domain whose topography is one 40-vertex polygon:

  * a comb of 10 teeth (40 vertices) across which a bar floe lies: one row
    of 40 crossings, 10 regions, more than CAP 32 and within CAP 48;
  * a bar floe across the teeth of the 40-vertex topography comb: a row of
    the Q pool's topography with 40 crossings;
  * a small rectangle over the bar's end: a clean two-crossing contact.

``timestep_collisions`` (``clip_cap`` 48, with its overflow counters) and
``pair_overlaps`` run in both packages, and in the port once through its
plain versions and once through the kernels' g++ shims (the kernels'
arithmetic in their order: csrc/two_cross_host.cpp and
csrc/intersect_regions_host.cpp), all in f64 at rtol 1e-9 (absolute floor
1e-9 of each field's largest magnitude), counters and flags exact.  On the
card the same field runs through the kernels themselves
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from subzero_tpu.core import make_domain, make_topography
from subzero_tpu.core.floes import build_floes
from subzero_tpu.physics import collisions as jcol
from subzero_tpu_torch.geometry import regions
from subzero_tpu_torch.physics import collisions as tcol

from test_collisions import CONSTS, CSET, DT, FSET, GRID, C, O, P
from test_torch_collisions import assert_same_counters
from torch_port_helpers import (
    WIDE_CLIP_CAP,
    WIDE_PAIR_CAP,
    WIDE_U,
    WIDE_V,
    WIDE_V_VEL,
    assert_fields_close,
    build_host_shim,
    build_regions_shim,
    port_settings,
    port_state,
    run_host_shim_pairs,
    to_np,
    wide_field_coords,
)

def _field():
    """(JAX floes, JAX domain, port floes, port domain): the four floes of
    ``wide_field_coords`` in a pool of 6, width 40, on test_collisions'
    grid (periodic N/S, collision E, open W) with the topography comb."""
    coords, topo_coords = wide_field_coords()
    topo = make_topography(topo_coords, V=WIDE_V, dtype=jnp.float64)
    dom = make_domain(GRID, P, P, C, O, topography=topo, dtype=jnp.float64)
    fl = build_floes(coords, 0.25, 0.0, FSET, np.random.default_rng(0), N=6,
                     V=WIDE_V, P=WIDE_V, dtype=jnp.float64)
    fl = fl._replace(u=jnp.asarray(WIDE_U, jnp.float64),
                     v=jnp.asarray(WIDE_V_VEL, jnp.float64))
    tfl, _, _, tdom, _ = port_state(fl, dom)
    return fl, dom, tfl, tdom


@pytest.fixture(scope="module")
def shims(tmp_path_factory):
    d = tmp_path_factory.mktemp("wide_shims")
    return build_host_shim(d), build_regions_shim(d)


def _route(name, shims, monkeypatch):
    """Send the port's narrow phase and slow clip through the kernels' g++
    shims (``kernels``) or leave them on the plain versions (``plain``)."""
    if name == "kernels":
        b1, b2 = shims
        monkeypatch.setattr(tcol, "two_cross_dispatch",
                            lambda *a: run_host_shim_pairs(b1, *a))
        monkeypatch.setattr(tcol, "intersect_regions_dispatch",
                            lambda *a: regions.run_host_shim(b2, *a))


def test_the_field_is_wide():
    """The pool and the topography are 40 wide, both combs have 40
    vertices, and the comb rows cross 40 times: past CAP 32 (the JAX
    package's clip overflows there) and within CAP 48."""
    fl, dom, tfl, tdom = _field()
    assert tfl.verts.shape[1] == WIDE_V and tdom.topography.verts.shape[1] == WIDE_V
    assert int(tfl.nverts[0]) == 40 and int(tdom.topography.nverts[0]) == 40
    nb = tcol.narrow_phase_batch(tfl, tdom, WIDE_PAIR_CAP)
    tc = tcol.two_cross_dispatch(*nb.two_cross_args())
    assert sorted(int(c) for c in tc.cnt[tc.cnt > 2]) == [40, 40]
    assert int((tc.ok & (tc.cnt == 2)).sum()) >= 1
    _, d32 = jcol.timestep_collisions(fl, dom, CONSTS, DT, CSET, WIDE_PAIR_CAP, 32,
                                      with_debug=True)
    _, d48 = jcol.timestep_collisions(fl, dom, CONSTS, DT, CSET, WIDE_PAIR_CAP, WIDE_CLIP_CAP,
                                      with_debug=True)
    assert bool(d32["clip_overflow"]) and not bool(d48["clip_overflow"])
    assert int(d48["n_slow"]) == 2


_jax_collide = jax.jit(
    jcol.timestep_collisions,
    static_argnames=("consts", "dt", "collision_settings", "pair_cap",
                     "clip_cap", "with_debug"),
)


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_timestep_collisions_on_wide_rings_matches_jax(route, shims, monkeypatch):
    fl, dom, tfl, tdom = _field()
    ref, dbg = _jax_collide(fl, dom, consts=CONSTS, dt=DT, collision_settings=CSET,
                            pair_cap=WIDE_PAIR_CAP, clip_cap=WIDE_CLIP_CAP, with_debug=True)
    _route(route, shims, monkeypatch)
    got, tdbg = tcol.timestep_collisions(tfl, tdom, port_settings(CONSTS), DT,
                                         port_settings(CSET), WIDE_PAIR_CAP, WIDE_CLIP_CAP,
                                         with_debug=True)
    assert_same_counters(tdbg, dbg)
    assert_fields_close(got.floes, ref.floes, what="floes.")
    stress = np.asarray(ref.stress_instant)
    np.testing.assert_allclose(got.stress_instant.numpy(), stress, rtol=1e-9,
                               atol=1e-9 * float(np.abs(stress).max()))
    assert bool(got.overflow) == bool(ref.overflow) is False
    # every floe in contact felt it: the comb, both bars and the rectangle
    assert (np.abs(np.asarray(ref.floes.collision_force)[:4]).sum(1) > 0).all()


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_pair_overlaps_on_wide_rings_matches_jax(route, shims, monkeypatch):
    fl, dom, tfl, tdom = _field()
    ref = jcol.pair_overlaps(fl, dom, WIDE_PAIR_CAP, WIDE_CLIP_CAP)
    _route(route, shims, monkeypatch)
    got = tcol.pair_overlaps(tfl, tdom, WIDE_PAIR_CAP, WIDE_CLIP_CAP)
    valid = np.asarray(ref[3])
    np.testing.assert_array_equal(to_np(got[3]), valid)
    for k in (0, 1):
        np.testing.assert_array_equal(to_np(got[k])[valid], np.asarray(ref[k])[valid])
    area = np.asarray(ref[2])[valid]
    np.testing.assert_allclose(to_np(got[2])[valid], area, rtol=1e-9,
                               atol=1e-9 * float(np.abs(area).max()))
    assert bool(got[4]) == bool(ref[4])
    # the comb and its bar, the topography and its bar, the bar and the
    # rectangle
    pairs = {frozenset((int(i), int(j))) for i, j in zip(np.asarray(ref[0])[valid],
                                                         np.asarray(ref[1])[valid])}
    assert {frozenset((0, 1)), frozenset((1, 3)), frozenset((2, -5))} <= pairs
