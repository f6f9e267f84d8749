"""The port's binned broad phase against the JAX package's, on numpy-seeded
fields (periodic, open and walled with topography, as tests/test_binned.py):
the candidate list is equal element for element (qi, qj, shift, valid,
overflow: exact, the shifts are sums of the same box lengths), binned and
dense give the same canonical pair set exactly once, both overflow causes
fire, a grid under three bins wide takes the 3x3 fallback, and one
``timestep_collisions`` with ``bins`` set matches at f64 rtol 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest

from subzero_tpu.constants import Constants
from subzero_tpu.core import (
    BoundaryKind,
    initialize_floe_field,
    make_domain,
    make_grid,
)
from subzero_tpu.core.domain import make_topography
from subzero_tpu.physics import collisions as jcol
from subzero_tpu.settings import CollisionSettings, FloeSettings, SubGridPointsGenerator
from subzero_tpu_torch.physics import collisions as tcol

from torch_port_helpers import assert_fields_close, port_settings, port_state, to_np

FS = FloeSettings(min_floe_area=1e6,
                  subfloe_point_generator=SubGridPointsGenerator(1e9))
TOPO = [[[4.0e4, 4.0e4], [4.0e4, 5.2e4], [5.2e4, 5.2e4], [5.2e4, 4.0e4]]]


def _field(kind, n=200, seed=5, topo=False, velocity=False):
    """A 1e5 m box of ``n`` Voronoi floes in both packages.  ``velocity``
    also grows every ring by 3 % about its centroid (the cells start flush)
    and gives the floes random velocities, so that contacts carry forces."""
    grid = make_grid(0.0, 1e5, 0.0, 1e5, dx=2e3, dy=2e3)
    kinds = {"periodic": BoundaryKind.PERIODIC, "open": BoundaryKind.OPEN,
             "walled": BoundaryKind.COLLISION}
    topography = make_topography(TOPO, dtype=jnp.float64) if topo else None
    domain = make_domain(grid, *([kinds[kind]] * 4), topography=topography,
                         dtype=jnp.float64)
    floes = initialize_floe_field(n, [0.8], domain, 0.25, 0.0, FS,
                                  rng=np.random.default_rng(seed),
                                  dtype=jnp.float64, shrink_frac=0.0)
    if velocity:
        rng = np.random.default_rng(seed + 1)
        act = np.asarray(floes.active)
        c = np.asarray(floes.centroid)[:, None, :]
        floes = floes._replace(
            verts=jnp.asarray(c + 1.03 * (np.asarray(floes.verts) - c)),
            rmax=floes.rmax * 1.03,
            u=jnp.asarray(np.where(act, rng.normal(0, 0.3, act.shape), 0.0)),
            v=jnp.asarray(np.where(act, rng.normal(0, 0.3, act.shape), 0.0)))
    tfl, _, _, tdom, _ = port_state(floes, domain)
    return floes, domain, tfl, tdom


def _bins_for(floes, M=64):
    rmax = float(np.max(np.asarray(floes.rmax)))
    nb = max(int(1e5 / (2.2 * rmax)), 1)
    return (nb, nb, M)


def _assert_same_list(got, ref):
    for f in ("qi", "qj", "valid", "overflow"):
        np.testing.assert_array_equal(to_np(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(to_np(got.shift), np.asarray(ref.shift))


def _pairset(p, N):
    """Canonical unordered pairs of a list, each exactly once
    (tests/test_binned.py:pairset)."""
    v = to_np(p.valid).astype(bool)
    qi, qj = to_np(p.qi)[v], to_np(p.qj)[v]
    sx = to_np(p.shift)[v][:, 0].round(3) + 0.0
    sy = to_np(p.shift)[v][:, 1].round(3) + 0.0
    out = set()
    for i, j, x, y in zip(qi.tolist(), qj.tolist(), sx.tolist(), sy.tolist()):
        if j < N and j < i:
            i, j, x, y = j, i, -x + 0.0, -y + 0.0
        out.add((i, j, x, y))
    assert len(out) == len(qi)  # a duplicate would vanish in the set
    return out


CASES = {
    "periodic": dict(kind="periodic"),
    "open": dict(kind="open"),
    "walled_topography": dict(kind="walled", topo=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_binned_list_equals_jax_element_for_element(case):
    floes, domain, tfl, tdom = _field(**CASES[case])
    bins = _bins_for(floes)
    assert bins[0] >= 3
    pair_cap = 8 * floes.capacity
    ref = jcol.find_candidate_pairs(floes, domain, pair_cap, bins)
    got = tcol.find_candidate_pairs(tfl, tdom, pair_cap, bins)
    assert int(np.asarray(ref.valid).sum()) > 100 and not bool(ref.overflow)
    _assert_same_list(got, ref)
    if case == "walled_topography":
        N = floes.capacity
        qj = np.asarray(ref.qj)[np.asarray(ref.valid)]
        assert ((qj >= N) & (qj < N + 4)).any() and (qj == N + 4).any()


@pytest.mark.parametrize("case", list(CASES))
def test_binned_and_dense_give_the_same_pair_set_once(case):
    floes, _, tfl, tdom = _field(**CASES[case])
    pair_cap = 8 * tfl.capacity
    dense = tcol.find_candidate_pairs(tfl, tdom, pair_cap)
    binned = tcol.find_candidate_pairs(tfl, tdom, pair_cap, _bins_for(floes))
    assert not bool(dense.overflow) and not bool(binned.overflow)
    assert _pairset(dense, tfl.capacity) == _pairset(binned, tfl.capacity)


def test_bin_over_capacity_sets_overflow():
    floes, domain, tfl, tdom = _field("periodic")
    nb = _bins_for(floes)[0]
    bins = (nb, nb, 2)  # the fullest bin holds more than two floes
    ref = jcol.find_candidate_pairs(floes, domain, 8 * floes.capacity, bins)
    got = tcol.find_candidate_pairs(tfl, tdom, 8 * tfl.capacity, bins)
    assert bool(ref.overflow) and bool(got.overflow)
    _assert_same_list(got, ref)


def test_floes_wider_than_a_bin_set_overflow():
    floes, domain, tfl, tdom = _field("periodic")
    nb = 3 * _bins_for(floes)[0]  # bins a third as wide as the rule asks
    bins = (nb, nb, 64)
    ref = jcol.find_candidate_pairs(floes, domain, 8 * floes.capacity, bins)
    got = tcol.find_candidate_pairs(tfl, tdom, 8 * tfl.capacity, bins)
    assert bool(ref.overflow) and bool(got.overflow)
    _assert_same_list(got, ref)


def test_two_bins_wide_periodic_takes_the_3x3_fallback():
    """nbx = nby = 2 under periodic wrap: the half-shell's forward and
    backward offsets would land on the same bin, so all nine offsets are
    enumerated with parity ownership.  9 M floe columns instead of 5 M."""
    floes, domain, tfl, tdom = _field("periodic", n=30, seed=2)
    bins = (2, 2, 48)
    pair_cap = 16 * floes.capacity
    ref = jcol.find_candidate_pairs(floes, domain, pair_cap, bins)
    got = tcol.find_candidate_pairs(tfl, tdom, pair_cap, bins)
    _assert_same_list(got, ref)
    # the bins are wider than 2 rmax only if the floes are small enough;
    # either way the list is the reference's, and where the guarantee holds
    # it is the dense list's pair set
    dense = tcol.find_candidate_pairs(tfl, tdom, pair_cap)
    if not bool(got.overflow):
        assert _pairset(dense, tfl.capacity) == _pairset(got, tfl.capacity)
    # an open box of the same bins keeps the half-shell: other columns
    _, _, ofl, odom = _field("open", n=30, seed=2)
    half = tcol.find_candidate_pairs(ofl, odom, pair_cap, bins)
    assert half.qi.shape == got.qi.shape  # same capacities either way


def test_rows_that_spill_go_to_the_second_chance_list():
    """A list of 8 rows a floe (the floor) on a dense field: rows with more
    candidates spill into the second-chance block, as in the JAX package."""
    floes, domain, tfl, tdom = _field("periodic", n=200, seed=5)
    N = floes.capacity
    bins = _bins_for(floes)
    ref = jcol.find_candidate_pairs(floes, domain, N, bins)
    got = tcol.find_candidate_pairs(tfl, tdom, N, bins)
    _assert_same_list(got, ref)
    assert got.qi.shape[0] == N * 8 + max(N // 2, 64)


def test_timestep_collisions_with_bins_matches_jax():
    floes, domain, tfl, tdom = _field("periodic", velocity=True)
    bins = _bins_for(floes)
    consts = Constants(E=6e6)
    cls = CollisionSettings()
    pair_cap = 8 * floes.capacity
    ref = jcol.timestep_collisions(floes, domain, consts, 10.0, cls, pair_cap,
                                   16, bins)
    got = tcol.timestep_collisions(tfl, tdom, port_settings(consts), 10.0,
                                   port_settings(cls), pair_cap, 16, bins)
    assert float(np.abs(np.asarray(ref.floes.collision_force)).max()) > 0
    assert bool(got.overflow) == bool(ref.overflow) is False
    assert_fields_close(got.floes, ref.floes, rtol=1e-9, atol_rel=1e-9)
    np.testing.assert_allclose(
        to_np(got.stress_instant), np.asarray(ref.stress_instant), rtol=1e-9,
        atol=1e-9 * float(np.abs(np.asarray(ref.stress_instant)).max()))
    # the dense step of the port finds the same contacts; which floe of a
    # pair is the clipped side differs (ownership), and with it the side the
    # degeneracy-breaking offset moves, so forces agree to 1e-3 of the
    # largest only (the grown Voronoi cells overlap along near-parallel edges)
    dense = tcol.timestep_collisions(tfl, tdom, port_settings(consts), 10.0,
                                     port_settings(cls), pair_cap, 16, None)
    np.testing.assert_allclose(
        to_np(dense.floes.collision_force), to_np(got.floes.collision_force),
        rtol=0, atol=1e-3 * float(got.floes.collision_force.abs().max()))
