"""The port's collision slow path and candidate-row compaction against the
JAX reference.

timestep_collisions on packed 40-floe periodic fields whose slow path
(multi-crossing pairs through the general clip) is empty, inside the first
tier of 8 rows, beyond it, beyond its capacity, and retried for parity:
every field of CollisionResult, f64, rtol 1e-9 (absolute floor 1e-9 of each
field's largest magnitude).  _rank_select_rows on both of the reference's
formulations (cumsum rank and top_k), exactly.  And the step gives the same
bits whether the narrow phase or the step's own masks zero the invalid rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.core import BoundaryKind, make_domain
from subzero_tpu.physics import collisions as jcol
from subzero_tpu_torch.geometry.clip import gather_rings, two_cross_pass
from subzero_tpu_torch.physics import collisions as tcol

from test_collisions import CONSTS, CSET, DT, GRID, OPEN_DOMAIN
from test_torch_collisions import _compare, _floes
from torch_port_helpers import port_settings, port_state


def _star(rng, nv, cx, cy, r0, spike):
    th = np.sort(rng.random(nv)) * 2 * np.pi
    r = r0 * (1 - spike / 2 + spike * rng.random(nv))
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)


def _packed_field(r0, spike, seed=0):
    """40 star floes on a jittered 8 x 5 lattice over the periodic domain;
    the star radius and spikiness set how many neighbours overlap and how
    many contacts cross more than twice."""
    rng = np.random.default_rng(seed)
    polys = []
    for i in range(8):
        for j in range(5):
            cx = -1e5 + (i + 0.5) * 2.5e4 + rng.uniform(-2e3, 2e3)
            cy = -1e5 + (j + 0.5) * 4e4 + rng.uniform(-2e3, 2e3)
            polys.append(_star(rng, int(rng.integers(5, 17)), cx, cy, r0, spike))
    us = rng.uniform(-0.3, 0.3, 40)
    vs = rng.uniform(-0.3, 0.3, 40)
    return _floes(polys, us, vs, N=40)


PERIODIC_DOMAIN = make_domain(GRID, *([BoundaryKind.PERIODIC] * 4), dtype=jnp.float64)
# (r0, spike, clip_cap, the slow-pair count it must give)
PACKED_CASES = {
    "no_slow_pairs": (1.3e4, 0.0, 16, lambda n: n == 0),
    "inside_first_tier": (1.8e4, 1.0, 16, lambda n: 0 < n <= 8),
    "beyond_first_tier": (2.2e4, 1.2, 16, lambda n: 8 < n <= 32),
    "beyond_slow_cap": (2.4e4, 1.4, 16, lambda n: n > 32),
    "parity_retry": (2.2e4, 1.2, 4, lambda n: n > 0),
}


@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_periodic_field_slow_path(case):
    r0, spike, clip_cap, n_slow_ok = PACKED_CASES[case]
    ref, dbg = _compare(_packed_field(r0, spike), PERIODIC_DOMAIN,
                        pair_cap=320, clip_cap=clip_cap)
    assert n_slow_ok(int(dbg["n_slow"])), int(dbg["n_slow"])
    if case == "parity_retry":
        assert int(dbg["n_parity_bad"]) > 0
    if case == "beyond_slow_cap":
        assert bool(ref.overflow)


def crowded_ring(n_ring=40, seed=0):
    """One 12-gon of radius 2e4 m (pool row 0) ringed by ``n_ring`` small
    squares whose bounding circles reach into its own: floe 0 owns the pairs
    of the even rows ((i + j) parity), so its row holds n_ring / 2 candidates,
    more than the 8 rows a floe of ``pair_cap`` = 8N plus the 8 a floe may
    spill (collisions._rank_select_rows).  Returns the JAX pool (f64)."""
    rng = np.random.default_rng(seed)
    th = np.arange(12) * 2 * np.pi / 12
    polys = [np.stack([2e4 * np.cos(th), 2e4 * np.sin(th)], 1)]
    for k in range(n_ring):
        a = 2 * np.pi * k / n_ring + rng.uniform(-0.01, 0.01)
        cx, cy = 2.1e4 * np.cos(a), 2.1e4 * np.sin(a)
        polys.append(np.array([[cx - 1.4e3, cy - 1.4e3], [cx + 1.4e3, cy - 1.4e3],
                               [cx + 1.4e3, cy + 1.4e3], [cx - 1.4e3, cy + 1.4e3]]))
    return _floes(polys, [0.0] * len(polys), [0.0] * len(polys), N=len(polys))


def test_crowded_floe_overflows_its_candidate_row():
    """A floe with more candidates than its row and the spill list hold
    fires ``pairs_overflow`` in both packages, with equal counters and
    fields (the candidates that fit are computed alike)."""
    jfl = crowded_ring()
    ref, dbg = _compare(jfl, OPEN_DOMAIN, pair_cap=8 * jfl.capacity)
    assert bool(dbg["pairs_overflow"]) and bool(ref.overflow)
    assert int(dbg["n_slow"]) <= int(dbg["slow_cap"])


@pytest.mark.parametrize("case", ["inside_first_tier", "parity_retry"])
def test_invalid_rows_zeroed_by_narrow_phase_or_by_step_masks(case, monkeypatch):
    """The narrow phase zeroes the rows of the fixed-shape pair list that are
    no candidate pair, and timestep_collisions masks them no more.  A narrow
    phase that leaves them as computed (garbage pairs of clamped indices),
    wrapped in the masks the step used to apply (cnt, contain and ok where
    the row is valid), must give a bit-identical CollisionResult."""
    r0, spike, clip_cap, _ = PACKED_CASES[case]
    tfl, _, _, tdom, _ = port_state(_packed_field(r0, spike), PERIODIC_DOMAIN)
    args = (tfl, tdom, port_settings(CONSTS), DT, port_settings(CSET), 320, clip_cap)
    got = tcol.timestep_collisions(*args)

    seen = {}

    def unmasked_then_step_masks(p_verts, p_n, q_verts, q_n, qi, qj, shift,
                                 perturb, valid):
        pv, pn, qv, qn = gather_rings(p_verts, p_n, q_verts, q_n, qi, qj, shift)
        tc = two_cross_pass(pv, pn, qv, qn, perturb)
        seen["garbage"] = bool((tc.cnt[~valid] != 0).any())
        return tc._replace(cnt=torch.where(valid, tc.cnt, 0),
                           contain=torch.where(valid, tc.contain, 0.0),
                           ok=valid & tc.ok)

    monkeypatch.setattr(tcol, "two_cross_dispatch", unmasked_then_step_masks)
    ref = tcol.timestep_collisions(*args)
    assert seen["garbage"]  # the invalid rows did hold something to mask
    for f, g, r in zip(ref.floes._fields, got.floes, ref.floes):
        assert torch.equal(g, r), f
    assert torch.equal(got.stress_instant, ref.stress_instant)
    assert bool(got.overflow) == bool(ref.overflow)


@pytest.mark.parametrize(
    "N,C,row_cap,extra_cap,density",
    [
        (50, 54, 8, 64, 0.3),        # cumsum-rank formulation, with spills
        (20, 30, 8, 0, 0.2),         # no second-chance list
        (16, 8192, 4096, 0, 0.4),    # N*C*row_cap > 3 << 27: top_k formulation
        (16, 8192, 4096, 16, 0.55),  # top_k formulation, with spills
    ],
)
def test_rank_select_rows(N, C, row_cap, extra_cap, density):
    mask = np.random.default_rng(N + C).random((N, C)) < density
    ref = jcol._rank_select_rows(jnp.asarray(mask), row_cap, extra_cap=extra_cap)
    got = tcol._rank_select_rows(torch.from_numpy(mask), row_cap, extra_cap=extra_cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
