"""The port's host life-cycle passes (``physics/lifecycle_host.py``: numpy on
the host) against the JAX package's, each on the same pool and the same
``np.random.default_rng(seed)``: every field of the returned pool agrees at
f64 rtol 1e-12 (absolute floor 1e-12 of the field's largest magnitude;
integer and boolean fields exact), the largest floe id is equal, and the two
generators are left in the same state (every draw came in the same order).

The pool is a numpy-seeded Voronoi field in a walled box, every ring grown
by 4 % about its centroid so that neighbours overlap and the outer floes
cross the walls, with random velocities and a random symmetric stress."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.constants import Constants
from subzero_tpu.core import (
    BoundaryKind,
    initialize_floe_field,
    make_domain,
    make_grid,
)
from subzero_tpu.core.floes import FloeState as JaxFloeState
from subzero_tpu.physics import collisions as jcol
from subzero_tpu.physics import lifecycle_host as jlh
from subzero_tpu.settings import (
    FloeSettings,
    FractureSettings,
    HiblerYieldCurve,
    RidgeRaftSettings,
    SimplificationSettings,
    SubGridPointsGenerator,
    WeldSettings,
)
from subzero_tpu_torch.convert import to_numpy_state
from subzero_tpu_torch.physics import lifecycle_host as tlh

from torch_port_helpers import assert_fields_close, port_settings, port_state, to_np

GRID = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
FS = FloeSettings(min_floe_area=1e6,
                  subfloe_point_generator=SubGridPointsGenerator.from_grid(GRID, 2))
DT = 10.0
TOL = dict(rtol=1e-12, atol_rel=1e-12)


def _pool(seed=4, n=30, N=128, grow=1.04):
    domain = make_domain(GRID, *([BoundaryKind.COLLISION] * 4), dtype=jnp.float64)
    floes = initialize_floe_field(n, [0.7], domain, 0.5, 0.1, FS,
                                  rng=np.random.default_rng(seed),
                                  dtype=jnp.float64, N=N)
    rng = np.random.default_rng(seed + 100)
    act = np.asarray(floes.active)
    c = np.asarray(floes.centroid)[:, None, :]
    s = rng.normal(0, 2e4, (N, 2, 2))
    s = np.where(act[:, None, None], 0.5 * (s + s.transpose(0, 2, 1)), 0.0)
    floes = floes._replace(
        verts=jnp.asarray(c + grow * (np.asarray(floes.verts) - c)),
        rmax=floes.rmax * grow,
        area=floes.area * grow**2,
        mass=floes.mass * grow**2,
        moment=floes.moment * grow**4,
        u=jnp.asarray(np.where(act, rng.normal(0, 0.2, N), 0.0)),
        v=jnp.asarray(np.where(act, rng.normal(0, 0.2, N), 0.0)),
        xi=jnp.asarray(np.where(act, rng.normal(0, 1e-6, N), 0.0)),
        stress_accum=jnp.asarray(s),
    )
    tfl, _, _, tdom, tgrid = port_state(floes, domain, grid=GRID)
    return floes, domain, tfl, tdom, tgrid


def _both(jax_fn, torch_fn, seed=9):
    """Call a pass in both packages with generators from one seed; returns
    the results after checking that the generators ended in one state."""
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    ref, got = jax_fn(r1), torch_fn(r2)
    assert r1.bit_generator.state == r2.bit_generator.state
    return ref, got, r1.bit_generator.state != np.random.default_rng(seed).bit_generator.state


def _overlaps(floes, domain):
    """(i, j, area) rows of the JAX package's pair_overlaps, as run() builds
    them for the ridge/raft pass."""
    i, j, area, valid, overflow = jcol.pair_overlaps(floes, domain, 32 * 128, 16)
    assert not bool(overflow)
    m = np.asarray(valid)
    return list(zip(np.asarray(i)[m].tolist(), np.asarray(j)[m].tolist(),
                    np.asarray(area)[m].tolist()))


def test_host_floes_round_trip_keeps_device_dtypes_and_copies():
    _, _, tfl, _, _ = _pool()
    hf = tlh.HostFloes(tfl)
    hf.fields["height"][0] = 123.0  # an edit on the host ...
    assert float(tfl.height[0]) != 123.0  # ... never reaches the source pool
    back = hf.to_state()
    for f, x, y in zip(tfl._fields, tfl, back):
        assert x.dtype == y.dtype and x.device == y.device and x.shape == y.shape, f
    assert float(back.height[0]) == 123.0
    # the way back to the JAX package: a dict of numpy arrays by field name
    d = to_numpy_state(tfl)
    again = JaxFloeState(**{k: jnp.asarray(v) for k, v in d.items()})
    assert_fields_close(tfl, again, rtol=0, atol_rel=0)
    d["height"][0] = -1.0
    assert float(tfl.height[0]) != -1.0


def test_fracture_floes_matches_jax():
    floes, _, tfl, _, _ = _pool()
    fr = FractureSettings(fractures_on=True, criteria=HiblerYieldCurve(), dt=1,
                          npieces=3)
    mid = int(np.asarray(floes.id).max())
    (ref, m1), (got, m2), drew = _both(
        lambda r: jlh.fracture_floes(floes, mid, r, fr, FS, DT, None),
        lambda r: tlh.fracture_floes(tfl, mid, r, port_settings(fr),
                                     port_settings(FS), DT, None))
    assert drew and m1 == m2 > mid  # floes fractured
    assert int(np.asarray(ref.active).sum()) > int(np.asarray(floes.active).sum())
    assert_fields_close(got, ref, **TOL)


def test_fracture_floes_with_deform_rows_matches_jax():
    floes, domain, tfl, _, _ = _pool()
    rows = jcol.pair_interactions(floes, domain, Constants(E=1e6), DT, 32 * 128, 16)
    m = np.asarray(rows["valid"])
    assert m.sum() > 10
    overlaps = list(zip(*(np.asarray(rows[k])[m].tolist()
                          for k in ("i", "j", "overlap", "fx", "fy"))))
    fr = FractureSettings(fractures_on=True, criteria=HiblerYieldCurve(), dt=1,
                          npieces=3, deform_on=True)
    mid = int(np.asarray(floes.id).max())
    (ref, m1), (got, m2), drew = _both(
        lambda r: jlh.fracture_floes(floes, mid, r, fr, FS, DT, overlaps),
        lambda r: tlh.fracture_floes(tfl, mid, r, port_settings(fr),
                                     port_settings(FS), DT, overlaps))
    assert drew and m1 == m2 > mid
    assert_fields_close(got, ref, **TOL)
    # the deformation moved the pieces off the plain fracture's
    plain, _ = jlh.fracture_floes(floes, mid, np.random.default_rng(9),
                                  FractureSettings(fractures_on=True,
                                                   criteria=HiblerYieldCurve(),
                                                   dt=1, npieces=3), FS, DT, None)
    assert not np.array_equal(np.asarray(plain.area), np.asarray(ref.area))


def test_fuse_floes_matches_jax():
    floes, domain, tfl, _, _ = _pool()
    pairs = [(i, j) for i, j, _ in _overlaps(floes, domain) if j >= 0][:4]
    assert len(pairs) >= 3
    fw = np.full(floes.capacity, -1, np.int32)
    for i, j in pairs:
        fw[i] = j
    floes = floes._replace(fuse_with=jnp.asarray(fw))
    tfl = tfl._replace(fuse_with=torch.from_numpy(fw))
    mid = int(np.asarray(floes.id).max())
    (ref, m1), (got, m2), _ = _both(
        lambda r: jlh.fuse_floes(floes, mid, FS, DT, r),
        lambda r: tlh.fuse_floes(tfl, mid, port_settings(FS), DT, r))
    assert m1 == m2 > mid
    assert int(np.asarray(ref.active).sum()) < int(np.asarray(floes.active).sum())
    assert_fields_close(got, ref, **TOL)


def test_smooth_floes_matches_jax():
    floes, _, tfl, _, _ = _pool()
    sp = SimplificationSettings(smooth_vertices_on=True, max_vertices=5, tol=800.0)
    nv0 = np.asarray(floes.nverts)
    assert (nv0 > 5).sum() >= 5
    ref, got, _ = _both(
        lambda r: jlh.smooth_floes(floes, sp, FS, DT, r),
        lambda r: tlh.smooth_floes(tfl, port_settings(sp), port_settings(FS), DT, r))
    assert (np.asarray(ref.nverts) < nv0).any()
    assert_fields_close(got, ref, **TOL)


def test_timestep_welding_matches_jax():
    floes, domain, tfl, tdom, tgrid = _pool()
    ws = WeldSettings(weld_on=True, dts=[20], nxs=[2], nys=[2],
                      welding_coeff=1000.0, max_weld_area=1e10)
    mid = int(np.asarray(floes.id).max())
    (ref, m1), (got, m2), drew = _both(
        lambda r: jlh.timestep_welding(floes, mid, GRID, domain, ws, FS, 0, DT, r),
        lambda r: tlh.timestep_welding(tfl, mid, tgrid, tdom, port_settings(ws),
                                       port_settings(FS), 0, DT, r))
    assert drew and m1 == m2 > mid  # floes welded
    assert_fields_close(got, ref, **TOL)


@pytest.mark.parametrize("partners", ["floes", "walls"])
def test_timestep_ridging_rafting_matches_jax(partners):
    floes, domain, tfl, tdom, _ = _pool()
    overlaps = [o for o in _overlaps(floes, domain)
                if (o[1] >= 0) == (partners == "floes")]
    assert len(overlaps) >= 3
    if partners == "walls":
        assert all(-4 <= j <= -1 for _, j, _ in overlaps)
    rr = RidgeRaftSettings(ridge_raft_on=True, dt=1, ridge_probability=0.6,
                           raft_probability=0.6, min_overlap_frac=0.001,
                           domain_gain_probability=0.5)
    sp = SimplificationSettings()
    mid = int(np.asarray(floes.id).max())
    (ref, m1), (got, m2), drew = _both(
        lambda r: jlh.timestep_ridging_rafting(floes, domain, overlaps, mid, rr,
                                               FS, sp, DT, r),
        lambda r: tlh.timestep_ridging_rafting(tfl, tdom, overlaps, mid,
                                               port_settings(rr), port_settings(FS),
                                               port_settings(sp), DT, r))
    assert drew and m1 == m2
    assert not np.array_equal(np.asarray(ref.area), np.asarray(floes.area))
    assert_fields_close(got, ref, **TOL)


def test_yield_curves_and_fracture_choice_match_jax():
    np.testing.assert_array_equal(tlh.hibler_yield_ellipse(0.5, 5e5, -1.0),
                                  jlh.hibler_yield_ellipse(0.5, 5e5, -1.0))
    np.testing.assert_array_equal(tlh.mohrs_cone_vertices(),
                                  jlh.mohrs_cone_vertices())
    floes, _, tfl, _, _ = _pool()
    crit = HiblerYieldCurve()
    ref = jlh.determine_fractures(jlh.HostFloes(floes), crit, FS)
    got = tlh.determine_fractures(tlh.HostFloes(tfl), port_settings(crit),
                                  port_settings(FS))
    assert got == ref and 0 < len(ref)
    ring = to_np(tfl.verts[0, : int(tfl.nverts[0])])
    np.testing.assert_array_equal(tlh._rdp(ring, 500.0), jlh._rdp(ring, 500.0))


def test_split_floe_skips_a_piece_whose_clip_does_not_resolve(monkeypatch):
    """A Voronoi cell whose intersection with the floe defeats every
    perturbation retry is dropped with a warning and the other pieces keep
    the parent's mass between them.  (The JAX package's ``split_floe`` means
    the same, but reaches its ``warnings.warn`` without having imported
    ``warnings`` and dies of a NameError there; the port imports it.)"""
    _, _, tfl, _, _ = _pool()
    hf = tlh.HostFloes(tfl)
    real = tlh.host_clip.intersect
    calls = []

    def flaky(S, C):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("polygon boolean 'and' failed after 8 perturbations")
        return real(S, C)

    monkeypatch.setattr(tlh.host_clip, "intersect", flaky)
    fr = port_settings(FractureSettings(fractures_on=True, npieces=3))
    with pytest.warns(UserWarning, match="fracture piece clip skipped"):
        pieces = tlh.split_floe(hf, 0, np.random.default_rng(1), fr,
                                port_settings(FS), DT)
    assert len(calls) == 3 and 1 <= len(pieces) <= 2


# A pair marked to fuse in the 4-rank fracture-on run of
# tools/measure_scaling.py on the H100 (8 000 floes, f32): the larger floe's
# ring traces one edge out and back (vertices 4 to 6), a zero-width spike.
SPIKED = np.array([[334958.4375, 280803.3125], [334930.375, 280260.46875],
                   [337006.46875, 277897.625], [337621.03125, 277563.03125],
                   [338449.375, 280195.03125], [338208.5, 280237.03125],
                   [338449.375, 280195.03125], [339096.15625, 281686.03125],
                   [335012.15625, 281165.5625], [334969.71875, 281022.8125]])
PARTNER = np.array([[339096.0625, 281686.8125], [338449.25, 280195.84375],
                    [337620.71875, 277563.875], [339101.8125, 276757.375],
                    [339399.78125, 276915.5625], [340265.34375, 279644.65625],
                    [339463.1875, 281733.59375]])


def test_boolean_of_a_ring_with_a_zero_width_spike():
    """No perturbation resolves a spike (both of its ends move together):
    the JAX package's host clip raises on this pair, and with it the fuse
    pass (ROADMAP C).  The port's drops the spike, which bounds no area, and
    gives what the JAX package's gives for the ring without it."""
    from subzero_tpu.geometry import host_clip as jclip
    from subzero_tpu_torch.geometry import host_clip as tclip

    clean = np.delete(SPIKED, [5, 6], axis=0)
    assert tclip._without_spikes(SPIKED).tolist() == clean.tolist()
    assert tclip._without_spikes(PARTNER).tolist() == PARTNER.tolist()
    for op in ("union", "intersect", "difference"):
        with pytest.raises(RuntimeError, match="failed after 8 perturbations"):
            getattr(jclip, op)(SPIKED, PARTNER)
        got = getattr(tclip, op)(SPIKED, PARTNER)
        want = getattr(jclip, op)(clean, PARTNER)
        assert len(got) == len(want) == 1, op
        np.testing.assert_array_equal(got[0], want[0], err_msg=op)
