"""The pieces of the port's domain decomposition (``subzero_tpu_torch.parallel``)
against the JAX package's, in one process (f64, CPU).

The pools are tests/test_parallel.py's ``make_wide_sim`` (128 floes, an 8:1
periodic domain) and ``make_sim`` (16 floes), built by both packages from the
same numpy seed (bit for bit the same pool).  A decomposition made in one
process is a plan (``Decomp.comm`` has one rank): its capacities and each
rank's block can be read, its step needs the ranks
(tests/test_torch_decomp_ranks.py runs those).  Tolerances: capacities, row
blocks, packed buffers, candidate lists and fuse marks equal; collision and
coupling results at rtol 1e-9 with an absolute floor of 1e-9 of each field's
largest magnitude (and ``test_torch_slice._tendency_atol``'s floors)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subzero_tpu.parallel.decomp as jdec
import subzero_tpu_torch.parallel.decomp as tdec
import torch_decomp_worker as worker
from subzero_tpu.physics import collisions as jcol
from subzero_tpu.physics import coupling as jcpl
from subzero_tpu_torch.parallel import multihost
from subzero_tpu_torch.physics import collisions as tcol
from subzero_tpu_torch.physics import coupling as tcpl
from test_parallel import make_sim, make_wide_sim
from test_torch_slice import _tendency_atol
from torch_port_helpers import assert_fields_close, assert_ocean_close, to_np


@pytest.fixture(scope="module")
def wide():
    """The JAX wide simulation and the port's, 32 candidate rows a floe."""
    j = make_wide_sim()
    j.pair_cap = 32 * j.model.floes.capacity
    t = worker.wide_sim()
    t.pair_cap = j.pair_cap
    return j, t


def _layout(dec):
    return (getattr(dec, "n_dev", None), getattr(dec, "dx_dev", None),
            getattr(dec, "dy_dev", None), dec.local_cap, dec.halo_cap, dec.mig_cap,
            dec.margin)


def test_capacities_match_jax(wide):
    """make_decomp over 1, 2, 4, 8 x-slabs and make_decomp_2d over 2 x 2 and
    4 x 2: the same counts, capacities and margin (the clamped default and
    an explicit one)."""
    j, t = wide
    for D in (1, 2, 4, 8):
        for margin in (None, 3e4):
            assert _layout(tdec.make_decomp(t.model.floes, t.model.domain, n_devices=D,
                                            margin=margin)) == _layout(
                jdec.make_decomp(j.model.floes, j.model.domain, n_devices=D,
                                 margin=margin)), (D, margin)
    js, ts = make_sim(), worker.small_sim()
    for sim_j, sim_t in ((js, ts), (j, t)):
        for n_dev in ((2, 2), (4, 2)):
            assert _layout(tdec.make_decomp_2d(sim_t.model.floes, sim_t.model.domain,
                                               n_dev=n_dev)) == _layout(
                jdec.make_decomp_2d(sim_j.model.floes, sim_j.model.domain, n_dev=n_dev))
    plan = tdec.make_decomp(t.model.floes, t.model.domain, n_devices=4)
    assert plan.comm.size == 1  # one process: a plan; its step wants 4 ranks
    with pytest.raises(ValueError, match="runs as 4 ranks"):
        tdec.build_decomp_step(t, plan)


def test_margin_wider_than_a_slab_raises_as_in_jax(wide):
    j, t = wide
    for mk in (lambda m, fl, dom: m.make_decomp(fl, dom, n_devices=4, margin=3e5),
               lambda m, fl, dom: m.make_decomp_2d(fl, dom, n_dev=(2, 2), margin=6e4)):
        with pytest.raises(ValueError, match="exceeds slab") as want:
            mk(jdec, j.model.floes, j.model.domain)
        with pytest.raises(ValueError, match="exceeds slab") as got:
            mk(tdec, t.model.floes, t.model.domain)
        assert str(got.value) == str(want.value)


def _as_rank(dec, r):
    """The decomposition seen from rank r (only its index and device)."""
    return dataclasses.replace(dec, comm=types.SimpleNamespace(rank=r, device=torch.device("cpu")))


def test_distribute_gives_each_rank_its_jax_row_block(wide):
    """Rank r's block is rows [r * local_cap, (r + 1) * local_cap) of the JAX
    package's distributed pool, every field; likewise the ``extra`` rows."""
    j, t = wide
    js, ts = make_sim(), worker.small_sim()
    extra_j = np.asarray(j.model.floes.stress_accum) + 1.0
    for (sj, st, n) in ((j, t, 4), (js, ts, (2, 2))):
        if isinstance(n, tuple):
            jd = jdec.make_decomp_2d(sj.model.floes, sj.model.domain, n_dev=n)
            td = tdec.make_decomp_2d(st.model.floes, st.model.domain, n_dev=n)
            jplace, tplace, D = jdec.distribute_2d, tdec.distribute_2d, n[0] * n[1]
        else:
            jd = jdec.make_decomp(sj.model.floes, sj.model.domain, n_devices=n)
            td = tdec.make_decomp(st.model.floes, st.model.domain, n_devices=n)
            jplace, tplace, D = jdec.distribute, tdec.distribute, n
        ref = jplace(sj.model.floes, sj.model.domain, jd)
        Nl = td.local_cap
        for r in range(D):
            got = tplace(st.model.floes, st.model.domain, _as_rank(td, r))
            block = type(ref)(*(np.asarray(a)[r * Nl:(r + 1) * Nl] for a in ref))
            assert_fields_close(got, block, rtol=0, atol_rel=0, what=f"rank {r}: ")
    jd = jdec.make_decomp(j.model.floes, j.model.domain, n_devices=4)
    _, ref = jdec.distribute(j.model.floes, j.model.domain, jd, extra=extra_j)
    td = tdec.make_decomp(t.model.floes, t.model.domain, n_devices=4)
    for r in range(4):
        _, got = tdec.distribute(t.model.floes, t.model.domain, _as_rank(td, r),
                                 extra=torch.from_numpy(extra_j))
        np.testing.assert_array_equal(to_np(got), np.asarray(ref)[r * td.local_cap:
                                                                 (r + 1) * td.local_cap])


def test_pack_halo_masks_and_periodic_shift_match_jax(wide):
    """The halo buffers a rank sends: the edge masks of slab 1 of 4, packed in
    the mask's row order into halo_cap rows (padding repeats the last row,
    inactive), the overflow flag at a small cap, and the periodic shift."""
    j, t = wide
    dec = tdec.make_decomp(t.model.floes, t.model.domain, n_devices=4)
    lo, hi, m = 2e5, 4e5, dec.margin
    for fl, mod in ((j.model.floes, jdec), (t.model.floes, tdec)):
        cx, r = fl.centroid[:, 0], fl.rmax
        masks = (fl.active & (cx - r < lo + m), fl.active & (cx + r > hi - m))
        packs = [mod._pack(fl, mk, cap, mod._HALO_FIELDS) for mk in masks
                 for cap in (dec.halo_cap, 3)]
        shifted = mod._shift_x(packs[0][0], -8e5)
        if mod is jdec:
            ref, ref_shift = packs, shifted
        else:
            got, got_shift = packs, shifted
    assert int(masks[0].sum()) > 3 and int(masks[1].sum()) > 3
    for (g, g_over), (r, r_over) in zip(got, ref):
        assert bool(g_over) == bool(r_over)
        for f in tdec._HALO_FIELDS:
            np.testing.assert_array_equal(to_np(g[f]), np.asarray(r[f]), err_msg=f)
    for f in ("verts", "centroid"):
        np.testing.assert_array_equal(to_np(got_shift[f]), np.asarray(ref_shift[f]))
    # every field survives the flat message: pack_rows / unpack_rows
    buf = multihost.pack_rows([got[0][0][f] for f in tdec._HALO_FIELDS])
    assert buf.dtype == torch.uint8 and buf.shape[0] == dec.halo_cap
    back = multihost.unpack_rows(buf, [got[0][0][f] for f in tdec._HALO_FIELDS])
    for f, x in zip(tdec._HALO_FIELDS, back):
        assert torch.equal(x, got[0][0][f]), f


@pytest.mark.parametrize("owned", [70, 5])
def test_owned_rows_candidate_list_equals_jax(wide, owned):
    """The dense broad phase of an extended pool whose rows >= owned are
    halos: the JAX package's candidate list element for element (qi, qj,
    shift, valid, overflow), the spill list included."""
    j, t = wide
    ref = jax.jit(jcol._find_candidate_pairs_dense, static_argnums=(2, 3))(
        j.model.floes, j.model.domain, j.pair_cap, owned)
    got = tcol.find_candidate_pairs(t.model.floes, t.model.domain, t.pair_cap, None,
                                    owned_rows=owned)
    for f in ref._fields:
        np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert int(np.asarray(ref.valid).sum()) > 0
    # halo rows hold no candidate; a local-halo pair is the local row's
    qi = to_np(got.qi)[to_np(got.valid)]
    assert (qi < owned).all()
    with pytest.raises(ValueError, match="single-pool"):
        tcol.find_candidate_pairs(t.model.floes, t.model.domain, t.pair_cap, (4, 2, 16),
                                  owned_rows=owned)


def _inflated(floes, by=1.03):
    """The pool with every floe grown ``by`` about its centroid: a Voronoi
    field only touches, this one overlaps at every shared edge."""
    c = floes.centroid[:, None, :]
    return floes._replace(verts=c + by * (floes.verts - c), rmax=by * floes.rmax)


def test_timestep_collisions_owned_rows_matches_jax(wide):
    """The step's collisions on a pool whose rows >= 70 are halos, with 8
    candidate rows an owned floe (the spill list takes the deeper rows)."""
    j, t = wide
    kw = dict(clip_cap=j.clip_cap, bins=None, owned_rows=70)
    cap = 8 * j.model.floes.capacity
    jit = jax.jit(jcol.timestep_collisions, static_argnums=(2, 3, 4, 5),
                  static_argnames=tuple(kw))
    ref = jit(_inflated(j.model.floes), j.model.domain, j.consts, 20.0,
              j.collision_settings, cap, **kw)
    got = tcol.timestep_collisions(_inflated(t.model.floes), t.model.domain,
                                   t.consts, 20.0, t.collision_settings, cap, **kw)
    rf = jax.tree.map(np.asarray, ref.floes)
    assert float(np.abs(rf.collision_force).max()) > 0
    assert_fields_close(got.floes, rf, atol=_tendency_atol(rf, 20))
    si = np.asarray(ref.stress_instant)
    np.testing.assert_allclose(to_np(got.stress_instant), si, rtol=1e-9,
                               atol=1e-9 * np.abs(si).max())
    assert bool(got.overflow) == bool(ref.overflow)


def test_fuse_id_helpers_match_jax(wide):
    """Marks by extended-pool row become partner ids, and back to rows of a
    compacted pool; a mark against a floe's own periodic image and one whose
    partner left the pool are cleared."""
    j, t = wide
    N = j.model.floes.capacity
    rng = np.random.default_rng(0)
    fw = np.where(rng.random(N) < 0.3, rng.integers(0, N, N), -1).astype(np.int32)
    ref = np.asarray(jdec._fuse_with_to_ids(jnp.asarray(fw), j.model.floes))
    got = tdec._fuse_with_to_ids(torch.from_numpy(fw), t.model.floes)
    np.testing.assert_array_equal(to_np(got), ref)
    ids = np.asarray(j.model.floes.id)
    marks = ref.copy()
    marks[3] = ids[3]          # its own image
    marks[5] = ids.max() + 7   # a partner no longer in the pool
    jp = j.model.floes._replace(fuse_with=jnp.asarray(marks))
    tp = t.model.floes._replace(fuse_with=torch.from_numpy(marks))
    want = np.asarray(jdec._fuse_ids_to_rows(jp).fuse_with)
    np.testing.assert_array_equal(to_np(tdec._fuse_ids_to_rows(tp).fuse_with), want)
    assert want[3] == -1 and want[5] == -1 and (want >= 0).sum() > 10


def test_comm_bytes_per_step_matches_jax(wide):
    j, t = wide
    js, ts = make_sim(), worker.small_sim()
    for sj, st, mk in (
        (j, t, lambda m, s: m.make_decomp(s.model.floes, s.model.domain, n_devices=4)),
        (js, ts, lambda m, s: m.make_decomp_2d(s.model.floes, s.model.domain)),
    ):
        assert tdec.comm_bytes_per_step(st, mk(tdec, st)) == jdec.comm_bytes_per_step(
            sj, mk(jdec, sj))


def test_two_way_coupling_over_four_blocks_matches_jax_whole_pool(wide):
    """The pool split into 4 row blocks, one rank's each: every block's
    coupling with the cross-block sum of the per-cell sums (in block order)
    gives the JAX package's whole-pool ocean, and each block's floes are the
    whole pool's rows."""
    j, t = wide
    jm, tm = j.model, t.model
    args_j = (jm.grid, jm.domain, jm.ocean, jm.atmos, j.consts, j.coupling_settings,
              j.floe_settings, 20.0, j.cell_cap)
    ref_f, ref_o, _ = jax.jit(jcpl.timestep_coupling, static_argnums=(1, 5, 6, 7, 8, 9))(
        jm.floes, *args_j)
    ref_f = jax.tree.map(np.asarray, ref_f)
    N = tm.floes.capacity
    blocks = [type(tm.floes)(*(a[k * N // 4:(k + 1) * N // 4] for a in tm.floes))
              for k in range(4)]
    args_t = (tm.grid, tm.domain, tm.ocean, tm.atmos, t.consts, t.coupling_settings,
              t.floe_settings, 20.0, t.cell_cap)
    sums = []
    for b in blocks:
        tcpl.timestep_coupling(b, *args_t, reduce_sums=lambda s: sums.append(s) or s)

    def ordered(_):
        out = sums[0]
        for s in sums[1:]:
            out = out + s
        return out

    for k, b in enumerate(blocks):
        got_f, got_o, _ = tcpl.timestep_coupling(b, *args_t, reduce_sums=ordered)
        assert_ocean_close(got_o, ref_o, what=f"block {k}: ocean.")
        rows = type(ref_f)(*(a[k * N // 4:(k + 1) * N // 4] for a in ref_f))
        assert_fields_close(got_f, rows, what=f"block {k}: floes.")


def test_nothing_falls_back_to_another_backend_or_the_cpu(monkeypatch):
    """nccl with two ranks on a host of one card raises before any process
    group exists; ``rank_device`` without a card raises; a named device is
    taken as given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        multihost.initialize(backend="nccl", init_method="tcp://localhost:1",
                             world_size=2, rank=1)
    monkeypatch.undo()
    assert not torch.distributed.is_initialized()
    assert multihost.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.rank_device(None)
        with pytest.raises(RuntimeError, match="nccl needs a card"):
            multihost.initialize(init_method="tcp://localhost:1", world_size=1, rank=0)
    # one process, no group: a single rank whose collectives are identities
    comm = multihost.Comm(device="cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert (comm.size, comm.rank) == (1, 0) and comm.ordered_sum(x) is x
    assert comm.flag_max(torch.tensor([True, False])) == [1, 0]
    assert multihost.is_io_process()
