"""The port's contact sums against the JAX reference's, on both sides of the
size where the JAX ``_onehot_sum`` leaves its [K, N] one-hot product for
``segment_sum`` (K * N > 2^25).

The port has one path at every size, ``collisions._segment_sum``: the rows
sorted stably by floe, each floe's rows added in their original order.  f64,
rtol 1e-12.  The same numpy-seeded inputs go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.physics import collisions as jcol
from subzero_tpu_torch.physics import collisions as tcol

ONEHOT_LIMIT = 1 << 25  # subzero_tpu/physics/collisions.py:_onehot_sum


def _rows(K, N, F, seed, dtype=np.float64):
    """payload [K, F] and floe index [K]: most rows on a floe, some on
    idx == N (dropped) with a non-finite payload."""
    rng = np.random.default_rng(seed)
    pay = (rng.standard_normal((K, F)) * 10.0 ** rng.integers(-3, 4, (K, 1))).astype(dtype)
    idx = rng.integers(0, N, K).astype(np.int32)
    drop = rng.random(K) < 0.1
    idx[drop] = N
    pay[drop & (np.arange(K) % 2 == 0), 0] = np.inf
    pay[drop & (np.arange(K) % 2 == 1), -1] = np.nan
    return pay, idx, drop


@pytest.mark.parametrize("K,N", [(600, 200), (8500, 4000)],
                         ids=["one_hot_side", "segment_sum_side"])
def test_segment_sum_matches_jax_onehot_sum(K, N):
    """Rows with idx == N drop out, their non-finite payload too: the port
    gets the raw payload, the JAX function the payload masked as its callers
    mask it (its one-hot product would carry 0 * inf)."""
    assert (K * N > ONEHOT_LIMIT) == (K == 8500)
    pay, idx, drop = _rows(K, N, 7, seed=K)
    masked = np.where(drop[:, None], 0.0, pay)
    ref = np.asarray(jcol._onehot_sum(jnp.asarray(masked), jnp.asarray(idx), N))
    got = tcol._segment_sum(torch.from_numpy(pay), torch.from_numpy(idx), N).numpy()
    assert got.shape == (N, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_adds_each_floes_rows_in_order(dtype):
    """At the 32k bench pool (K = 8.5 N rows, where a [K, N] one-hot would
    take 35 GB in f32) the sums equal, to the bit, numpy's unbuffered
    np.add.at, which adds the rows one by one in their order; negative and
    too-large indices drop out."""
    N = 32000
    K = 17 * N // 2
    pay, idx, drop = _rows(K, N, 7, seed=3, dtype=dtype)
    idx = idx.astype(np.int64)
    idx[drop & (np.arange(K) % 3 == 0)] = -1
    ref = np.zeros((N + 1, 7), dtype)
    np.add.at(ref, np.where(drop, N, idx), np.where(drop[:, None], 0, pay))
    got = tcol._segment_sum(torch.from_numpy(pay), torch.from_numpy(idx), N).numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, ref[:N])


def _sides(mod, cent_i, cent_j):
    """A _PairSides of either package: the centroids the sums read, zeros
    elsewhere."""
    to = jnp.asarray if mod is jcol else torch.from_numpy
    z = np.zeros(cent_i.shape[0])
    return mod._PairSides(**{
        f: to(cent_i if f == "cent_i" else cent_j if f == "cent_j" else z)
        for f in mod._PairSides._fields})


@pytest.mark.parametrize("row_cap", [8, None], ids=["row_structured", "free_rows"])
def test_accumulate_contacts_matches_jax_above_the_threshold(row_cap):
    """_accumulate_contacts on a 2 100-floe pool with 8 rows a floe plus
    1 050 spill rows (K * N = 3.7e7 > 2^25): force, torque, stress moments
    and overlap per floe, f64 rtol 1e-12."""
    N, R = 2100, 2
    K = N * 8 + N // 2
    assert K * N > ONEHOT_LIMIT
    rng = np.random.default_rng(7)
    i = np.concatenate([np.repeat(np.arange(N), 8), rng.integers(0, N, N // 2)])
    j = rng.integers(0, N + 6, K)  # some rows reach a wall or topography
    pair_valid = rng.random(K) < 0.4
    is_ff = pair_valid & (j < N)
    cent_i, cent_j = rng.uniform(0, 1e5, (2, K, 2))
    shift = np.where(rng.random((K, 1)) < 0.1, 1e5, 0.0) * rng.choice([-1, 1], (K, 2))
    force = rng.standard_normal((K, R, 2)) * 1e6
    fp = cent_i[:, None, :] + rng.standard_normal((K, R, 2)) * 1e3
    overlap = np.abs(rng.standard_normal((K, R))) * 1e5
    args = dict(i=i.astype(np.int32), j=j.astype(np.int32), pair_valid=pair_valid,
                is_ff=is_ff, shift=shift, force=force, fp=fp, overlap_rec=overlap)

    ref = jcol._accumulate_contacts(
        N, s=_sides(jcol, cent_i, cent_j), row_cap=row_cap,
        **{k: jnp.asarray(v) for k, v in args.items()})
    got = tcol._accumulate_contacts(
        N, s=_sides(tcol, cent_i, cent_j), row_cap=row_cap,
        **{k: torch.from_numpy(v) for k, v in args.items()})
    for name, g, r in zip(("col_force", "col_trq", "stress_moments", "overarea"),
                          got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(r).max()), err_msg=name)
