"""The narrow phase over ring pools and a candidate pair list, the form the
CUDA kernel takes, against the JAX reference.

``clip.two_cross_pairs`` (the kernel's plain PyTorch version: it gathers each
row's two rings from the pools, shifts Q to P's periodic image, runs
``two_cross_pass`` and zeroes the rows that are not valid) is held to the
reference's ``two_cross_pass`` and to its Pallas kernel (interpret mode) on
the same numpy-seeded inputs, materialised for the reference with numpy.  The
lists share rings between rows, shift some, and mark every 7th row invalid.
The g++ build of the kernel's arithmetic (csrc/two_cross_host.cpp: the
per-term functions of two_cross.cuh combined in the kernel's order) is held
to the plain version on the same lists.  Rings of 16, 32 and 40 vertices
(the kernel takes rings wider than 32 with an instantiation of its own).  Tolerances: f64 rtol 1e-9; f32 those
of tests/test_pallas_clip.py; counts, flags and invalid rows exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.geometry.clip import two_cross_pass as jax_two_cross_pass
from subzero_tpu.geometry.pallas_clip import two_cross_pallas
from subzero_tpu_torch.geometry.clip import TwoCrossResult, two_cross_pairs

from torch_port_helpers import (
    assert_two_cross_close,
    build_host_shim,
    build_pair_list,
    rings_of_pair_list,
    run_host_shim_pairs,
    to_np,
    tt,
    zero_invalid_rows,
)

# V = 40: rings wider than a warp, which the kernel takes with its wide
# instantiation (two vertices a lane)
CASES = [(np.float32, 16), (np.float64, 16), (np.float32, 32), (np.float64, 32),
         (np.float32, 40), (np.float64, 40)]
IDS = ["f32-V16", "f64-V16", "f32-V32", "f64-V32", "f32-V40", "f64-V40"]


def _assert_invalid_rows_zero(res, valid):
    for f in TwoCrossResult._fields:
        assert not to_np(getattr(res, f))[~valid].any(), f


@pytest.mark.parametrize("dtype,V", CASES, ids=IDS)
def test_pairs_plain_matches_jax(dtype, V):
    args = build_pair_list(B=256, seed=4, V=V, nmax=V, dtype=dtype)
    valid = args[-1]
    ref = jax.jit(jax_two_cross_pass)(*(jnp.asarray(a) for a in rings_of_pair_list(args)))
    got = two_cross_pairs(*tt(*args))
    _assert_invalid_rows_zero(got, valid)
    assert_two_cross_close(got, zero_invalid_rows(ref, valid), dtype == np.float64)
    cnt = to_np(got.cnt)
    # every regime is exercised among the valid rows
    assert (cnt == 2).any() and (cnt > 2).any()
    assert (to_np(got.contain) > 0).any() and to_np(got.ok).any()
    assert ((cnt == 0) & valid & (to_np(got.contain) == 0)).any()


@pytest.mark.parametrize("dtype,V", CASES, ids=IDS)
def test_pairs_plain_matches_pallas_interpret(dtype, V):
    # the Pallas kernel takes rings of up to 16 vertices: at V = 32 it gets
    # the first 16 slots of rings that fit, as the reference's dispatch does
    args = build_pair_list(B=256, seed=5, V=V, nmax=16, dtype=dtype)
    valid = args[-1]
    pv, pn, qv, qn, pert = (jnp.asarray(a) for a in rings_of_pair_list(args))
    ref = two_cross_pallas(pv[:, :16], pn, qv[:, :16], qn, pert, interpret=True)
    got = two_cross_pairs(*tt(*args))
    assert_two_cross_close(got, zero_invalid_rows(ref, valid), dtype == np.float64)


@pytest.fixture(scope="module")
def host_shim(tmp_path_factory):
    return build_host_shim(tmp_path_factory.mktemp("two_cross_shim"))


@pytest.mark.parametrize("dtype,V", CASES, ids=IDS)
def test_host_shim_matches_pairs_plain(host_shim, dtype, V):
    np_args = build_pair_list(B=512, seed=6, V=V, nmax=V, dtype=dtype)
    args = tt(*np_args)
    ref = two_cross_pairs(*args)
    got = run_host_shim_pairs(host_shim, *args)
    _assert_invalid_rows_zero(got, np_args[-1])
    assert_two_cross_close(got, ref, dtype == np.float64)


def test_host_shim_zeroes_rows_with_an_index_outside_its_pool(host_shim):
    """A valid row whose index lies outside its pool reads no ring: it comes
    back zeros and not ok (the plain version refuses such an index)."""
    np_args = list(build_pair_list(B=32, seed=7, V=16, nmax=16, dtype=np.float64))
    np_args[-1] = np.ones_like(np_args[-1])
    qi, qj = np_args[4].copy(), np_args[5].copy()
    qi[3], qj[5], qi[8] = 32, -1, 10**12
    np_args[4], np_args[5] = qi, qj
    got = run_host_shim_pairs(host_shim, *tt(*np_args))
    bad = np.zeros(len(qi), bool)
    bad[[3, 5, 8]] = True
    _assert_invalid_rows_zero(got, ~bad)
    good = np_args[:4] + [a[~bad] for a in np_args[4:]]
    assert_two_cross_close(
        TwoCrossResult(*(to_np(x)[~bad] for x in got)),
        two_cross_pairs(*tt(*good)), True)
