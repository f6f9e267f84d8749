"""The port's two-crossing narrow phase against the JAX reference.

The plain PyTorch ``two_cross_pass`` is held to the reference's
``two_cross_pass`` and to its Pallas kernel (interpret mode), on random star
rings covering disjoint, two-crossing, multi-crossing and containment
pairs; the CUDA kernel's per-term arithmetic (csrc/two_cross.cuh), built
with g++ into a CPU shim that combines it serially, is held to the plain
version.  tests/test_torch_two_cross_pairs.py does the same over ring pools
and a pair list, the form the kernel takes.  The kernel itself
is held to the plain version on the card by tests/test_torch_cuda.py, which
imports no JAX so that it runs where JAX is absent.  Tolerances: f64 rtol
1e-9; f32 those of tests/test_pallas_clip.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.geometry.clip import two_cross_pass as jax_two_cross_pass
from subzero_tpu.geometry.pallas_clip import two_cross_pallas
from subzero_tpu_torch.geometry import two_cross as tc_kernel
from subzero_tpu_torch.geometry.clip import (
    two_cross_dispatch,
    two_cross_pairs,
    two_cross_pass,
)

from torch_port_helpers import (
    assert_two_cross_close,
    build_batch,
    build_host_shim,
    identity_pair_list,
    run_host_shim,
    tt,
)

CASES = [(np.float32, 16), (np.float64, 16), (np.float32, 32), (np.float64, 32)]
IDS = ["f32-V16", "f64-V16", "f32-V32", "f64-V32"]


def _batch(dtype, V, B=256):
    return build_batch(B=B, seed=0, V=V, nmax=V, dtype=dtype)


@pytest.mark.parametrize("dtype,V", CASES, ids=IDS)
def test_plain_matches_jax(dtype, V):
    args = _batch(dtype, V)
    ref = jax.jit(jax_two_cross_pass)(*(jnp.asarray(a) for a in args))
    got = two_cross_pass(*tt(*args))
    assert_two_cross_close(got, ref, dtype == np.float64)
    cnt = np.asarray(ref.cnt)
    # every regime is exercised
    assert (cnt == 0).any() and (cnt == 2).any() and (cnt > 2).any()
    assert (np.asarray(ref.contain) > 0).any() and np.asarray(ref.ok).any()


@pytest.mark.parametrize("dtype,V", CASES, ids=IDS)
def test_plain_matches_pallas_interpret(dtype, V):
    # the Pallas kernel takes rings of up to 16 vertices: at V = 32 it gets
    # the first 16 slots of rings that fit, as the reference's dispatch does
    args = build_batch(B=256, seed=1, V=V, nmax=16, dtype=dtype)
    pv, pn, qv, qn, pert = (jnp.asarray(a) for a in args)
    ref = two_cross_pallas(pv[:, :16], pn, qv[:, :16], qn, pert, interpret=True)
    got = two_cross_pass(*tt(*args))
    assert_two_cross_close(got, ref, dtype == np.float64)


@pytest.fixture(scope="module")
def host_shim(tmp_path_factory):
    return build_host_shim(tmp_path_factory.mktemp("two_cross_shim"))


@pytest.mark.parametrize("dtype,V", CASES, ids=IDS)
def test_host_shim_matches_plain(host_shim, dtype, V):
    args = tt(*build_batch(B=512, seed=2, V=V, nmax=V, dtype=dtype))
    ref = two_cross_pass(*args)
    got = run_host_shim(host_shim, *args)
    assert_two_cross_close(got, ref, dtype == np.float64)


def test_dispatch_routes_cpu_to_plain():
    args = identity_pair_list(*tt(*_batch(np.float64, 32, B=64)))
    before = tc_kernel.launch_count()
    got = two_cross_dispatch(*args)
    ref = two_cross_pairs(*args)
    assert tc_kernel.launch_count() == before  # no kernel launch on the CPU
    for f in ref._fields:
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   rtol=1e-12, atol=1e-14)


def test_kernel_wrapper_rejects_cpu_tensors():
    args = identity_pair_list(*tt(*_batch(np.float32, 16, B=8)))
    with pytest.raises(ValueError, match="CUDA"):
        tc_kernel.two_cross_cuda(*args)
