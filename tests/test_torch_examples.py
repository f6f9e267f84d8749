"""The port's example scripts (``subzero_tpu_torch.examples``) build what the
JAX package's ``examples/*.py`` build: the same floe pool, ocean, atmosphere
and domain bit for bit, the same settings, capacities and writers, from the
same arguments (a reduced floe count where the example takes one)."""

import dataclasses
import importlib
import inspect
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import REPO, assert_fields_close, port_settings, to_np

# example -> the floe count it is built with here (None: it takes none)
EXAMPLES = {
    "uniform_flow": None,
    "shear_flow": 40,
    "simple_strait": 40,
    "converge_diverge_flow": None,
    "forcing_contained_floes": 30,
    "moving_bounds": 20,
    "many_floes": 40,
    "restart_sim": None,
}
WRITERS = ("initial_state", "floes", "grid", "checkpoint")


def _jax_example(name):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO / "examples"))


def _same_writers(got, ref):
    if ref is None:
        assert got is None
        return
    for w in WRITERS:
        g, r = getattr(got, w), getattr(ref, w)
        assert (g is None) == (r is None), w
        if r is None:
            continue
        assert type(g).__name__ == type(r).__name__, w
        for f in dataclasses.fields(r):
            if f.name != "_file":
                assert getattr(g, f.name) == getattr(r, f.name), f"{w}.{f.name}"


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_builds_what_the_jax_example_builds(name, tmp_path):
    ref_mod = _jax_example(name)
    got_mod = importlib.import_module(f"subzero_tpu_torch.examples.{name}")
    # the JAX example's arguments and defaults, plus device; dtype a torch dtype
    ref_sig = inspect.signature(ref_mod.build).parameters
    got_sig = dict(inspect.signature(got_mod.build).parameters)
    assert got_sig.pop("device").default is None
    assert list(got_sig) == list(ref_sig)
    for k, p in ref_sig.items():
        if k == "dtype":
            assert str(got_sig[k].default).split(".")[-1] == np.dtype(p.default).name
        else:
            assert got_sig[k].default == p.default, k

    kw = {} if EXAMPLES[name] is None else {"n_floes": EXAMPLES[name]}
    if "out_dir" in ref_sig:
        kw["out_dir"] = str(tmp_path)
    ref = ref_mod.build(**kw)
    got = got_mod.build(device="cpu", **kw)
    if name == "restart_sim":
        (ref, ref_settings), (got, got_settings) = ref, got
        assert list(got_settings) == list(ref_settings)
        for k, v in ref_settings.items():
            assert got_settings[k] == port_settings(v), k
        assert got_mod.N_PART_SIM == ref_mod.N_PART_SIM
        assert got_mod.N_DT_PART == ref_mod.N_DT_PART
    assert_fields_close(got.model.floes, ref.model.floes, rtol=0, atol_rel=0)
    assert_fields_close(got.model.ocean, ref.model.ocean, rtol=0, atol_rel=0)
    assert_fields_close(got.model.atmos, ref.model.atmos, rtol=0, atol_rel=0)
    assert_fields_close(got.model.domain.topography, ref.model.domain.topography,
                        rtol=0, atol_rel=0)
    assert got.model.floes.verts.dtype == getattr(torch, str(ref.model.floes.verts.dtype))
    dom, rdom = got.model.domain, ref.model.domain
    assert dom.kinds == tuple(int(k) for k in rdom.kinds)
    np.testing.assert_array_equal(to_np(dom.vals), np.asarray(rdom.vals))
    np.testing.assert_array_equal(to_np(dom.velocities), np.asarray(rdom.velocities))
    assert dataclasses.asdict(got.model.grid) == dataclasses.asdict(ref.model.grid)
    assert got.consts == port_settings(ref.consts)
    for f in dataclasses.fields(ref):
        if f.init and f.name not in ("model", "consts", "writers"):
            assert getattr(got, f.name) == port_settings(getattr(ref, f.name)), f.name
    _same_writers(got.writers, ref.writers)
