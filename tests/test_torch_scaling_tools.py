"""The port's decomposition tools against the JAX package's:
``subzero_tpu_torch.tools.measure_scaling`` and ``lifecycle_overhead``.

* ``lifecycle_overhead.build_sim`` builds the JAX tool's field bitwise
  (tools/lifecycle_overhead.py:36-73).
* Both tools run as 2 gloo rank processes on the CPU at a tiny size, as a
  user starts them (the environment torchrun sets): every rank prints the
  same figures; the comm-identity rows send no exchange byte, and the
  production rows send what ``comm_bytes_per_step`` bounds (1-D: halo plus
  migration, exactly); the pools the host passes are handed are equal on
  every rank; and at 1 rank the final active count is the JAX tool's.
"""

import importlib
import json
import sys

import numpy as np
import pytest

from subzero_tpu_torch.tools import lifecycle_overhead

from torch_port_helpers import REPO, Ranks, free_port, port_settings, rank_env, to_np

# run_decomp of the JAX tool's build_sim at 1 device, cut to 4 steps (one
# fracture pass, at step 4): the active floes at the end.  A one-off run of
# the JAX package on the CPU (tools/lifecycle_overhead.py's build_sim with
# n_dt = 4, make_decomp(n_devices=1), run_decomp).  At the tool's 12 steps
# the packages part at the second pass, where every floe that never touched
# another sits on the yield curve's tip (ROADMAP C).
JAX_FINAL_ACTIVE_4_STEPS = 1016
LIFECYCLE_STEPS = 4


def _jax_tool():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        return importlib.import_module("lifecycle_overhead")
    finally:
        sys.path.remove(str(REPO / "tools"))


def test_lifecycle_overhead_builds_the_jax_tool_field():
    ref = _jax_tool().build_sim()
    got = lifecycle_overhead.build_sim("cpu")
    for name in ("floes", "ocean", "atmos"):
        r, g = getattr(ref.model, name), getattr(got.model, name)
        for f in r._fields:
            a = np.asarray(getattr(r, f))
            b = to_np(getattr(g, f))
            assert b.dtype == a.dtype, f"{name}.{f}"
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(to_np(got.model.domain.vals), np.asarray(ref.model.domain.vals))
    assert got.model.domain.kinds == ref.model.domain.kinds
    for f in ("consts", "floe_settings", "coupling_settings", "fracture_settings"):
        assert getattr(got, f) == port_settings(getattr(ref, f)), f
    for f in ("dt", "n_dt", "seed", "pair_cap", "clip_cap", "cell_cap", "bins"):
        assert getattr(got, f) == getattr(ref, f), f


def _launch(tmp, name, args, world=2):
    """``world`` rank processes of ``python -m subzero_tpu_torch.tools.<name>``
    on the CPU, with the environment torchrun sets."""
    out = tmp / name
    out.mkdir()
    port = free_port()
    env = {r: dict(rank_env(), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
           for r in range(world)}
    cmd = [sys.executable, "-m", f"subzero_tpu_torch.tools.{name}", *args,
           "--backend", "gloo", "--device", "cpu"]
    return Ranks(lambda r: cmd, world, str(out), env=env, timeout=240)


def _figures(ranks):
    """Each rank's JSON line (its last line of output)."""
    ranks.wait()
    out = []
    for log in ranks.logs:
        with open(log) as f:
            out.append(json.loads(f.read().strip().splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory):
    """Both tools' rank processes, started together."""
    tmp = tmp_path_factory.mktemp("tools")
    runs = {"measure_scaling": _launch(tmp, "measure_scaling", ["64", "2"]),
            "lifecycle_overhead": _launch(tmp, "lifecycle_overhead",
                                          ["--n-dt", str(LIFECYCLE_STEPS)])}
    yield runs
    for r in runs.values():
        r.kill()


def _same_on_every_rank(figs):
    first = {k: v for k, v in figs[0].items() if k != "rank"}
    for f in figs[1:]:
        assert {k: v for k, v in f.items() if k != "rank"} == first
    assert [f["rank"] for f in figs] == list(range(len(figs)))


def test_measure_scaling_on_two_ranks(tool_runs):
    figs = _figures(tool_runs["measure_scaling"])
    _same_on_every_rank(figs)
    res = figs[0]
    assert res["ranks"] == 2 and res["backend"] == "gloo" and res["n_steps"] == 2
    labels = [r["configuration"] for r in res["rows"]]
    assert labels == ["1-D 2 slabs, per-step", "1-D 2 slabs, segment driver",
                      "2-D (1, 2) slabs, per-step"]
    for r in res["rows"]:
        vol = r["comm_bytes_per_step"]
        assert r["identity_exchange_bytes_per_step"] == 0
        assert 0 < r["exchange_bytes_per_step"] <= vol["halo_bytes"] + vol["migration_bytes"]
        assert r["bytes_sent_per_step"] > r["identity_bytes_sent_per_step"]
        assert 0 < r["proxy_eff"] <= 1 and 0 < r["projected_eff"] <= 1
        assert r["t_link_s"] == vol["total"] / 450e9
    for r in res["rows"][:2]:  # 1-D: both neighbours' full buffers every step
        vol = r["comm_bytes_per_step"]
        assert r["exchange_bytes_per_step"] == vol["halo_bytes"] + vol["migration_bytes"]
    assert res["t_slab_floes"] == 32 and res["t_slab_s"] > 0
    assert set(res["run_decomp_fracture"]) == {"1", "2"}
    for r in res["run_decomp_fracture"].values():
        assert r["steps"] == 3 and r["kernel_launches"] == 0  # the CPU: plain version


def test_lifecycle_overhead_on_two_ranks(tool_runs):
    figs = _figures(tool_runs["lifecycle_overhead"])
    _same_on_every_rank(figs)
    one, two = figs[0]["runs"]["1"], figs[0]["runs"]["2"]
    assert one["final_active"] == JAX_FINAL_ACTIVE_4_STEPS
    assert two["final_active"] == one["final_active"]
    for run in (one, two):
        assert run["host_passes"]["fracture"]["count"] == 1
        # the host pool holds the active floes and room for a fracture pass
        assert run["gathered_rows"] == [1600]
