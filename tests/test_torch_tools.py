"""The port's tools (``subzero_tpu_torch.tools``) against the JAX package's:
energy/momentum diagnostics and the conservation scenarios, the MATLAB
converters, the per-floe analysis and plots of a file the port wrote, and
the JLD2 fixture reader on a small HDF5 file with object references (f64,
CPU, numpy-seeded inputs)."""

import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import loadmat, savemat

from subzero_tpu.core import BoundaryKind, initialize_floe_field, make_domain, make_grid
from subzero_tpu.core.floes import build_floes as jax_build_floes
from subzero_tpu.settings import FloeSettings, SubGridPointsGenerator
from subzero_tpu.tools import analyze_floe as j_analyze
from subzero_tpu.tools import conservation as j_cons
from subzero_tpu.tools import fixtures as j_fixtures
from subzero_tpu.tools import mat_convert as j_mat
from subzero_tpu.tools import plotting as j_plotting
from subzero_tpu.tools import scenarios as j_scenarios
from subzero_tpu_torch.tools import analyze_floe, conservation, fixtures, mat_convert
from subzero_tpu_torch.tools import plotting, scenarios

from torch_port_helpers import assert_fields_close, port_settings, port_state, to_np

FS = FloeSettings(min_floe_area=1e5, subfloe_point_generator=SubGridPointsGenerator(2e3))


def _drift_close(got, ref):
    assert sorted(got) == sorted(ref)  # JAX's scan orders a dict's keys
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=1e-9, err_msg=k)


def test_floe_energy_momentum_matches_jax():
    grid = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), dtype=jnp.float64)
    floes = initialize_floe_field(12, [0.6], domain, 0.25, 0.1, FS,
                                  rng=np.random.default_rng(3), dtype=jnp.float64)
    rng = np.random.default_rng(4)
    N = floes.capacity
    floes = floes._replace(u=jnp.asarray(rng.normal(size=N) * 0.1),
                           v=jnp.asarray(rng.normal(size=N) * 0.1),
                           xi=jnp.asarray(rng.normal(size=N) * 1e-5))
    got = conservation.floe_energy_momentum(port_state(floes, domain)[0])
    ref = j_cons.floe_energy_momentum(floes)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-12, err_msg=k)
    series = {k: torch.stack([got[k], 2 * got[k]]) for k in got}
    series["zero"] = torch.zeros(3, dtype=torch.float64)
    drift = conservation.drift_percent(series)
    ref_drift = j_cons.drift_percent({k: jnp.asarray(to_np(v)) for k, v in series.items()})
    for k in ref_drift:
        np.testing.assert_array_equal(to_np(drift[k]), np.asarray(ref_drift[k]), err_msg=k)
    assert np.isnan(to_np(drift["zero"])) and float(drift["ke"]) == 100.0


@pytest.mark.parametrize("scenario", ["head_on", "three_floes"])
def test_conservation_run_matches_jax(scenario):
    """tools/scenarios.conservation_run in both packages (f64, 300 steps):
    the same drift figures and the same final floes."""
    n = 300
    drift, sim = scenarios.conservation_run(torch.float64, scenario, n, device="cpu")
    ref_drift, ref_sim = j_scenarios.conservation_run(jnp.float64, scenario, n)
    _drift_close(drift, ref_drift)
    assert_fields_close(sim.model.floes, ref_sim.model.floes, rtol=1e-9, atol_rel=1e-12)
    assert scenarios.SCENARIOS == j_scenarios.SCENARIOS
    assert sim.consts == port_settings(ref_sim.consts)


def _mat_floe(cx, cy, size, h, u, v, ksi):
    half = size / 2
    body = np.asarray([[-half, half, half, -half], [-half, -half, half, half]], float)
    return {"c_alpha": body, "Xi": cx, "Yi": cy, "h": h,
            "Ui": u, "Vi": v, "ksi_ice": ksi, "alpha_i": 0.1}


def test_mat_convert_matches_jax(tmp_path):
    """matfloes_to_floes on one .mat, and floes_to_mat of one pool, in both
    packages (tests/test_mat_convert.py's inputs); the port's pool goes
    round the .mat and back."""
    path = str(tmp_path / "floes.mat")
    savemat(path, {"floe": np.asarray(
        [_mat_floe(1e4, 2e4, 5e3, 0.5, 0.1, -0.2, 1e-5),
         _mat_floe(4e4, 2e4, 8e3, 0.3, 0.0, 0.05, 0.0)], dtype=object)})
    got = mat_convert.matfloes_to_floes(path, port_settings(FS), dtype=torch.float64,
                                        device="cpu", N=4)
    ref = j_mat.matfloes_to_floes(path, FS, dtype=jnp.float64, N=4)
    assert_fields_close(got, ref, rtol=0, atol_rel=0)
    assert to_np(got.height)[:2].tolist() == [0.5, 0.3]

    sq1 = [[0.0, 0.0], [6e3, 0.0], [6e3, 6e3], [0.0, 6e3]]
    sq2 = [[1e4, 0.0], [1.8e4, 0.0], [1.8e4, 8e3], [1e4, 8e3]]
    jfl = jax_build_floes([sq1, sq2], 0.4, 0.0, FS, np.random.default_rng(0),
                          dtype=jnp.float64, N=4, u=0.3, v=-0.1)
    domain = make_domain(make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10),
                         *([BoundaryKind.OPEN] * 4), dtype=jnp.float64)
    tfl = port_state(jfl, domain)[0]
    mat_convert.floes_to_mat(tfl, str(tmp_path / "port.mat"))
    j_mat.floes_to_mat(jfl, str(tmp_path / "jax.mat"))
    a = loadmat(str(tmp_path / "port.mat"), squeeze_me=True)
    b = loadmat(str(tmp_path / "jax.mat"), squeeze_me=True)
    keys = sorted(k for k in b if not k.startswith("__"))
    assert sorted(k for k in a if not k.startswith("__")) == keys
    for k in keys:
        x, y = a[k], b[k]
        if x.dtype == object:
            assert len(x) == len(y) == 2, k
            for p, q in zip(x, y):
                np.testing.assert_array_equal(np.asarray(p), np.asarray(q), err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_analyze_and_plot_a_port_file(tmp_path):
    """analyze_floe and plotting on the files of a port run (the writers'
    run of tests/test_output.py, 50 steps): the same time series as the JAX
    package's reader, five PNG panels, and the field's animation frames."""
    from subzero_tpu_torch.constants import Constants
    from subzero_tpu_torch.core import (initialize_floe_field as tinit, make_atmos,
                                        make_domain as tdomain, make_grid as tgrid,
                                        make_model, make_ocean)
    from subzero_tpu_torch.io import FloeOutputWriter, InitialStateOutputWriter, OutputWriters
    from subzero_tpu_torch.settings import FloeSettings as TFS
    from subzero_tpu_torch.settings import MonteCarloPointsGenerator
    from subzero_tpu_torch.simulation import Simulation, run

    kw = dict(dtype=torch.float64, device="cpu")
    grid = tgrid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    domain = tdomain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = TFS(min_floe_area=0.0, subfloe_point_generator=MonteCarloPointsGenerator(npoints=100))
    floes = tinit(4, [0.3], domain, 0.25, 0.0, fs, rng=np.random.default_rng(2), **kw)
    d = str(tmp_path)
    sim = Simulation(
        model=make_model(grid, make_ocean(grid, u=0.1, **kw),
                         make_atmos(grid, temp=-1.0, **kw), domain, floes),
        consts=Constants(E=1e6), dt=10, n_dt=50, floe_settings=fs,
        writers=OutputWriters(initial_state=InitialStateOutputWriter(dir=d, overwrite=True),
                              floes=FloeOutputWriter(10, dir=d, overwrite=True)))
    run(sim)
    path = os.path.join(d, "floes.h5")
    with h5py.File(path, "r") as f:
        fid = int(np.asarray(f["0"]["id"])[0])
    fields = ("u", "centroid", "mass", "collision_force")
    ts, got = analyze_floe.floe_timeseries(path, fid, fields)
    ref_ts, ref = j_analyze.floe_timeseries(path, fid, fields)
    assert ts.tolist() == ref_ts.tolist() == [0, 10, 20, 30, 40, 50]
    for k in fields:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["centroid"].shape == (6, 2) and np.all(got["mass"] > 0)
    pngs = analyze_floe.plot_floe_analysis(path, fid, str(tmp_path / "analysis"))
    assert len(pngs) == 5 and all(os.path.exists(p) for p in pngs)
    with pytest.raises(ValueError):
        analyze_floe.plot_floe_analysis(path, 10**6, str(tmp_path / "none"))

    for s in (5.0, 600.0, 4e4, 5e5):
        assert plotting.prettytime(s) == j_plotting.prettytime(s)
    out = plotting.plot_sim(path, os.path.join(d, "initial_state.h5"), 10.0,
                            str(tmp_path / "sim.mp4"), fps=5)
    stem = str(tmp_path / "sim")
    assert out == stem + ".mp4"
    assert os.path.exists(out) or any(
        p.startswith("sim_") and p.endswith(".png") for p in os.listdir(tmp_path))


def _write_shapes(path, rings):
    """A JLD2-like file: ``floe_vertices`` holds one object reference a floe,
    to a dataset of references to its rings (the exterior first), each a
    dataset of references to [x, y] points."""
    ref_t = h5py.special_dtype(ref=h5py.Reference)
    with h5py.File(path, "w") as f:
        g = f.create_group("_types")
        shape_refs = []
        for k, ring in enumerate(rings):
            pts = [g.create_dataset(f"p{k}_{i}", data=np.asarray(p, float)).ref
                   for i, p in enumerate(ring)]
            r = g.create_dataset(f"ring{k}", data=np.asarray(pts, dtype=object), dtype=ref_t)
            s = g.create_dataset(f"shape{k}", data=np.asarray([r.ref], dtype=object),
                                 dtype=ref_t)
            shape_refs.append(s.ref)
        f.create_dataset("floe_vertices", data=np.asarray(shape_refs, dtype=object),
                         dtype=ref_t)


def test_fixture_reader_follows_object_references(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    th = np.sort(rng.random(12)) * 2 * np.pi
    star = np.stack([np.cos(th), np.sin(th)], 1) * (1 + rng.random((12, 1)))
    square = [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.0, 0.0]]  # closed
    path = str(tmp_path / "shapes.jld2")
    _write_shapes(path, [square, star.tolist(), [[0.0, 0.0], [1.0, 1.0]]])
    for max_verts in (None, 6):
        got = fixtures.load_floe_shapes(path, max_verts=max_verts)
        ref = j_fixtures.load_floe_shapes(path, max_verts=max_verts)
        assert len(got) == len(ref) == 2  # the two-point "ring" is dropped
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 4 and len(got[1]) == 6  # closing vertex dropped; decimated
    monkeypatch.delenv(fixtures.REFERENCE_DIR_ENV, raising=False)
    with pytest.raises(FileNotFoundError):
        fixtures.load_floe_shapes()
    monkeypatch.setenv(fixtures.REFERENCE_DIR_ENV, str(tmp_path))
    assert fixtures.reference_floe_shapes() == os.path.join(
        str(tmp_path), "examples", "floe_shapes.jld2")
