"""The port's output writers (``subzero_tpu_torch.io.writers``) against the JAX
package's (f64, CPU): the same run, from the same numpy-seeded state, written
by both packages with all four writers (tests/test_output.py:67-93), file by
file and dataset by dataset; the floe writer's interaction rows
(tests/test_output.py:167-204); ``eulerian_data``; the netCDF4 layout of the
grid file (tests/test_output.py:229-280); the datasets' types; and the
device halves without h5py."""

import json
import os
import subprocess
import sys
import textwrap

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

from subzero_tpu.constants import Constants
from subzero_tpu.core import (
    BoundaryKind,
    initialize_floe_field,
    make_atmos,
    make_domain,
    make_grid,
    make_model,
)
from subzero_tpu.core.fields import make_ocean
from subzero_tpu.io import writers as jw
from subzero_tpu.settings import (
    CouplingSettings,
    FloeSettings,
    MonteCarloPointsGenerator,
    SubGridPointsGenerator,
)
from subzero_tpu.simulation import Simulation as JaxSimulation
from subzero_tpu.simulation import run as jax_run
from subzero_tpu_torch.core.model import make_model as torch_make_model
from subzero_tpu_torch.io import writers as tw
from subzero_tpu_torch.simulation import Simulation as TorchSimulation
from subzero_tpu_torch.simulation import run as torch_run
from subzero_tpu_torch.tools.compare import compare_floe_files

from torch_port_helpers import REPO, port_settings, port_state

RTOL = 1e-9


def _writers(pkg, out):
    kw = dict(dir=str(out), overwrite=True)
    return pkg.OutputWriters(
        initial_state=pkg.InitialStateOutputWriter(**kw),
        floes=pkg.FloeOutputWriter(10, **kw),
        grid=pkg.GridOutputWriter(20, dims=(5, 5), **kw),
        checkpoint=pkg.CheckpointOutputWriter(25, **kw),
    )


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """tests/test_output.py:35-64's run (4 floes, 50 steps, all four
    writers) by both packages from the same state, each writing into its own
    directory.  Returns (jax dir, port dir, jax sim, port sim)."""
    grid = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    ocean = make_ocean(grid, u=0.1, v=0.0, temp=0.0, dtype=jnp.float64)
    atmos = make_atmos(grid, temp=-1.0, dtype=jnp.float64)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), dtype=jnp.float64)
    fs = FloeSettings(
        min_floe_area=0.0,
        subfloe_point_generator=MonteCarloPointsGenerator(npoints=100),
    )
    floes = initialize_floe_field(
        4, [0.3], domain, 0.25, 0.0, fs, rng=np.random.default_rng(2),
        dtype=jnp.float64,
    )
    settings = dict(consts=Constants(E=1e6), dt=10, n_dt=50, floe_settings=fs,
                    coupling_settings=CouplingSettings(two_way_coupling_on=False))
    tmp = tmp_path_factory.mktemp("writers")
    jdir, tdir = tmp / "jax", tmp / "port"
    jsim = JaxSimulation(model=make_model(grid, ocean, atmos, domain, floes),
                         writers=_writers(jw, jdir), **settings)
    tfl, toc, tat, tdom, tgrid = port_state(floes, domain, ocean, atmos, grid)
    tsim = TorchSimulation(model=torch_make_model(tgrid, toc, tat, tdom, tfl),
                           writers=_writers(tw, tdir),
                           **{k: port_settings(v) for k, v in settings.items()})
    jax_run(jsim)
    torch_run(tsim)
    return jdir, tdir, jsim, tsim


@pytest.fixture(scope="module")
def written_interactions(tmp_path_factory):
    """The floe writer with interaction rows (tests/test_output.py:167-204),
    called through both packages' ``write_data`` at steps 0 and 5 on
    tests/test_output.py:96-165's two overlapping squares and a triangle
    (open walls), so that the rows are not empty."""
    from subzero_tpu.core.floes import build_floes

    fs = FloeSettings(min_floe_area=0.0,
                      subfloe_point_generator=SubGridPointsGenerator(1e9))
    grid = make_grid(-1e5, 1e5, -1e5, 1e5, Nx=10, Ny=10)
    domain = make_domain(grid, *([BoundaryKind.OPEN] * 4), dtype=jnp.float64)
    sq = [[0.0, 0.0], [2e4, 0.0], [2e4, 2e4], [0.0, 2e4]]
    sq2 = (np.asarray(sq) + np.asarray([1.5e4, 0.5e4])).tolist()
    tri = [[2.8e4, 1e4], [4.8e4, 1e4], [3.8e4, 3e4]]
    floes = build_floes([sq, sq2, tri], 0.5, 0.0, fs, N=8, dtype=jnp.float64)
    floes = floes._replace(u=jnp.asarray([0.1, -0.1, -0.3, 0, 0, 0, 0, 0.0]))
    ocean = make_ocean(grid, dtype=jnp.float64)
    atmos = make_atmos(grid, dtype=jnp.float64)
    settings = dict(consts=Constants(E=1e6), dt=10, n_dt=10, floe_settings=fs,
                    pair_cap=64 * 8)
    tmp = tmp_path_factory.mktemp("inters")
    jdir, tdir = tmp / "jax", tmp / "port"
    outputs = tuple(jw.DEFAULT_FLOE_FIELDS) + ("interactions",)
    jsim = JaxSimulation(model=make_model(grid, ocean, atmos, domain, floes), **settings)
    tfl, toc, tat, tdom, tgrid = port_state(floes, domain, ocean, atmos, grid)
    tsim = TorchSimulation(model=torch_make_model(tgrid, toc, tat, tdom, tfl),
                           **{k: port_settings(v) for k, v in settings.items()})
    for pkg, sim, d in ((jw, jsim, jdir), (tw, tsim, tdir)):
        w = pkg.OutputWriters(floes=pkg.FloeOutputWriter(
            5, dir=str(d), overwrite=True, outputs=outputs))
        m = sim.model
        for tstep in (0, 5):
            w.write_data(sim, tstep, m.floes, m.ocean, m.domain)
        w.close()
    return jdir, tdir


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


def _assert_close(got, ref, what, scale=None):
    """Floats to RTOL with an absolute floor of RTOL times ``scale`` (by
    default the largest magnitude of ``ref``), the rest exactly."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    if ref.dtype.kind in "fc":
        if scale is None:
            scale = float(np.abs(ref).max()) if ref.size else 0.0
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale + 1e-300,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


def _grid_scales(ref: dict) -> dict:
    """Each gridded output's scale: the largest magnitude among the outputs
    of its quantity (``stress_*``, ``strain_*``, ...), since a component
    that is roundoff of the others (strain_uy of a floe field moving in x)
    has no scale of its own."""
    top = {}
    for k, v in ref.items():
        q = k.split("_")[0]
        top[q] = max(top.get(q, 0.0), float(np.abs(np.asarray(v)).max()))
    return {k: top[k.split("_")[0]] for k in ref}


def _assert_grid_close(got: dict, ref: dict, what=""):
    """Gridded outputs of both packages (each ``[..., nx, ny]``).  A cell
    whose ice area is roundoff (a floe edge grazing it: below 1e-8 of the
    cell in either package) divides each floe quantity by that roundoff
    area, so its averages are noise in both; there an average is compared
    weighted by the ice fraction (its share of the cell), everywhere else
    directly, as torch_port_helpers.assert_ocean_close does for the ocean
    stress."""
    fg, fr = np.asarray(got["si_frac_grid"]), np.asarray(ref["si_frac_grid"])
    real = (np.minimum(fg, fr) > 1e-8) | (np.maximum(fg, fr) == 0)
    frac = np.maximum(fg, fr)
    scales = _grid_scales(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, what + k
        if k in ("area_grid", "si_frac_grid"):
            _assert_close(g, r, what + k, scales[k])
            continue
        _assert_close(g[real], r[real], what + k, scales[k])
        _assert_close(g[~real] * frac[~real], r[~real] * frac[~real],
                      what + k + " (roundoff-ice cells)", scales[k])


def test_floe_files_match(written):
    jdir, tdir, _, _ = written
    for a, b in ((tdir, jdir), (jdir, tdir)):
        diffs = compare_floe_files(str(a / "floes.h5"), str(b / "floes.h5"),
                                   rtol=RTOL, atol=1e-9, verbose=False)
        assert not diffs, diffs
    with h5py.File(tdir / "floes.h5", "r") as f:
        assert sorted(int(k) for k in f.keys()) == [0, 10, 20, 30, 40, 50]
        assert sorted(f["10"]) == sorted(tw.DEFAULT_FLOE_FIELDS)


def test_initial_state_files_match(written):
    jdir, tdir, _, _ = written
    with h5py.File(tdir / "initial_state.h5", "r") as ft, \
            h5py.File(jdir / "initial_state.h5", "r") as fj:
        assert ft.attrs["sim_json"] == fj.attrs["sim_json"]
        assert json.loads(ft.attrs["sim_json"])["domain_kinds"] == [1, 1, 1, 1]
    got, ref = _datasets(tdir / "initial_state.h5"), _datasets(jdir / "initial_state.h5")
    assert sorted(got) == sorted(ref)
    assert len([k for k in got if k.startswith("floes/")]) == len(jw.DEFAULT_FLOE_FIELDS)
    for k in ref:  # the same state, converted: equal to the bit
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_checkpoint_files_match(written):
    jdir, tdir, _, _ = written
    got, ref = _datasets(tdir / "checkpoint.h5"), _datasets(jdir / "checkpoint.h5")
    assert sorted(got) == sorted(ref)
    steps = sorted({k.split("/")[1] for k in ref}, key=int)
    assert steps == ["0", "25", "50"]
    for k in ref:
        if k.startswith("rng/"):
            assert json.loads(got[k]) == json.loads(ref[k]), k
        else:
            _assert_close(got[k], ref[k], k)


def test_grid_files_match(written):
    jdir, tdir, _, _ = written
    with h5py.File(tdir / "gridded_data.nc", "r") as ft, \
            h5py.File(jdir / "gridded_data.nc", "r") as fj:
        assert dict(ft.attrs) == dict(fj.attrs)
        assert sorted(ft.keys()) == sorted(fj.keys())
        assert list(ft["time"][()]) == [0.0, 20.0, 40.0]
        _assert_grid_close({k: ft[k][()] for k in tw.GRID_OUTPUTS},
                           {k: fj[k][()] for k in tw.GRID_OUTPUTS})
        for name in fj:
            vt, vj = ft[name], fj[name]
            assert vt.shape == vj.shape and vt.maxshape == vj.maxshape, name
            if name not in tw.GRID_OUTPUTS:
                _assert_close(vt[()], vj[()], name)
            for a, x in vj.attrs.items():
                if a == "DIMENSION_LIST":
                    dim_scales = [[fj[r].name for r in d] for d in x]
                    assert [[ft[r].name for r in d] for d in vt.attrs[a]] == dim_scales, name
                elif a != "REFERENCE_LIST":
                    assert np.array_equal(vt.attrs[a], x), (name, a)
            assert [d.label for d in vt.dims] == [d.label for d in vj.dims], name
            assert [[s.name for s in d.values()] for d in vt.dims] == \
                [[s.name for s in d.values()] for d in vj.dims], name
        si = ft["si_frac_grid"][0]
        assert 0.1 < si.sum() / 25 < 0.6  # roughly the 0.3 concentration


def test_dataset_types_of_both_packages(written):
    """What each package writes: floats as f8 (the runs are f64), booleans as
    HDF5 booleans, the pool's integer fields as int32 in both (the JAX
    package's pool keeps int32 under x64 too), ``num_inters`` as int64
    (``np.bincount``), the interaction rows as f8."""
    jdir, tdir, _, _ = written
    for fname in ("initial_state.h5", "floes.h5", "checkpoint.h5"):
        got, ref = _datasets(tdir / fname), _datasets(jdir / fname)
        types = {k: np.asarray(v).dtype.str for k, v in got.items()}
        assert types == {k: np.asarray(v).dtype.str for k, v in ref.items()}, fname
        for k, t in types.items():
            field = k.split("/")[-1]
            if field in ("nverts", "nsub", "id", "parent_id", "fuse_with"):
                assert t == "<i4", k
            elif field == "num_inters":
                assert t == "<i8", k
            elif field in ("active", "remove"):
                assert t == "|b1", k
            elif not k.startswith("rng/"):
                assert t == "<f8", k


def _sorted_rows(rows):
    rows = np.asarray(rows)
    return rows[np.lexsort(np.round(rows[:, [4, 1, 0]], 6).T)]


def test_floe_writer_interaction_rows_match(written_interactions):
    jdir, tdir = written_interactions
    got, ref = _datasets(tdir / "floes.h5"), _datasets(jdir / "floes.h5")
    assert sorted(got) == sorted(ref)
    assert {k.split("/")[0] for k in ref} == {"0", "5"}
    for k in ref:
        if k.endswith("/interactions"):
            assert got[k].shape[1] == 8 and len(ref[k]) >= 4  # two contacts, both sides
            _assert_close(_sorted_rows(got[k]), _sorted_rows(ref[k]), k)
        else:
            _assert_close(got[k], ref[k], k)
    assert got["0/num_inters"].sum() == len(got["0/interactions"])


@pytest.mark.parametrize("dims", [(5, 5), (4, 6)])
def test_eulerian_data_matches_jax(written, dims):
    """The last state of the writers' run, with numpy-seeded stress, strain,
    accelerations and overlap areas (so that every output has a scale of its
    own), re-gridded by both packages; (4, 6) keeps ``ny, nx = dims``, the
    reference layout's order."""
    from subzero_tpu.io.writers import eulerian_data as jax_eulerian_data

    _, _, jsim, tsim = written
    m = jsim.model
    N = m.floes.capacity
    rng = np.random.default_rng(7)
    jfl = m.floes._replace(
        stress_accum=jnp.asarray(rng.normal(size=(N, 2, 2)) * 1e3),
        strain=jnp.asarray(rng.normal(size=(N, 2, 2)) * 1e-6),
        p_dudt=jnp.asarray(rng.normal(size=N) * 1e-5),
        p_dvdt=jnp.asarray(rng.normal(size=N) * 1e-5),
        overarea=jnp.asarray(rng.random(N) * 1e6),
    )
    got = tw.eulerian_data(port_state(jfl, m.domain)[0], None, tsim.model.grid, dims)
    ref = jax_eulerian_data(jfl, m.ocean, m.grid, dims)
    assert list(got) == list(ref) == list(tw.GRID_OUTPUTS)
    for k in ref:
        assert got[k].shape == (dims[1], dims[0]), k
    _assert_grid_close(got, ref)
    assert np.abs(ref["stress_eig_grid"]).max() > 0


def test_grid_writer_netcdf_conventions(tmp_path):
    """tests/test_output.py:229-280 for the port's writer, on the lone square
    floe, and the file equal to the JAX writer's."""
    from subzero_tpu.core import BoundaryKind as BK
    from subzero_tpu.core.floes import build_floes

    grid = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    domain = make_domain(grid, *([BK.OPEN] * 4), dtype=jnp.float64)
    fs = FloeSettings(min_floe_area=0.0,
                      subfloe_point_generator=SubGridPointsGenerator(1e9))
    sq = [[2e4, 2e4], [6e4, 2e4], [6e4, 6e4], [2e4, 6e4]]
    floes = build_floes([sq], 0.5, 0.0, fs, N=4, dtype=jnp.float64)
    ocean = make_ocean(grid, u=0.0, v=0.0, temp=0.0, dtype=jnp.float64)
    tfl, toc, _, _, tgrid = port_state(floes, domain, ocean, grid=grid)
    for pkg, args, d in ((tw, (tfl, toc, tgrid), "port"),
                         (jw, (floes, ocean, grid), "jax")):
        w = pkg.GridOutputWriter(10, dims=(4, 4), dir=str(tmp_path / d),
                                 overwrite=True, dt=10.0)
        w.write(0, *args)
        w.write(10, *args)
        w.close()
    with h5py.File(tmp_path / "port" / "gridded_data.nc", "r") as f, \
            h5py.File(tmp_path / "jax" / "gridded_data.nc", "r") as fj:
        assert f.attrs["_NCProperties"].startswith(b"version=2")
        assert "type" in f.attrs
        for dim in ("time", "x", "y"):
            assert f[dim].attrs["CLASS"] == b"DIMENSION_SCALE"
        assert f["time"].maxshape == (None,)
        assert list(f["time"][()]) == [0.0, 10.0]
        assert f["time"].attrs["units"] == "10 seconds"
        assert f["x"].attrs["units"] == "meters"
        assert set(tw.GRID_OUTPUTS) == set(tw.GRID_ATTRS)
        assert tw.GRID_ATTRS == jw.GRID_ATTRS and tw.GRID_OUTPUTS == jw.GRID_OUTPUTS
        _assert_grid_close({k: f[k][()] for k in tw.GRID_OUTPUTS},
                           {k: fj[k][()] for k in tw.GRID_OUTPUTS})
        for name in tw.GRID_OUTPUTS:
            v = f[name]
            assert v.shape == (2, 4, 4)
            assert "DIMENSION_LIST" in v.attrs
            assert v.dims[0][0] == f["time"]
            assert v.dims[1][0] == f["x"]
            assert v.dims[2][0] == f["y"]
            unit, comment = tw.GRID_ATTRS[name]
            assert v.attrs["units"] == unit
            assert v.attrs["comments"] == comment
        # the lone floe covers 1.6e9 m^2 of the 1e10 m^2 domain
        si_total = f["si_frac_grid"][0].sum() / 16
        assert abs(si_total - 0.16) < 0.01


def test_device_halves_need_no_h5py():
    """With h5py missing, the io package, the tools and the examples import,
    and the device halves run; a file half raises ImportError."""
    code = textwrap.dedent("""
        import sys
        sys.modules["h5py"] = None
        import numpy as np, torch
        import subzero_tpu_torch.io as io
        import subzero_tpu_torch.tools.compare, subzero_tpu_torch.tools.fixtures
        import subzero_tpu_torch.tools.analyze_floe, subzero_tpu_torch.tools.plotting
        import subzero_tpu_torch.examples.restart_sim
        from subzero_tpu_torch import core
        from subzero_tpu_torch.io import writers as w
        grid = core.make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
        sq = [[2e4, 2e4], [6e4, 2e4], [6e4, 6e4], [2e4, 6e4]]
        fl = core.build_floes([sq], 0.5, 0.0, N=4, dtype=torch.float64, device="cpu")
        data = io.eulerian_data(fl, None, grid, (4, 4))
        assert abs(data["si_frac_grid"].sum() / 16 - 0.16) < 0.01
        assert w.floe_arrays(fl)["id"].tolist() == [1]
        try:
            io.FloeOutputWriter(1, dir=sys.argv[1]).write(0, fl)
        except ImportError:
            print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(REPO / "output")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
