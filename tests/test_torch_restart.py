"""Checkpoint/restart of the port (``subzero_tpu_torch.io.writers.restart``):

* a run resumed from a checkpoint reproduces the continuous run bit for bit,
  the generator's stream included (tests/test_restart.py:93-118, in the
  port);
* a checkpoint written by either package restarts the other: each continued
  10 steps and compared with the writing package's own continuation (f64,
  rtol 1e-9);
* the files' arrays, handed from the writers' device halves straight to
  ``restore_simulation`` (no h5py), give what the files give;
* ``restart`` without ``device`` wants the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    FractureSettings,
    HiblerYieldCurve,
    MonteCarloPointsGenerator,
)
from subzero_tpu.simulation import Simulation as JaxSimulation
from subzero_tpu.simulation import run as jax_run
from subzero_tpu_torch.core.model import make_model as torch_make_model
from subzero_tpu_torch.io import writers as tw
from subzero_tpu_torch.simulation import Simulation as TorchSimulation
from subzero_tpu_torch.simulation import run as torch_run

from torch_port_helpers import port_settings, port_state, to_np

FIELDS = ("id", "centroid", "u", "v", "xi", "height", "area", "nverts")


def _state():
    """tests/test_restart.py's field (6 floes at 0.4, periodic, f64)."""
    grid = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    ocean = make_ocean(grid, u=0.2, v=0.0, temp=0.0, dtype=jnp.float64)
    atmos = make_atmos(grid, temp=-1.0, dtype=jnp.float64)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), dtype=jnp.float64)
    fs = FloeSettings(
        min_floe_area=0.0,
        subfloe_point_generator=MonteCarloPointsGenerator(npoints=100),
    )
    floes = initialize_floe_field(
        6, [0.4], domain, 0.25, 0.0, fs, rng=np.random.default_rng(7),
        dtype=jnp.float64,
    )
    # very low fracture criteria so the RNG actually gets consumed
    frac = FractureSettings(fractures_on=True,
                            criteria=HiblerYieldCurve(pstar=1e-10, c=20.0),
                            dt=5, npieces=2)
    settings = dict(consts=Constants(E=1e6), dt=10, floe_settings=fs,
                    coupling_settings=CouplingSettings(two_way_coupling_on=False),
                    fracture_settings=frac, seed=11)
    return (grid, ocean, atmos, domain, floes), settings


def _jax_sim(state, settings, n_dt, out=None):
    grid, ocean, atmos, domain, floes = state
    writers = None if out is None else _writers(jw, out)
    return JaxSimulation(model=make_model(grid, ocean, atmos, domain, floes),
                         n_dt=n_dt, writers=writers, **settings)


def _torch_sim(state, settings, n_dt, out=None):
    grid, ocean, atmos, domain, floes = state
    tfl, toc, tat, tdom, tgrid = port_state(floes, domain, ocean, atmos, grid)
    writers = None if out is None else _writers(tw, out)
    return TorchSimulation(model=torch_make_model(tgrid, toc, tat, tdom, tfl),
                           n_dt=n_dt, writers=writers, **_port(settings))


def _port(settings):
    return {k: port_settings(v) for k, v in settings.items()}


def _writers(pkg, out):
    return pkg.OutputWriters(
        initial_state=pkg.InitialStateOutputWriter(dir=str(out), overwrite=True),
        checkpoint=pkg.CheckpointOutputWriter(10, dir=str(out), overwrite=True),
    )


def _paths(out):
    return str(out / "initial_state.h5"), str(out / "checkpoint.h5")


def _snapshot(floes):
    """The active floes' fields, in id order, as numpy."""
    act = to_np(floes.active).astype(bool)
    order = np.argsort(to_np(floes.id)[act])
    return {k: to_np(getattr(floes, k))[act][order] for k in FIELDS}


def _assert_snapshots(got, want, rtol=0.0):
    assert got["id"].tolist() == want["id"].tolist()
    for k in want:
        if rtol == 0.0 or want[k].dtype.kind != "f":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=rtol * scale, err_msg=k)


def test_resume_bit_exact(tmp_path):
    """tests/test_restart.py:93-118 in the port: 20 steps at once against 10
    steps with checkpoints, restarted from the last one for 10 more."""
    state, settings = _state()
    cont = torch_run(_torch_sim(state, settings, 20))
    want = _snapshot(cont.model.floes)

    split = _torch_sim(state, settings, 10, tmp_path)
    torch_run(split)
    sim, last = tw.restart(*_paths(tmp_path), 10, device="cpu", **_port(settings))
    assert last == 10
    assert sim.rng_state is not None
    assert sim.model.floes.verts.device.type == "cpu"
    torch_run(sim, start_tstep=last)
    # fracture must actually have created new floes (RNG was consumed after
    # the checkpoint) for the bit-exactness to mean anything
    assert int(np.max(want["id"])) > 6
    _assert_snapshots(_snapshot(sim.model.floes), want)
    assert sim.run_stats["rng_state"] == cont.run_stats["rng_state"]
    for f, x, y in zip(cont.model.floes._fields, sim.model.floes, cont.model.floes):
        assert torch.equal(x, y), f
    for f, x, y in zip(cont.model.ocean._fields, sim.model.ocean, cont.model.ocean):
        assert torch.equal(x, y), f


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Both packages run the field 10 steps, each writing its initial state
    and checkpoints into its own directory."""
    state, settings = _state()
    tmp = tmp_path_factory.mktemp("ckpt")
    jax_run(_jax_sim(state, settings, 10, tmp / "jax"))
    torch_run(_torch_sim(state, settings, 10, tmp / "port"))
    return tmp, settings


def _continue_jax(paths, settings):
    sim, last = jw.restart(*paths, 10, **settings)
    jax_run(sim, start_tstep=last)
    return last, _snapshot(sim.model.floes)


def _continue_port(paths, settings):
    sim, last = tw.restart(*paths, 10, device="cpu", **_port(settings))
    assert sim.model.floes.id.dtype == torch.int32
    assert sim.model.floes.verts.dtype == torch.float64
    torch_run(sim, start_tstep=last)
    return last, _snapshot(sim.model.floes)


def test_jax_checkpoint_restarted_by_the_port(checkpoints):
    tmp, settings = checkpoints
    paths = _paths(tmp / "jax")
    last_j, want = _continue_jax(paths, settings)
    last_t, got = _continue_port(paths, settings)
    assert last_j == last_t == 10
    assert int(np.max(want["id"])) > 6
    _assert_snapshots(got, want, rtol=1e-9)


def test_port_checkpoint_restarted_by_jax(checkpoints):
    tmp, settings = checkpoints
    paths = _paths(tmp / "port")
    last_t, want = _continue_port(paths, settings)
    last_j, got = _continue_jax(paths, settings)
    assert last_j == last_t == 10
    assert int(np.max(want["id"])) > 6
    _assert_snapshots(got, want, rtol=1e-9)


def test_arrays_restore_what_the_files_restore(checkpoints):
    """The device halves' arrays handed to ``restore_simulation`` (the path
    without h5py) give, bit for bit, the Simulation ``restart`` reads from
    the files they were written to."""
    tmp, settings = checkpoints
    state, _ = _state()
    sim = _torch_sim(state, settings, 10)
    m = sim.model
    initial = tw.initial_state_arrays(sim)
    ckpt = tw.checkpoint_arrays(m.floes, m.ocean, m.atmos, {"state": 1})
    mem = tw.restore_simulation(initial, ckpt, 7, device="cpu", **_port(settings))
    w = _writers(tw, tmp / "again")
    w.write_data(sim, 0, m.floes, m.ocean, m.domain, rng_state={"state": 1})
    w.close()
    files, last = tw.restart(*_paths(tmp / "again"), 7, device="cpu", **_port(settings))
    assert last == 0 and mem.rng_state == files.rng_state == {"state": 1}
    for name in ("floes", "ocean", "atmos"):
        a, b = getattr(mem.model, name), getattr(files.model, name)
        for f, x, y in zip(a._fields, a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{name}.{f}"
    for x, y in zip(mem.model.domain.topography, files.model.domain.topography):
        assert torch.equal(x, y)
    assert torch.equal(mem.model.domain.vals, files.model.domain.vals)
    assert mem.model.domain.kinds == files.model.domain.kinds
    assert mem.model.grid == files.model.grid
    skip = {"model", "writers", "n_overflow", "run_stats"}
    for f in dataclasses.fields(mem):
        if f.name not in skip:
            assert getattr(mem, f.name) == getattr(files, f.name), f.name
    assert mem.consts == sim.consts and mem.name == sim.name and mem.n_dt == 7


def test_restart_without_device_wants_the_card(checkpoints):
    tmp, settings = checkpoints
    paths = _paths(tmp / "port")
    if torch.cuda.is_available():
        sim, _ = tw.restart(*paths, 1, **_port(settings))
        assert sim.model.floes.verts.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tw.restart(*paths, 1, **_port(settings))
