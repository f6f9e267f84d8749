"""The port's domain decomposition as gloo ranks against the JAX package's on
the conftest's 8-device CPU mesh (f64).

Four rank processes of tests/torch_decomp_worker.py (no JAX in them) run every
scenario once, while this process runs the JAX package's counterparts; each
test compares one scenario.  Both sides start from the same pool bit for bit
(the port's constructors take tests/test_parallel.py's numpy seeds).

Tolerances: the gathered pools are compared ROW FOR ROW (the same floe in the
same row of the same rank's block): integer and boolean fields equal, floating
fields at rtol 1e-9 with an absolute floor of 1e-9 of each field's largest
magnitude; the integrator's accelerations, velocities and strain get the
floors of the forces they sum (``test_torch_slice._tendency_atol``), and the
contact diagnostics (collision force and torque, stresses, overlap) a floor
of 1e-8 of their largest magnitude: an overlap area is a shoelace sum over
coordinates up to 8e5 m here (periodic images of the wide domain), whose
summation order differs between the packages (the single-device step of the
wide configuration differs by 4e-10 of the largest torque at its first
contact step, at coordinates up to 1e5 m).  The ocean is held as
``torch_port_helpers.assert_ocean_close`` holds it.

``run_decomp`` with fracture is compared as one free run: both start from the
same bits, and no ridging pass moves volume before a fracture pass (the coin
flip of tests/test_torch_run.py needs one), so the fracture decisions agree.
"""

import os
import sys
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import torch_decomp_worker as worker
from subzero_tpu.constants import Constants
from subzero_tpu.core import (
    BoundaryKind,
    initialize_floe_field,
    initialize_floe_field_coords,
    make_atmos,
    make_domain,
    make_grid,
    make_model,
    make_ocean,
)
from subzero_tpu.parallel import (
    build_decomp_step,
    distribute,
    distribute_2d,
    gather,
    make_decomp,
    make_decomp_2d,
    run_decomp,
)
from subzero_tpu.settings import (
    CollisionSettings,
    CouplingSettings,
    FloeSettings,
    FractureSettings,
    HiblerYieldCurve,
    RidgeRaftSettings,
    SubGridPointsGenerator,
)
from subzero_tpu.simulation import Simulation
from test_parallel import make_wide_sim
from test_torch_slice import _tendency_atol
from torch_port_helpers import (Ranks, assert_fields_close, assert_ocean_close,
                                free_port, rank_env)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_decomp_worker.py")
SCENARIOS = ("step1d", "step2d", "migration", "fracture", "rr", "fuse", "identity",
             "scaling")
CONTACT_FIELDS = ("collision_force", "collision_trq", "stress_instant",
                  "stress_accum", "overarea")
CONTACT_ATOL_REL = 1e-8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("decomp_ranks"))
    port = free_port()
    r = Ranks(lambda k: [sys.executable, WORKER, str(k), "4", str(port), out,
                         ",".join(SCENARIOS)], 4, out)
    yield r
    r.kill()


def _pool(npz, prefix="floes"):
    n = len(prefix) + 1
    return types.SimpleNamespace(**{k[n:]: npz[k] for k in npz.files
                                    if k.startswith(prefix + ".")})


def _np(tree):
    return type(tree)(*(np.asarray(x) for x in tree))


def assert_pool_rows(got, ref, dt=20, what=""):
    """Row for row agreement of a port pool with the JAX package's (the
    module docstring's tolerances)."""
    ref = _np(ref)
    atol = _tendency_atol(ref, dt)
    for f in CONTACT_FIELDS:
        atol[f] = CONTACT_ATOL_REL * float(np.abs(getattr(ref, f)).max())
    assert_fields_close(got, ref, rtol=1e-9, atol_rel=1e-9, what=what, atol=atol)


def _steps(sim, dec, n, place):
    m = sim.model
    fd = place(m.floes, m.domain, dec)
    step = build_decomp_step(sim, dec)
    od, dd = m.ocean, m.domain
    overflow = []
    for k in range(n):
        fd, od, dd, ov = step(fd, od, dd, jnp.asarray(k))
        overflow.append(bool(ov))
    return types.SimpleNamespace(floes=gather(fd), ocean=od, overflow=overflow,
                                 layout=[dec.local_cap, dec.halo_cap, dec.mig_cap])


def _small_sim(**kw):
    """tests/test_parallel.py:make_sim with settings."""
    dtype = jnp.float64
    grid = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), dtype=dtype)
    fs = FloeSettings(min_floe_area=1e6,
                      subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2))
    floes = initialize_floe_field(16, [0.6], domain, 0.25, 0.0, fs,
                                  rng=np.random.default_rng(1), dtype=dtype)
    return Simulation(
        model=make_model(grid, make_ocean(grid, u=0.2, v=0.0, temp=0.0, dtype=dtype),
                         make_atmos(grid, temp=-1.0, dtype=dtype), domain, floes),
        consts=Constants(E=1e6), dt=20, n_dt=0, floe_settings=fs,
        coupling_settings=kw.pop("coupling_settings",
                                 CouplingSettings(two_way_coupling_on=True)),
        **kw,
    )


def _check_steps(ranks, name, ref):
    got = ranks.npz(name)
    assert got["layout"].tolist() == ref.layout
    assert got["overflow"].tolist() == ref.overflow
    assert_pool_rows(_pool(got), ref.floes, what=f"{name}: floes.")
    assert_ocean_close(_pool(got, "ocean"), _np(ref.ocean), what=f"{name}: ocean.")


def test_1d_four_slabs_match_jax_row_for_row(ranks):
    """make_wide_sim over 4 x-slabs (halos across both edges and through the
    periodic east edge), 5 steps, two-way coupling (the cross-rank cell
    sums), 32 candidate rows a floe as tests/test_parallel.py gives it."""
    sim = make_wide_sim()
    sim.pair_cap = 32 * sim.model.floes.capacity
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=4)
    ref = _steps(sim, dec, worker.N_STEPS, distribute)
    assert float(np.abs(np.asarray(ref.floes.collision_force)).max()) > 0  # contacts
    _check_steps(ranks, "step1d", ref)


def test_2d_two_by_two_matches_jax_row_for_row(ranks):
    """make_sim over 2 x 2 slabs: x pass, then y pass over the x-extended
    pool (corner halos), migration along x then y, 5 steps."""
    sim = _small_sim()
    sim.pair_cap = 32 * sim.model.floes.capacity
    dec = make_decomp_2d(sim.model.floes, sim.model.domain, n_dev=(2, 2))
    _check_steps(ranks, "step2d", _steps(sim, dec, worker.N_STEPS, distribute_2d))


def test_migration_keeps_every_floe_in_the_jax_layout(ranks):
    """60 steps of a strong eastward drift with collisions and coupling off:
    floes cross slab edges and the periodic east edge; every id survives,
    no step overflows, and each lands in the row JAX's insertion gives it."""
    sim = make_wide_sim(coupling_settings=CouplingSettings(coupling_on=False),
                        collision_settings=CollisionSettings(collisions_on=False))
    m = sim.model
    floes = m.floes._replace(u=jnp.where(m.floes.active, 500.0, 0.0),
                             p_dudt=jnp.zeros_like(m.floes.p_dudt))
    sim.model = m.replace(floes=floes)
    dec = make_decomp(floes, m.domain, n_devices=4)
    ref = _steps(sim, dec, worker.MIGRATION_STEPS, distribute)
    got = ranks.npz("migration")
    assert not any(got["overflow"])
    ids0 = sorted(np.asarray(floes.id)[np.asarray(floes.active)].tolist())
    act = got["floes.active"]
    assert sorted(got["floes.id"][act].tolist()) == ids0
    # floes changed rank: their rows are not those of distribute at step 0
    assert not np.array_equal(got["floes.id"],
                              np.asarray(distribute(floes, m.domain, dec).id))
    _check_steps(ranks, "migration", ref)


def test_comm_identity_moves_no_data(ranks):
    """With ``decomp.COMM_IDENTITY`` (the timing diagnostic) every exchange
    hands a rank its own buffers: no message, and floes that drift out of
    their slab stay with their rank."""
    outside = 0
    for r in range(4):
        got = ranks.rank_json("identity", r)
        assert got["messages"] == 0 and not any(got["overflow"])
        assert got["ids1"] == got["ids0"]
        outside += got["outside"]
    assert outside > 0


def test_measure_decomp_scaling_on_four_ranks(ranks):
    """Steps/s on one rank (rank 0 through a one-rank subgroup) and on four,
    the same figures on every rank."""
    got = [ranks.rank_json("scaling", r) for r in range(4)]
    assert all(g == got[0] for g in got)
    assert set(got[0]) == {"1", "4", "efficiency"}
    assert got[0]["1"] > 0 and got[0]["4"] > 0
    assert got[0]["efficiency"] == pytest.approx(got[0]["4"] / got[0]["1"])


class RecordingWriters(worker.RecordingWriters):
    """The worker's writer stand-in, for the JAX run."""


def _lifecycle_sim(kind):
    over = ({"fracture_settings": FractureSettings(
        fractures_on=True, criteria=HiblerYieldCurve(pstar=1e-10, c=20.0), dt=4,
        npieces=2)} if kind == "fracture" else {"ridgeraft_settings": RidgeRaftSettings(
            ridge_raft_on=True, dt=3, ridge_probability=1.0, raft_probability=1.0,
            min_overlap_frac=0.0)})
    sim = _small_sim(coupling_settings=CouplingSettings(two_way_coupling_on=False), **over)
    sim.pair_cap = 32 * sim.model.floes.capacity
    sim.n_dt = worker.FRACTURE_N_DT if kind == "fracture" else worker.RR_N_DT
    return sim


def _conservation(floes, ocean):
    m = jnp.where(floes.active, floes.mass, 0.0)
    return {"ke": jnp.sum(0.5 * m * (floes.u ** 2 + floes.v ** 2)),
            "px": jnp.sum(m * floes.u), "mass": jnp.sum(m)}


@pytest.fixture(scope="module")
def jax_fracture():
    """run_decomp with fracture every 4 steps, the recording writers and
    ``collect``, over 4 slabs, 12 steps."""
    sim = _lifecycle_sim("fracture")
    sim.writers = RecordingWriters()
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim, got = run_decomp(sim, dec, collect=_conservation)
    return types.SimpleNamespace(sim=sim, collected=got, writes=sim.writers.calls)


def test_run_decomp_with_fracture_matches_jax(ranks, jax_fracture):
    got = ranks.npz("fracture")
    ref = jax_fracture.sim.model.floes
    n0 = 16
    assert int(got["floes.active"].sum()) > n0  # pieces were made
    assert int(got["n_overflow"]) == 0
    stats = ranks.rank_json("fracture", 0)["run_stats"]
    assert stats["host_pass_count"]["fracture"] == 3
    assert_pool_rows(_pool(got), ref, what="fracture: floes.")
    assert_ocean_close(_pool(got, "ocean"), _np(jax_fracture.sim.model.ocean))


def test_run_decomp_collect_series_matches_jax(ranks, jax_fracture):
    """The per-step sums of ``collect``, summed over the ranks in rank order,
    equal the JAX package's psum over the mesh, step for step (13 steps)."""
    got = ranks.npz("fracture")
    for k in ("ke", "px", "mass"):
        want = np.asarray(jax_fracture.collected[k])
        assert got[f"collect.{k}"].shape == want.shape == (worker.FRACTURE_N_DT + 1,)
        np.testing.assert_allclose(got[f"collect.{k}"], want, rtol=1e-9, err_msg=k)


def test_writers_fire_on_rank_0_only(ranks, jax_fracture):
    """Rank 0 writes at the JAX run's steps with the JAX run's generator
    states, on the gathered [D * local_cap] pool; no other rank writes."""
    calls = ranks.rank_json("fracture", 0)["writes"]
    assert [c[0] for c in calls] == [0, 6, 12]
    assert calls == jax_fracture.writes
    for r in (1, 2, 3):
        assert ranks.rank_json("fracture", r)["writes"] == []


def test_run_decomp_interleaved_ridge_raft_matches_jax(ranks):
    """Ridge/raft every 3 steps between the collide and finish halves, with
    the per-floe stress rows carried across the redistribution, 7 steps;
    volume conserved."""
    sim = _lifecycle_sim("rr")
    assert sim.interleave_ridge_raft
    dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=4)
    m0 = sim.model.floes
    act0 = np.asarray(m0.active)
    vol0 = float((np.asarray(m0.area) * np.asarray(m0.height))[act0].sum())
    with np.errstate(all="ignore"):
        sim = run_decomp(sim, dec)
    got = ranks.npz("rr")
    assert ranks.rank_json("rr", 0)["run_stats"]["host_pass_count"]["ridge_raft"] == 2
    act = got["floes.active"]
    vol1 = float((got["floes.area"] * got["floes.height"])[act].sum())
    np.testing.assert_allclose(vol1, vol0, rtol=1e-6)
    assert_pool_rows(_pool(got), sim.model.floes, what="rr: floes.")


def test_fused_marked_pair_matches_jax(ranks):
    """test_parallel.py's fuse configuration over 2 slabs (ranks 0 and 1 of a
    subgroup): the 90%-overlap pair on slab 1 fuses into one new floe, the
    others keep their ids, mass is conserved, and the pool equals JAX's."""
    dtype = jnp.float64
    grid = make_grid(0.0, 8e5, 0.0, 1e5, Nx=40, Ny=5)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), dtype=dtype)
    fs = FloeSettings(min_floe_area=1e6,
                      subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2))

    def sq(x0, y0, s=2e4):
        return [[x0, y0], [x0 + s, y0], [x0 + s, y0 + s], [x0, y0 + s]]

    coords = [sq(0.5e5, 3e4), sq(2.5e5, 3e4), sq(6.0e5, 4e4), sq(6.02e5, 4e4)]
    floes = initialize_floe_field_coords(coords, domain, 0.25, 0.0, fs,
                                         rng=np.random.default_rng(0), dtype=dtype)
    sim = Simulation(
        model=make_model(grid, make_ocean(grid, u=0.0, v=0.0, temp=0.0, dtype=dtype),
                         make_atmos(grid, temp=-1.0, dtype=dtype), domain, floes),
        consts=Constants(E=1e6), dt=20, n_dt=1, floe_settings=fs,
        coupling_settings=CouplingSettings(coupling_on=False),
        collision_settings=CollisionSettings(),
    )
    sim = run_decomp(sim, make_decomp(floes, domain, n_devices=2))
    got = ranks.npz("fuse")
    act0 = np.asarray(floes.active)
    ids0 = set(np.asarray(floes.id)[act0].tolist())
    pair = {int(i) for i, x in zip(np.asarray(floes.id)[act0],
                                   np.asarray(floes.centroid)[act0, 0]) if x > 4e5}
    act = got["floes.active"]
    ids1 = set(got["floes.id"][act].tolist())
    assert int(act.sum()) == 3 and not ids1 & pair and ids0 - pair <= ids1
    assert max(ids1) > max(ids0)
    np.testing.assert_allclose(got["floes.mass"][act].sum(),
                               np.asarray(floes.mass)[act0].sum(), rtol=1e-9)
    assert ranks.rank_json("fuse", 1)["run_stats"]["host_pass_count"]["fuse"] == 1
    assert_pool_rows(_pool(got), sim.model.floes, what="fuse: floes.")


def test_step_sends_four_messages_and_reduces_once(ranks):
    """What a rank's step costs in messages on 4 periodic slabs: one halo and
    one migration buffer to each neighbour, one ordered sum (the dissolved
    deposit) and one flag reduction; collect adds one ordered sum a leaf.
    On the CPU nothing is staged through host memory."""
    steps = worker.FRACTURE_N_DT + 1
    for r in range(4):
        comm = ranks.rank_json("fracture", r)["run_stats"]["comm"]
        assert comm["messages"] == 4 * steps
        assert comm["flag_reductions"] == steps
        assert comm["reductions"] == (1 + 3) * steps
        assert comm["staging_copies"] == 0


def test_example_runs_as_two_ranks(tmp_path):
    """``python -m subzero_tpu_torch.examples.distributed_shear_flow`` as
    torchrun starts it (env://), two gloo ranks on the CPU at 60 floes and 20
    steps: both exit 0, rank 0 alone reports and writes, no floe is lost."""
    from subzero_tpu_torch.examples import shear_flow

    port = free_port()
    out = tmp_path / "out"

    def env(r):
        return dict(rank_env(), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                    WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r))

    cmd = [sys.executable, "-m", "subzero_tpu_torch.examples.distributed_shear_flow",
           "--backend", "gloo", "--device", "cpu", "--n-dt", "20", "--n-floes", "60",
           "--out-dir", str(out)]
    r = Ranks(lambda k: cmd, 2, str(tmp_path), env={k: env(k) for k in range(2)},
              timeout=300).wait()
    logs = [open(f).read() for f in r.logs]
    n0 = int(shear_flow.build(n_floes=60, device="cpu").model.floes.count())
    assert "ran 20 steps" in logs[0] and f"; {n0} floes" in logs[0], logs[0]
    assert "ran 20 steps" not in logs[1]
    assert sorted(os.listdir(out)) == ["floes.h5", "initial_state.h5"]
