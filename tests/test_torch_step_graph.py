"""The device step as a CUDA graph (subzero_tpu_torch/step_graph.py), on
the CPU: what makes the step capturable, and the loop around the graph.

* The step body reads nothing on the host: under a dispatch mode that
  raises on every op that hands a tensor's value to Python (``item``,
  ``int()``, ``bool()``, ``nonzero``, a boolean index, ``masked_select``,
  a tensor made from host data), every program of the step runs through,
  on a bench field (coupling and plain steps, and the two halves), on the
  cut life-cycle pool of ``tests/data/lifecycle_step526_crowded.npz``, on a
  packed field whose slow path has slow pairs and runs its parity retry,
  and with moving walls.  The narrow phase goes through the g++ build of
  the kernel's arithmetic bound by ctypes, as the card's wrapper binds the
  kernel: the plain version stands in for the kernel on the CPU only, and
  trims its ring width by a read that the card never makes.
* ``intersect_regions`` is row-independent: the first k rows of a batch
  give the same bits as a batch of those k rows, so the slow path's full
  ``slow_cap`` batch gives the step the tiers gave it.
* The coupling's clip on 16 vertex slots equals the full width, bit for
  bit, on rings of at most 16 vertices (the JAX package's ``lax.cond``).
* ``run_scan`` through the graph's buffers equals the eager loop of
  ``build_step`` over 20 steps with coupling at its cadence; what
  ``collect`` returns is its own; the caller's state is never written.
* A Simulation keeps its StepGraph: a second run replays it and ends
  where a fresh Simulation's run does; other settings make a new one; the
  Simulation and its graph are freed without the cycle collector.
* ``run`` across fuse, fracture and ridge/raft passes, with the state
  copied back into the buffers after each, ends in the same bits as the
  reference's order of events written out as a plain loop of the eager
  step's halves and the host passes.
"""

import dataclasses
import gc
import json
import warnings
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from subzero_tpu_torch.bench import build_sim
from subzero_tpu_torch.constants import Constants
from subzero_tpu_torch.core import make_atmos, make_grid, make_model, make_ocean
from subzero_tpu_torch.core.domain import Domain, empty_topography
from subzero_tpu_torch.core.floes import FloeState
from subzero_tpu_torch.examples import many_floes, moving_bounds
from subzero_tpu_torch.geometry import two_cross
from subzero_tpu_torch.geometry.clip import first_true, intersect_regions
from subzero_tpu_torch.physics import collisions as tcol
from subzero_tpu_torch.physics import coupling as tcpl
from subzero_tpu_torch.settings import CollisionSettings, HiblerYieldCurve
from subzero_tpu_torch import simulation as tsim
from subzero_tpu_torch.simulation import Simulation, build_step, build_step_parts, run, run_scan
from subzero_tpu_torch.step_graph import StepGraph

from test_collisions import CONSTS, CSET
from test_torch_collisions_slow_path import PACKED_CASES, PERIODIC_DOMAIN, _packed_field
from torch_port_helpers import build_host_shim, port_settings, port_state, run_host_shim_pairs

POOL = Path(__file__).parent / "data" / "lifecycle_step526_crowded.npz"

# aten ops that hand a tensor's value to the host (or make a tensor from
# host data, an upload on the card)
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "lift_fresh",
              "equal", "is_nonzero", "item", "unique", "_unique", "_unique2",
              "unique_dim", "unique_consecutive", "repeat_interleave"}


class HostReads(TorchDispatchMode):
    """Raises on every op that reads a tensor's value on the host.  On the
    CPU ``tolist``, ``numpy`` and ``cpu`` read memory without an aten op,
    so they are replaced while the mode is on."""

    PATCHED = ("tolist", "numpy", "__array__", "cpu")

    def __enter__(self):
        self.saved = {k: getattr(torch.Tensor, k) for k in self.PATCHED}

        def refuse(name):
            def fn(*a, **kw):
                raise AssertionError(f"the step reads the device on the host: Tensor.{name}")
            return fn

        for k in self.PATCHED:
            setattr(torch.Tensor, k, refuse(k))
        return super().__enter__()

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(torch.Tensor, k, v)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bad = name in HOST_READS
        if name in ("index", "index_put", "index_put_"):
            bad = any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
                      for t in args[1] if t is not None)
        if bad:
            raise AssertionError(f"the step reads the device on the host: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return build_host_shim(tmp_path_factory.mktemp("shim"))


def _pool_sim():
    """The cut life-cycle pool (f32, open box) with a still ocean."""
    z = np.load(POOL)
    meta = json.loads(str(z["meta"]))
    fl = FloeState(**{k[len("floes_"):]: torch.from_numpy(z[k])
                      for k in z.files if k.startswith("floes_")})
    vals = torch.from_numpy(z["domain_vals"])
    dom = Domain(kinds=tuple(meta["domain_kinds"]), vals=vals,
                 velocities=torch.from_numpy(z["domain_velocities"]),
                 topography=empty_topography(dtype=fl.verts.dtype, device="cpu"))
    n, s, e, w = vals.tolist()
    grid = make_grid(w, e, s, n, Nx=20, Ny=20)
    kw = dict(dtype=fl.verts.dtype, device="cpu")
    model = make_model(grid, make_ocean(grid, u=0.1, **kw), make_atmos(grid, **kw), dom, fl)
    return Simulation(model=model, consts=Constants(), dt=20, bins=None,
                      pair_cap=meta["pair_cap_rows_a_floe"] * fl.capacity)


def _packed_sim(case="parity_retry"):
    r0, spike, clip_cap, _ = PACKED_CASES[case]
    tfl, _, _, tdom, _ = port_state(_packed_field(r0, spike), PERIODIC_DOMAIN)
    grid = make_grid(-1e5, 1e5, -1e5, 1e5, dx=1e4, dy=1e4)
    kw = dict(dtype=torch.float64, device="cpu")
    model = make_model(grid, make_ocean(grid, **kw), make_atmos(grid, **kw), tdom, tfl)
    return Simulation(model=model, consts=port_settings(CONSTS), dt=10, bins=None,
                      collision_settings=port_settings(CSET), pair_cap=320,
                      clip_cap=clip_cap)


def _debug(sim):
    m = sim.model
    _, dbg = tcol.timestep_collisions(m.floes, m.domain, sim.consts, float(sim.dt),
                                      sim.collision_settings, sim.pair_cap,
                                      sim.clip_cap, sim.bins, with_debug=True)
    return {k: int(v) for k, v in dbg.items()}


FIELDS = {
    "bench_field": lambda: build_sim(300, 1e5, 4e3, device="cpu"),
    "crowded_pool": _pool_sim,
    "slow_pairs_and_parity_retry": _packed_sim,
    "moving_walls": lambda: moving_bounds.build(n_floes=40, device="cpu"),
}


@pytest.mark.parametrize("field", list(FIELDS))
def test_step_body_reads_nothing_on_the_host(field, shim, monkeypatch):
    sim = FIELDS[field]()
    if field == "slow_pairs_and_parity_retry":
        dbg = _debug(sim)
        assert dbg["n_slow"] > 0 and dbg["n_parity_bad"] > 0, dbg
    if field == "crowded_pool":
        assert _debug(sim)["pairs_overflow"] == 1
    if field == "moving_walls":
        assert 3 in sim.model.domain.kinds
    monkeypatch.setattr(tcol, "two_cross_dispatch",
                        lambda *a: run_host_shim_pairs(shim, *a))
    graph = StepGraph(sim)
    vals0 = graph.domain.vals.clone()
    with HostReads():
        for prog in (("step", True), ("step", False), ("collide",), ("finish", True)):
            graph.replay(prog)
    assert graph.stats["replays"] == 4
    if field == "moving_walls":  # three steps moved the walls
        assert not torch.equal(graph.domain.vals, vals0)


def _slow_rows(sim):
    """The slow path's inputs on a field: the rows of its full batch."""
    m = sim.model
    nb = tcol.narrow_phase_batch(m.floes, m.domain, sim.pair_cap, sim.bins)
    tc = tcol.two_cross_dispatch(*nb.two_cross_args())
    PC = nb.pairs.qi.shape[0]
    slow_cap = max(sim.pair_cap // 128, 32)
    ssel = first_true((tc.cnt > 0) & ~tc.ok, slow_cap, PC)
    n_slow = int((ssel < PC).sum())
    safe = torch.clamp(ssel, max=PC - 1)
    i, j, sh = nb.pairs.qi[safe], nb.pairs.qj[safe], nb.pairs.shift[safe]
    args = (m.floes.verts[i], m.floes.nverts[i], nb.q_verts[j] + sh[:, None, :],
            nb.q_n[j])
    return nb, tc, args, nb.perturb[safe], n_slow


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_intersect_regions_is_row_independent(dtype):
    """The first k rows of the slow path's full batch, clipped in it and
    clipped alone, give the same bits; so does the slow path's result on
    its slow rows against a clip of just those rows."""
    sim = _packed_sim("beyond_first_tier")
    m = sim.model
    sim.model = m.replace(floes=m.floes.to(dtype=dtype), domain=dataclasses.replace(
        m.domain, vals=m.domain.vals.to(dtype), velocities=m.domain.velocities.to(dtype)))
    nb, tc, args, pert, n_slow = _slow_rows(sim)
    assert n_slow > 8, n_slow
    full = intersect_regions(*args, CAP=sim.clip_cap, perturb=pert)
    for k in (1, 7, n_slow):
        part = intersect_regions(*(a[:k] for a in args), CAP=sim.clip_cap, perturb=pert[:k])
        for f, x, y in zip(full._fields, full, part):
            assert torch.equal(x[:k], y), (k, f)
    slow = tcol._slow_path(sim.model.floes, nb, tc, sim.pair_cap, sim.clip_cap, retry=True)
    assert int(slow.n_slow) == n_slow and int(slow.valid.sum()) == n_slow
    part = intersect_regions(*(a[:n_slow] for a in args), CAP=sim.clip_cap,
                             perturb=pert[:n_slow])
    for f, x, y in zip(part._fields, slow.regions, part):
        assert torch.equal(x[:n_slow], y), f


def test_coupling_clip_on_16_slots_equals_the_full_width():
    calls = []
    for dtype in (torch.float32, torch.float64):
        sim = build_sim(300, 1e5, 4e3, device="cpu", dtype=dtype)
        f, g, d = sim.model.floes, sim.model.grid, sim.model.domain
        assert f.verts.shape[1] == 32 and int(f.nverts.max()) <= 16
        cap = sim.cell_cap
        cx0 = torch.floor((f.centroid[:, 0] - g.x0) / g.dx + 0.5).long()
        cy0 = torch.floor((f.centroid[:, 1] - g.y0) / g.dy + 0.5).long()
        offs = torch.arange(cap) - cap // 2
        orig = tcpl._clip_area_to_rects

        def spy(verts, nv, *rects):
            calls.append(rects)
            return orig(verts, nv, *rects)

        tcpl._clip_area_to_rects = spy
        try:
            tcpl._floe_cell_areas(f, g, d, cap, cx0, cy0, offs)
        finally:
            tcpl._clip_area_to_rects = orig
        rects = calls[-1]
        full = orig(f.verts, f.nverts, *rects)
        assert torch.equal(full, orig(f.verts[:, :16], f.nverts, *rects)), dtype
        assert bool((full > 0).any())


def test_run_scan_through_the_graph_equals_the_eager_loop():
    sim = build_sim(300, 1e5, 4e3, device="cpu")
    base = sim.model
    kept = [t.clone() for t in base.floes]
    start, n = 1, 20  # coupling at steps 10 and 20

    got, coll = run_scan(dataclasses.replace(sim), n, start_tstep=start,
                         collect=lambda f, o: (f.u, o.tau_x))
    step = build_step(sim)
    f, o, d = base.floes, base.ocean, base.domain
    us, taus = [], []
    for t in range(start, start + n):
        f, o, d, _ = step(f, o, d, t)
        us.append(f.u)
        taus.append(o.tau_x)
    for x, y in zip((*got.model.floes, *got.model.ocean, got.model.domain.vals),
                    (*f, *o, d.vals)):
        assert torch.equal(x, y)
    assert torch.equal(coll[0], torch.stack(us)) and torch.equal(coll[1], torch.stack(taus))
    assert not torch.equal(coll[1][8], coll[1][9])  # coupling ran at step 10
    assert all(torch.equal(x, y) for x, y in zip(base.floes, kept))
    assert got.run_stats["graph"]["replays"] == n
    assert got.n_overflow == 0


def test_simulation_keeps_its_graph():
    sim = build_sim(300, 1e5, 4e3, device="cpu")
    m0 = sim.model
    run_scan(sim, 3)
    graph = sim.step_graph()
    sim.model = m0
    again, _ = run_scan(sim, 12)
    assert sim.step_graph() is graph and again.run_stats["graph"]["replays"] == 12
    fresh, _ = run_scan(dataclasses.replace(sim, model=m0), 12)
    for x, y in zip((*again.model.floes, *again.model.ocean), (*fresh.model.floes,
                                                                 *fresh.model.ocean)):
        assert torch.equal(x, y)
    # a state of another shape is loaded into the same graph; another
    # setting makes a new one
    sim.model = build_sim(400, 1.2e5, 4e3, device="cpu").model.replace(
        grid=m0.grid, atmos=m0.atmos)
    assert sim.step_graph() is graph
    sim.collision_settings = CollisionSettings(floe_floe_max_overlap=0.3)
    assert sim.step_graph() is not graph
    # neither the Simulation nor its graph is kept alive by a cycle
    refs = weakref.ref(sim), weakref.ref(sim.step_graph())
    gc.disable()
    try:
        del sim, again, graph
        assert refs[0]() is None and refs[1]() is None
    finally:
        gc.enable()


def test_graph_buffers_are_its_own():
    sim = build_sim(300, 1e5, 4e3, device="cpu")
    m = sim.model
    graph = StepGraph(sim)
    ptrs = {t.untyped_storage().data_ptr() for t in (*graph.floes, *graph.ocean)}
    assert not ptrs & {t.untyped_storage().data_ptr() for t in (*m.floes, *m.ocean)}
    out, _, _ = graph.state()
    graph.step(0)
    assert torch.equal(out.u, m.floes.u)
    assert not torch.equal(graph.floes.u, m.floes.u)
    owned = graph.own({"u": graph.floes.u, "fresh": graph.floes.u + 0})
    assert owned["u"] is not graph.floes.u and torch.equal(owned["u"], graph.floes.u)
    # sources that are other static buffers are read before any is written
    u, v = graph.floes.u.clone(), graph.floes.v.clone()
    graph.load(graph.floes._replace(u=graph.floes.v, v=graph.floes.u))
    assert torch.equal(graph.floes.u, v) and torch.equal(graph.floes.v, u)
    # a state of the same shape is copied in; another shape replaces the buffers
    graph.load(m.floes)
    assert torch.equal(graph.floes.u, m.floes.u)
    u_buf = graph.floes.u
    big = build_sim(400, 1.2e5, 4e3, device="cpu").model.floes
    graph.load(big)
    assert graph.floes.u is not u_buf and graph.floes.capacity == big.capacity
    n0 = two_cross.launch_count()
    two_cross.add_replayed(3)
    assert two_cross.launch_count() == n0 + 3


def _lifecycle_sim():
    """examples/many_floes.py at 60 floes, with the passes' cadences
    shortened, the fuse threshold and the yield curve lowered, so that 50
    steps of ``run`` cross ridge/raft (mid-step), fracture, smoothing and
    fuse passes, and both fracture passes break floes."""
    sim = many_floes.build(device="cpu", n_floes=60, n_dt=50)
    sim.verbose = False
    sim.collision_settings = CollisionSettings(floe_floe_max_overlap=0.01)
    sim.ridgeraft_settings = dataclasses.replace(sim.ridgeraft_settings, dt=15)
    sim.fracture_settings = dataclasses.replace(sim.fracture_settings, dt=20,
                                                criteria=HiblerYieldCurve(pstar=1e3))
    return sim


def _plain_run(sim):
    """``run``'s order of events (simulation.jl:94-220) as a plain loop of
    the eager step's halves on the caller's tensors: ridge/raft between the
    halves at its cadence, then every host pass whose cadence falls on the
    step (fuse whenever a pair is marked).  The reference ``run`` is held
    to.  On the yield curve's default (no floe breaks), ``run`` reached the
    same bits at commit fa75f58, whose ``run`` stepped eagerly with the slow
    path's tiers and the coupling's 16-slot branch chosen on the host
    (sha256 of the end state's floe and ocean bytes
    f2f619d9b7707747580f34651a87c48a7beab8a30c96838528677de9244aa6b6)."""
    collide, finish = build_step_parts(sim)
    rr = sim.ridgeraft_settings
    m = sim.model
    floes, ocean, domain = m.floes, m.ocean, m.domain
    rng = np.random.default_rng(sim.seed)
    state = tsim._new_run_state(int(torch.max(floes.id)))
    for t in range(sim.n_dt + 1):
        rr_now = rr.ridge_raft_on and rr.dt > 0 and t > 0 and t % rr.dt == 0
        floes, domain, si, _ = collide(floes, ocean, domain, t)
        if rr_now:
            floes = tsim._host_ridge_raft(sim, floes, domain, t, rng, state)
        floes, ocean, domain, _ = finish(floes, ocean, domain, si, t)
        floes = tsim._host_lifecycle_passes(sim, floes, domain, t, rng, state,
                                            skip_ridge_raft=rr_now)
    return floes, ocean, state


def test_run_across_host_passes_ends_where_the_eager_run_did():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = run(_lifecycle_sim())
        floes, ocean, state = _plain_run(_lifecycle_sim())
    st = sim.run_stats
    assert st["host_pass_count"] == {"ridge_raft": 3, "fracture": 2, "weld": 0,
                                     "smooth": 2, "fuse": 2}
    assert st["host_pass_count"] == state["passes"]
    assert st["segments"] == 7 and sim.n_overflow == 0
    assert st["max_floe_id"] > 63 * 2  # both fracture passes broke floes
    # every step a replay; the ridge/raft steps replay their two halves
    assert st["graph"]["replays"] == st["steps"] + st["host_pass_count"]["ridge_raft"]
    assert st["max_floe_id"] == state["max_floe_id"]
    for x, y in zip((*sim.model.floes, *sim.model.ocean), (*floes, *ocean)):
        assert torch.equal(x, y)
