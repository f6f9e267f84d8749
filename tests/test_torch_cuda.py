"""The port on the card: the narrow-phase CUDA kernel against its plain
PyTorch version, the wrapper's checks, the slow clip's kernel against its
g++ shim (bitwise) and its plain version, with n_slow read on the card, a short run_scan that goes through
the kernel and agrees with the CPU run, the step's CUDA graph against the
eager step (bitwise) and a capture that fails (it raises), ``pair_overlaps``
on the card against the CPU, a 20-step ``run`` with a fracture pass, the
JAX package's f32 conservation gate (5 000 steps of head_on and
three_floes), the force law's kernel (B4) against the plain force law,
in the step, its graph, ``pair_interactions`` and a restart, to the bit,
the binned broad phase's counters in the graph against the CPU's, and the
coupling's cell clip (B6) against its plain version, alone and in the
coupling, to the bit, with its launches and its count of window cells in
the graph.

Every test is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports no JAX, so it runs on a machine that has none, without the JAX-side
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 those of tests/test_pallas_clip.py, f64 rtol 1e-9 (kernel
vs plain); the slow clip against its plain version on the card by
``regions.held_against_plain`` (counts and flags as the plain version at the
same dtype decides them, every floating field within ``LIMIT_SAME`` eps L^p
of it, L the row's largest coordinate, areas and first moments within
``LIMIT_F64`` eps L^p of the plain version in f64); 1e-6 of each
field's largest magnitude for 10 f64 steps on the card vs the CPU
(summation order only, amplified by contact dynamics).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from subzero_tpu_torch.constants import Constants
from subzero_tpu_torch.core import (
    BoundaryKind,
    initialize_floe_field,
    make_atmos,
    make_domain,
    make_grid,
    make_model,
    make_ocean,
)
from subzero_tpu_torch.core.domain import make_topography
from subzero_tpu_torch.core.floes import build_floes
from subzero_tpu_torch.geometry import regions
from subzero_tpu_torch.geometry import two_cross as tc_kernel
from subzero_tpu_torch.geometry.clip import (
    TWO_CROSS_ARGS,
    first_true,
    two_cross_dispatch,
    two_cross_pairs,
)
from subzero_tpu_torch.physics import cell_clip
from subzero_tpu_torch.physics import collisions as tcol
from subzero_tpu_torch.physics import coupling as tcpl
from subzero_tpu_torch.physics import forces
from subzero_tpu_torch.physics.collisions import pair_overlaps
from subzero_tpu_torch.settings import (
    CollisionSettings,
    CouplingSettings,
    FloeSettings,
    FractureSettings,
    HiblerYieldCurve,
    SubGridPointsGenerator,
)
from subzero_tpu_torch.simulation import Simulation, run, run_scan

from torch_port_helpers import (
    REPO,
    WIDE_CLIP_CAP,
    WIDE_PAIR_CAP,
    WIDE_U,
    WIDE_V,
    WIDE_V_VEL,
    Ranks,
    assert_two_cross_close,
    build_pair_list,
    build_regions_shim,
    card_sum,
    coupling_cell_inputs,
    cuda_or_skip,
    free_port,
    lattice_pairs,
    tt,
    wide_field_coords,
)

# rings up to 32 vertices take the kernel's first instantiation, wider ones
# (up to MAX_VERTS = 128) its wide instantiations
CASES = [(np.float32, 16), (np.float64, 16), (np.float32, 32), (np.float64, 32),
         (np.float32, 40), (np.float64, 40), (np.float32, 128)]
IDS = ["f32-V16", "f64-V16", "f32-V32", "f64-V32", "f32-V40", "f64-V40", "f32-V128"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,V", CASES, ids=IDS)
def test_cuda_kernel_matches_plain(dtype, V):
    dev = cuda_or_skip()
    np_args = build_pair_list(B=4096, seed=3, V=V, nmax=V, dtype=dtype)
    args = [a.to(dev) for a in tt(*np_args)]
    ref = two_cross_pairs(*args)
    before = tc_kernel.launch_count()
    got = two_cross_dispatch(*args)
    torch.cuda.synchronize()
    assert tc_kernel.launch_count() == before + 1
    assert_two_cross_close(got, ref, dtype == np.float64)
    invalid = ~args[-1]
    for f, x in zip(got._fields, got):  # rows that are no pair: exact zeros
        assert not bool(x[invalid].any()), f
    again = two_cross_dispatch(*args)
    for f, x, y in zip(got._fields, got, again):  # same bits every launch
        assert torch.equal(x, y), f


def _replace(args, **kw):
    return [kw.get(name, a) for name, a in zip(TWO_CROSS_ARGS, args)]


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_cannot_take():
    dev = cuda_or_skip()
    cpu = tt(*build_pair_list(B=8, V=16, dtype=np.float32))
    args = [a.to(dev) for a in cpu]
    p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, valid = args
    with pytest.raises(ValueError, match="CUDA"):
        tc_kernel.two_cross_cuda(*cpu)
    with pytest.raises(ValueError, match="CUDA"):  # one stray CPU tensor
        two_cross_dispatch(*_replace(args, perturb=cpu[7]))
    wide = torch.zeros((8, tc_kernel.MAX_VERTS + 1, 2), dtype=p_verts.dtype, device=dev)
    with pytest.raises(ValueError, match="ring width 129 > 128"):
        two_cross_dispatch(*_replace(args, q_verts=wide))
    with pytest.raises(TypeError, match="p_n"):
        two_cross_dispatch(*_replace(args, p_n=p_n.long()))
    with pytest.raises(TypeError, match="qi"):
        two_cross_dispatch(*_replace(args, qi=qi.int()))
    with pytest.raises(TypeError, match="perturb"):
        two_cross_dispatch(*_replace(args, perturb=perturb.double()))
    with pytest.raises(TypeError, match="valid"):
        two_cross_dispatch(*_replace(args, valid=valid.to(torch.uint8)))
    with pytest.raises(TypeError, match="unsupported dtype"):
        two_cross_dispatch(*_replace(args, p_verts=p_verts.half()))
    with pytest.raises(ValueError, match="shape"):
        two_cross_dispatch(*_replace(args, shift=shift[:-1]))
    with pytest.raises(ValueError, match="contiguous"):
        two_cross_dispatch(*_replace(
            args, p_verts=p_verts.transpose(0, 1).contiguous().transpose(0, 1)))
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.zeros((8 * 16 * 2 + 2,), dtype=p_verts.dtype, device=dev)
        two_cross_dispatch(*_replace(args, p_verts=odd[2:].view(8, 16, 2)))


@pytest.mark.cuda
def test_cuda_kernel_zeroes_rows_with_an_index_outside_its_pool():
    """Range checks on the host would synchronise; the kernel reads no ring
    for such a row and returns it as zeros, not ok."""
    dev = cuda_or_skip()
    args = [a.to(dev) for a in tt(*build_pair_list(B=32, seed=7, V=16, dtype=np.float64))]
    args[8] = torch.ones_like(args[8])
    args[4], args[5] = args[4].clone(), args[5].clone()
    args[4][3], args[5][5], args[4][8] = 32, -1, 10**12
    got = two_cross_dispatch(*args)
    torch.cuda.synchronize()
    bad = torch.zeros_like(args[8])
    bad[[3, 5, 8]] = True
    for f, x in zip(got._fields, got):
        assert not bool(x[bad].any()), f
    good = args[:4] + [a[~bad] for a in args[4:]]
    ref = two_cross_pairs(*good)
    assert_two_cross_close(type(got)(*(x[~bad] for x in got)), ref, True)


def _slow_rows(dtype, dev, R=512, V=32):
    """A pair list of star rings (V = 32 unless said) on the card and its
    slow selection: the rows that cross but are no clean two-crossing
    contact, the first R of them, and their count (more than R)."""
    args = [a.to(dev) for a in tt(*build_pair_list(B=4096, seed=5, V=V, nmax=V,
                                                    dtype=dtype))]
    tc = two_cross_dispatch(*args)
    slow = (tc.cnt > 0) & ~tc.ok
    return args[:8], first_true(slow, R, args[4].shape[0]), slow.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,V", [(np.float32, 32), (np.float64, 32),
                                     (np.float64, 128)],
                         ids=["f32", "f64", "f64-V128"])
def test_cuda_slow_clip_kernel_matches_shim_and_plain(dtype, V, tmp_path):
    """The slow clip's kernel (clip and retry: one launch) on 512 slow rows
    of a 6 144-row pair list (star rings of 32 vertices at CAP 16 and 32,
    and of 128, the widest the kernel takes, at CAP 48 and 64, the most: in
    f64 the largest scratch a warp has), at n_slow above 512 and cut to 7
    and to 0: equal to the g++ shim to the bit, rows past n_slow zeros, held
    against the plain version on the card by ``regions.held_against_plain``
    (the comparison chip_smoke.py makes; at 128 vertices its limits of the
    summed fields grow with the prefix sums' terms, 257 / 81); two launches
    give the same bits."""
    dev = cuda_or_skip()
    shim = build_regions_shim(tmp_path)
    args, ssel, n_slow = _slow_rows(dtype, dev, V=V)
    assert int(n_slow) > ssel.shape[0]
    for n in (None, 7, 0):
        sel, ns = (ssel, n_slow) if n is None else (
            torch.where(torch.arange(ssel.shape[0], device=dev) < n, ssel,
                        args[4].shape[0]), torch.tensor(n, device=dev))
        for cap in ((16, 32) if V == 32 else (48, regions.MAX_CAP)):
            what = f"n_slow {n} CAP {cap}: "
            before = regions.launch_count()
            got, gbad = regions.intersect_regions_dispatch(*args, sel, ns, cap, 16)
            torch.cuda.synchronize()
            assert regions.launch_count() == before + regions.LAUNCHES_WITH_RETRY == before + 1
            host, hbad = regions.run_host_shim(shim, *(x.cpu() for x in args), sel.cpu(),
                                          ns.cpu(), cap, 16)
            assert torch.equal(gbad.cpu(), hbad), what + "parity_bad"
            for f, x, y in zip(got._fields, got, host):
                assert torch.equal(x.cpu(), y), what + f
            live = int(torch.clamp(ns, max=sel.shape[0]))
            for f, x in zip(got._fields, got):
                assert not bool(x[live:].any()), what + f + " past n_slow"
            regions.held_against_plain(got, gbad, *args, sel, ns, cap, 16)
            again, _ = regions.intersect_regions_dispatch(*args, sel, ns, cap, 16)
            assert all(torch.equal(x, y) for x, y in zip(got, again)), what


@pytest.mark.cuda
def test_cuda_slow_clip_kernel_rejects_what_it_cannot_take():
    dev = cuda_or_skip()
    args, ssel, n_slow = _slow_rows(np.float32, dev, R=64)
    with pytest.raises(ValueError, match="CAP <= 64"):
        regions.intersect_regions_dispatch(*args, ssel, n_slow, 65, 16)
    wide = torch.zeros((4096, 129, 2), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="at most 128 vertices"):
        regions.intersect_regions_dispatch(wide, *args[1:], ssel, n_slow, 16, 16)
    with pytest.raises(TypeError, match="n_slow"):
        regions.intersect_regions_dispatch(*args, ssel, n_slow.int(), 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        regions.intersect_regions_dispatch(*args, ssel, n_slow.cpu(), 16, 16)
    with pytest.raises(TypeError, match="ssel"):
        regions.intersect_regions_dispatch(*args, ssel.int(), n_slow, 16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_cuda_slow_clip_retry_in_one_launch_matches_shim(dtype, tmp_path):
    """The retry inside the clip's launch, on the lattice polygons (more
    than 16 rows come out odd; the retry resolves some): equal to the g++
    shim (which retries the first 16 odd rows after clipping them all) to
    the bit, at n_slow = 64, 7 and 0; only the first 16 odd rows change;
    launched again, and captured in a CUDA graph and replayed three times
    into a buffer filled with garbage before each replay (the launch zeroes
    the ticket in its own buffer), the same bits."""
    dev = cuda_or_skip()
    shim = build_regions_shim(tmp_path)
    cpu, ssel_c, n_c = lattice_pairs(
        dtype=torch.float64 if dtype == np.float64 else torch.float32,
        perturb=(-13.5, -12.5) if dtype == np.float64 else (-8.5, -7.5))
    args = [a.to(dev) for a in cpu]
    ssel = ssel_c.to(dev)
    for n in (64, 7, 0):
        ns = torch.tensor(n, device=dev)
        before = regions.launch_count()
        got, gbad = regions.regions_cuda(*args, ssel, ns, 16, 16)
        first, _ = regions.regions_cuda(*args, ssel, ns, 16, 0)
        torch.cuda.synchronize()
        assert regions.launch_count() == before + 2
        host, hbad = regions.run_host_shim(shim, *cpu, ssel_c, torch.tensor(n), 16, 16)
        assert torch.equal(gbad.cpu(), hbad), n
        for f, x, y in zip(got._fields, got, host):
            assert torch.equal(x.cpu(), y), (n, f)
        changed = torch.stack([(a != b).reshape(a.shape[0], -1).any(1)
                               for a, b in zip(first, got)]).any(0).cpu()
        resolved = (gbad & ~got.overflow).cpu()
        assert torch.equal(changed, resolved), n
        if n == 64:
            odd = gbad.cpu().nonzero().flatten()
            assert odd.numel() > 16 and bool(resolved.any()), odd.numel()
            assert not bool(resolved[odd[16]:].any())  # the first 16 only
        again, _ = regions.regions_cuda(*args, ssel, ns, 16, 16)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), n
    # captured once, replayed three times into the same buffer
    ns = torch.tensor(64, device=dev)
    want, _ = regions.regions_cuda(*args, ssel, ns, 16, 16)
    buf = regions.alloc_output(64, 16, args[0].dtype, dev)
    regions.launch_into(buf, *args, ssel, ns, 16, 16)  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        regions.launch_into(buf, *args, ssel, ns, 16, 16)
    for _ in range(3):
        buf.fill_(0x5A)
        graph.replay()
        torch.cuda.synchronize()
        got, _ = regions.result_of(buf, 64, 16, args[0].dtype)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def _wide_sim(device, dtype=torch.float64):
    """The wide field of tests/test_torch_wide_rings.py, built by the port:
    a pool of 6 rings 40 wide (a comb of 40 vertices and a bar across its
    teeth, 40 crossings; a bar across the teeth of a 40-vertex topography
    comb; a rectangle over the bar's end) on a 2e5 m box (periodic N/S,
    collision E, open W), no coupling, ``clip_cap`` 48."""
    kw = dict(dtype=dtype, device=device)
    grid = make_grid(-1e5, 1e5, -1e5, 1e5, Nx=20, Ny=20)
    coords, topo_coords = wide_field_coords()
    P, C, O = BoundaryKind.PERIODIC, BoundaryKind.COLLISION, BoundaryKind.OPEN
    domain = make_domain(grid, P, P, C, O,
                         topography=make_topography(topo_coords, V=WIDE_V, **kw), **kw)
    fs = FloeSettings(min_floe_area=0.0, subfloe_point_generator=SubGridPointsGenerator(1e9))
    floes = build_floes(coords, 0.25, 0.0, fs, np.random.default_rng(0), N=6,
                        V=WIDE_V, P=WIDE_V, **kw)
    floes = floes._replace(u=torch.tensor(WIDE_U, **kw), v=torch.tensor(WIDE_V_VEL, **kw))
    return Simulation(
        model=make_model(grid, make_ocean(grid, u=0.0, v=0.0, temp=0.0, **kw),
                         make_atmos(grid, u=0.0, v=0.0, temp=-1.0, **kw), domain, floes),
        consts=Constants(), dt=10, n_dt=0, floe_settings=fs,
        coupling_settings=CouplingSettings(coupling_on=False),
        collision_settings=CollisionSettings(), bins=None,
        pair_cap=WIDE_PAIR_CAP, clip_cap=WIDE_CLIP_CAP,
    )


@pytest.mark.cuda
def test_cuda_wide_rings_step_eager_and_replayed_match_cpu():
    """Rings 40 wide and rows of 40 crossings at clip_cap 48 (what the JAX
    package runs and the kernels took only up to 32 before): 10 f64 steps of
    run_scan on the card, replayed from the step's graph and eager, equal
    to the bit, and to the CPU's plain versions within 1e-6 of each field's
    largest magnitude; both kernels launched once a step (B1's wide
    instantiation, B2 at CAP 48), with no overflow."""
    dev = cuda_or_skip()
    n = 10
    for k in (tc_kernel, regions):
        k.reset_launch_count()
    g, _ = run_scan(_wide_sim(dev), n)
    torch.cuda.synchronize()
    st = g.run_stats["graph"]
    assert st["replays"] == n and g.n_overflow == 0
    for name, k in (("two_cross", tc_kernel), ("regions", regions)):
        assert k.launch_count() == n + st["warmup_launches"][name], name
    for k in (tc_kernel, regions):
        k.reset_launch_count()
    e, _ = run_scan(_wide_sim(dev), n, _eager=True)
    torch.cuda.synchronize()
    assert tc_kernel.launch_count() == n and regions.launch_count() == n
    for f, x, y in zip(g.model.floes._fields, g.model.floes, e.model.floes):
        assert torch.equal(x, y), f
    c, _ = run_scan(_wide_sim("cpu"), n)
    for f in ("centroid", "u", "v", "xi", "collision_force", "collision_trq", "overarea"):
        got = getattr(g.model.floes, f).cpu()
        ref = getattr(c.model.floes, f)
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max()), f
    assert float(c.model.floes.overarea[:4].min()) > 0  # every floe in contact


def _small_sim(device, dtype=torch.float64):
    """40 Voronoi floes on a 15 x 15 periodic grid, shear ocean, two-way
    coupling every 10 steps, f64 unless ``dtype`` says otherwise."""
    kw = dict(dtype=dtype, device=device)
    grid = make_grid(0.0, 1.5e5, 0.0, 1.5e5, Nx=15, Ny=15)
    half = (grid.Ny + 1) // 2 + 1
    u = np.concatenate([np.linspace(0, 0.5, half), np.linspace(0.5, 0, grid.Ny + 1 - half)])
    ocean = make_ocean(grid, u=np.broadcast_to(u[None, :], (grid.Nx + 1, grid.Ny + 1)),
                       v=0.0, temp=0.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=-1.0, **kw)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = FloeSettings(min_floe_area=1e6,
                      subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2))
    floes = initialize_floe_field(40, [0.8], domain, 0.25, 0.0, fs,
                                  rng=np.random.default_rng(3), **kw)
    area = floes.area[floes.active].cpu().numpy()
    return Simulation(
        model=make_model(grid, ocean, atmos, domain, floes),
        consts=Constants(E=float(1.5e3 * (np.mean(np.sqrt(area)) + np.min(np.sqrt(area))))),
        dt=20, n_dt=0, floe_settings=fs,
        coupling_settings=CouplingSettings(coupling_on=True, dt=10, two_way_coupling_on=True),
        collision_settings=CollisionSettings(), bins=None,
    )


@pytest.mark.cuda
def test_cuda_run_scan_goes_through_kernel_and_matches_cpu():
    dev = cuda_or_skip()
    n = 10
    tc_kernel.reset_launch_count()
    on_card, _ = run_scan(_small_sim(dev), n)
    torch.cuda.synchronize()
    # one launch a step, replayed by the step's graph, and one in each
    # program's warm-up before its capture
    graph = on_card.run_stats["graph"]
    assert graph["captures"] == 2 and graph["replays"] == n
    assert tc_kernel.launch_count() == n + graph["warmup_launches"]["two_cross"] == n + 2
    on_cpu, _ = run_scan(_small_sim("cpu"), n)
    for f in ("centroid", "u", "v", "xi", "collision_force", "overarea"):
        g = getattr(on_card.model.floes, f).cpu()
        r = getattr(on_cpu.model.floes, f)
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-6 * scale, f
    assert torch.equal(on_card.model.floes.active.cpu(), on_cpu.model.floes.active)


@pytest.mark.cuda
def test_cuda_step_graph_replays_the_eager_step_bitwise():
    """run_scan's graph (the coupling step and the plain step, captured once
    each) against the same steps launched one by one (``_eager``), f32 and
    f64, 21 steps with coupling at steps 10 and 20: equal to the bit; the
    graph's launches are counted at each replay; the caller's state is not
    written."""
    dev = cuda_or_skip()
    for dtype in (torch.float32, torch.float64):
        sim = _small_sim(dev, dtype)
        kept = [x.clone() for x in sim.model.floes]
        tc_kernel.reset_launch_count()
        g, _ = run_scan(dataclasses.replace(sim), 21, start_tstep=1)
        torch.cuda.synchronize()
        st = g.run_stats["graph"]
        assert st["captures"] == 2 and st["recaptures"] == 0 and st["replays"] == 21
        assert tc_kernel.launch_count() == 21 + st["warmup_launches"]["two_cross"]
        e, _ = run_scan(dataclasses.replace(sim), 21, start_tstep=1, _eager=True)
        for name in ("floes", "ocean"):
            for f, x, y in zip(getattr(g.model, name)._fields, getattr(g.model, name),
                               getattr(e.model, name)):
                assert torch.equal(x, y), (dtype, name, f)
        assert all(torch.equal(x, y) for x, y in zip(sim.model.floes, kept))


@pytest.mark.cuda
def test_cuda_failed_capture_raises(tmp_path):
    """A step that reads the device on the host cannot be captured: the
    StepGraph raises, and nothing falls back to eager steps.  (In a process
    of its own: a failed capture leaves its stream unusable.)"""
    cuda_or_skip()
    code = textwrap.dedent("""
        import sys
        import torch
        from subzero_tpu_torch.bench import build_sim
        from subzero_tpu_torch.simulation import run_scan

        sim = build_sim(100, 5e4, 4e3)
        graph = sim.step_graph()
        body = graph.collide

        def reads(floes, ocean, domain):
            int(floes.u.sum())  # a host read: not allowed while capturing
            return body(floes, ocean, domain)

        graph.collide = reads
        try:
            run_scan(sim, 3)
        except RuntimeError as e:
            assert "capturing" in str(e), e
            assert graph.stats["replays"] == 0
            print("raised")
            sys.exit(0)
        sys.exit("no error")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0 and "raised" in out.stdout, out.stdout + out.stderr


@pytest.mark.cuda
def test_cuda_pair_overlaps_matches_cpu():
    """After 10 steps the floes overlap: the overlap query on the card (one
    kernel launch) lists the pairs the CPU's plain versions list, with areas
    within 1e-6 of the largest."""
    dev = cuda_or_skip()
    sim, _ = run_scan(_small_sim("cpu"), 10)
    fl, dom = sim.model.floes, sim.model.domain
    dom_card = dataclasses.replace(
        dom, vals=dom.vals.to(dev), velocities=dom.velocities.to(dev),
        topography=type(dom.topography)(*(x.to(dev) for x in dom.topography)))
    tc_kernel.reset_launch_count()
    got = pair_overlaps(fl.to(dev), dom_card, sim.pair_cap, sim.clip_cap)
    torch.cuda.synchronize()
    assert tc_kernel.launch_count() == 1
    ref = pair_overlaps(fl, dom, sim.pair_cap, sim.clip_cap)
    valid = ref[3]
    assert int(valid.sum()) > 0 and torch.equal(got[3].cpu(), valid)
    assert torch.equal(got[0].cpu()[valid], ref[0][valid])
    assert torch.equal(got[1].cpu()[valid], ref[1][valid])
    err = (got[2].cpu()[valid] - ref[2][valid]).abs().max()
    assert float(err) <= 1e-6 * float(ref[2][valid].max())
    assert not bool(got[4]) and not bool(ref[4])


@pytest.mark.cuda
def test_cuda_run_with_a_fracture_pass():
    """20 steps of ``run`` on the card with a fracture pass (deformation on,
    so it calls pair_interactions) at step 10: floes are created, the pool
    stays on the card in its dtypes and finite, the kernel is launched by
    the steps and by the pass, and the CPU run creates the same floes."""
    dev = cuda_or_skip()
    frac = FractureSettings(fractures_on=True, criteria=HiblerYieldCurve(pstar=50.0),
                            dt=10, npieces=3, deform_on=True)
    out = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        sim = _small_sim(device)
        sim.fracture_settings, sim.n_dt, sim.seed = frac, 19, 4
        sim.name = "test_torch_cuda"
        id0 = int(sim.model.floes.id.max())
        tc_kernel.reset_launch_count()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out[where] = run(sim)
        if where == "card":
            torch.cuda.synchronize()
            st = out[where].run_stats
            assert st["host_pass_count"]["fracture"] == 1
            assert st["host_pass_launches"]["two_cross"]["fracture"] == 1
            assert st["host_pass_launches"]["regions"]["fracture"] == 1
            assert tc_kernel.launch_count() >= st["steps"] + 1
    fc, fh = out["card"].model.floes, out["cpu"].model.floes
    assert all(x.is_cuda for x in fc)
    assert [x.dtype for x in fc] == [x.dtype for x in fh]
    assert int(fc.id.max()) > id0
    assert torch.equal(fc.id.cpu(), fh.id) and torch.equal(fc.nverts.cpu(), fh.nverts)
    assert bool(torch.isfinite(fc.centroid[fc.active]).all())
    assert out["card"].run_stats["rng_state"] == out["cpu"].run_stats["rng_state"]


@pytest.mark.cuda
def test_cuda_decomposition_on_two_gloo_ranks_matches_cpu_ranks(tmp_path):
    """Two gloo rank processes share the card (NCCL refuses two ranks on one
    GPU): 5 f64 steps of the wide configuration of tests/test_parallel.py over
    2 slabs, halos and migrants through host memory; the gathered pool and
    the ocean equal the same 2 ranks on the CPU within 1e-6 of each field's
    largest magnitude, integer fields exactly."""
    cuda_or_skip()
    import os
    import sys

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_decomp_worker.py")
    port = free_port()
    ranks = Ranks(lambda r: [sys.executable, worker, str(r), "2", str(port),
                             str(tmp_path), "card_cpu"], 2, str(tmp_path), timeout=600)
    got = ranks.npz("card_cpu")
    assert ranks.rank_json("card_cpu", 1)["staging_copies"] > 0
    for key in got.files:
        if not key.startswith("card."):
            continue
        card, cpu = got[key], got["cpu." + key[5:]]
        if np.issubdtype(card.dtype, np.floating):
            scale = float(np.abs(cpu).max()) if cpu.size else 0.0
            assert np.abs(card - cpu).max(initial=0.0) <= 1e-6 * scale, key
        else:
            np.testing.assert_array_equal(card, cpu, err_msg=key)


# tests/test_f32_drift.py: percent drift after 5 000 f32 steps
F32_DRIFT_BOUNDS = {"head_on": 0.2, "three_floes": 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", sorted(F32_DRIFT_BOUNDS))
def test_cuda_f32_drift_within_the_jax_bounds(scenario):
    """The JAX package's f32 gate on the card, through the kernel: 5 000 f32
    steps, KE and linear momentum within 0.01%, angular momentum within
    0.2% (head_on) or 1.0% (three_floes)."""
    cuda_or_skip()
    from subzero_tpu_torch.tools.scenarios import conservation_run

    tc_kernel.reset_launch_count()
    drift, sim = conservation_run(torch.float32, scenario, 5000)
    # 5 000 replays of the step's graph, and its warm-up before the capture
    assert sim.run_stats["graph"]["warmup_launches"]["two_cross"] == 1
    assert tc_kernel.launch_count() == 5000 + 1
    assert sim.model.floes.verts.is_cuda
    for k in ("ke", "px", "py"):
        assert abs(drift[k]) < 0.01, drift
    assert abs(drift["l"]) < F32_DRIFT_BOUNDS[scenario], drift


@pytest.mark.cuda
def test_cuda_layer_marks_in_the_graph():
    """The step's layer marks on the card (``tracing``), on the 500-floe
    shear field: a graph replay's counters equal those of the same steps
    launched one by one (``_eager``, the same mark kernels) in steps,
    candidate pairs and slow rows; in a profiled replay every mark kernel
    (``subzero_mark<k>``) runs once a step, and each layer's seconds by the
    marks' clock are within 25% of the time between the marks' own events
    in the trace.  (An eager step's layer seconds are the host's launch
    time, not the device's, so they are not held to the graph's.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from subzero_tpu_torch import tracing
    from subzero_tpu_torch.bench import build_sim
    from subzero_tpu_torch.step_graph import StepGraph

    dev = cuda_or_skip()
    sim = build_sim(500, 1e5, 2e3, device=dev)
    n, lead = 20, 3

    def stepped(eager):
        g = StepGraph(sim, _eager=eager)
        g.prepare({g.step_prog(t) for t in range(1, n + 1)})
        g.marks.begin_call()
        for t in range(1, n + 1):
            g.step(t)
        g.marks.read()
        return g

    eager, graph = stepped(True), stepped(False)
    for k in ("steps_marked", "pairs", "slow_rows", "pairs_max", "slow_rows_max"):
        assert graph.stats[k] == eager.stats[k], k
    assert graph.stats["steps_marked"] == n and graph.stats["pairs"] > 0

    # one profiler session, the only one this graph meets; the lead takes
    # the launches a trace may drop at its start
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(n + 1, n + 1 + lead):
            graph.step(t)
        graph.marks.read()
        before = graph.snapshot()
        for t in range(n + 1 + lead, 2 * n + 1 + lead):
            graph.step(t)
        graph.marks.read()
    marked = graph.stats_since(before)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    starts = {k: sorted(e.start_ns() for e in ev if f"subzero_mark<{k}>" in e.name())
              for k in range(len(tracing.LAYERS))}
    counts = {k: len(v) for k, v in starts.items()}
    assert len(set(counts.values())) == 1 and counts[0] >= n, counts
    last = {k: v[-n:] for k, v in starts.items()}
    for k, layer in enumerate(tracing.LAYERS[1:], 1):
        traced = 1e-9 * sum(b - a for a, b in zip(last[k - 1], last[k]))
        assert marked["layer_s"][layer] == pytest.approx(traced, rel=0.25), (
            layer, marked["layer_s"], traced)


@pytest.mark.cuda
def test_cuda_bin_counters_equal_the_cpus():
    """The binned broad phase's counters (``collisions._bin_counts``, read
    by mark 1 inside the graph) on the card equal the CPU's on the same
    field and state: the 300-floe shear field with explicit bins, f64, one
    ``run_scan`` call of three steps from the same initial state."""
    from subzero_tpu_torch.bench import build_sim

    dev = cuda_or_skip()
    stats = {}
    for d in ("cpu", dev):
        sim = build_sim(300, 1e5, 4e3, device=d, dtype=torch.float64, bins=True)
        run_scan(sim, 3, start_tstep=1)
        stats[d] = sim.run_stats["graph"]
    for k in ("steps_marked", "pairs", "bin_tests", "bin_fill", "bin_tests_max",
              "bin_fill_max", "bin_cap"):
        assert stats[dev][k] == stats["cpu"][k], k
    assert stats["cpu"]["bin_tests"] > 0 and stats["cpu"]["bin_cap"] > 0


# ---------------------------------------------------------------------------
# the force law's kernel (B4)
# ---------------------------------------------------------------------------

def _bits(x):
    """A tensor's bits: floats as the integers of their width."""
    x = x.contiguous()
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _force_fields(dev):
    """The f32 fields the force law is held on, after 20 steps on the card:
    the 500-floe shear field (bench.build_sim) and simple_strait (collision
    walls east and west, three topography polygons)."""
    from subzero_tpu_torch.bench import build_sim
    from subzero_tpu_torch.examples import simple_strait

    shear, _ = run_scan(build_sim(500, 1e5, 2e3, device=dev), 20)
    strait, _ = run_scan(simple_strait.build(n_dt=0, device=dev), 20)
    return {"shear_flow_500": shear, "simple_strait": strait}


def _law_inputs(sim):
    m = sim.model
    nb = tcol.narrow_phase_batch(m.floes, m.domain, sim.pair_cap, sim.bins)
    tc = two_cross_dispatch(*nb.two_cross_args())
    slow = tcol._slow_path(nb, tc, sim.pair_cap, sim.clip_cap, retry=True)
    return m, nb, tc, slow


@pytest.mark.cuda
def test_cuda_force_law_kernel_equals_plain_bitwise():
    """B4 against the plain force law on the card, f32, with the step's
    marking and without it (pair_interactions'): every force, force point,
    overlap record, mark and slow side equal to the bit; one launch a call.
    The walled field has floe-wall and floe-topography rows with force."""
    dev = cuda_or_skip()
    for name, sim in _force_fields(dev).items():
        m, nb, tc, slow = _law_inputs(sim)
        for marking in (True, False):
            cs = sim.collision_settings if marking else None
            before = forces.launch_count()
            got = tcol._force_law(sim.consts, sim.dt, cs, m.domain.vals, m.floes, nb,
                                  tc, slow, marking)
            torch.cuda.synchronize()
            assert forces.launch_count() == before + 1
            ref = tcol._force_law_plain(sim.consts, sim.dt, cs, m.domain.vals, m.floes,
                                        nb, tc, slow, marking)
            for f in forces.ForceLaw._fields:
                a, b = getattr(got, f), getattr(ref, f)
                if f == "s_sides":
                    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b)), name
                elif a is None:
                    assert b is None and not marking, (name, f)
                else:
                    assert torch.equal(_bits(a), _bits(b)), (name, marking, f)
        N, j = m.floes.capacity, nb.pairs.qj
        has_force = got.f_force[:, 0].abs().sum(-1) > 0
        assert bool(has_force.any()), name
        if name == "simple_strait":
            assert bool((has_force & (j >= N)).any()), "no domain row with force"


@pytest.mark.cuda
def test_cuda_step_and_interactions_with_the_kernel_equal_plain(monkeypatch):
    """timestep_collisions and pair_interactions on the card with B4 and
    with the plain force law in its place: every output equal to the bit."""
    dev = cuda_or_skip()
    for name, sim in _force_fields(dev).items():
        m = sim.model

        def both():
            res = tcol.timestep_collisions(m.floes, m.domain, sim.consts, sim.dt,
                                           sim.collision_settings, sim.pair_cap,
                                           sim.clip_cap, sim.bins)
            rows = tcol.pair_interactions(m.floes, m.domain, sim.consts, sim.dt,
                                          sim.pair_cap, sim.clip_cap, sim.bins)
            return res, rows

        got_res, got_rows = both()
        with monkeypatch.context() as mp:
            mp.setattr(tcol, "_force_law", tcol._force_law_plain)
            ref_res, ref_rows = both()
        for f, x, y in zip(ref_res.floes._fields, got_res.floes, ref_res.floes):
            assert torch.equal(_bits(x), _bits(y)), (name, f)
        assert torch.equal(_bits(got_res.stress_instant), _bits(ref_res.stress_instant))
        for k in ref_rows:
            assert torch.equal(_bits(got_rows[k]), _bits(ref_rows[k])), (name, k)


@pytest.mark.cuda
def test_cuda_force_law_in_the_graph_and_across_a_restart():
    """On the 500-floe shear field, f32: run_scan's graph replays equal the
    eager steps to the bit; the force law is one B4 launch a step (at most
    three), read by the launch counter, in every captured program; and a run
    stopped after 10 steps and continued from its state for 10 more ends
    where 20 steps at once do, to the bit (no float atomics)."""
    from subzero_tpu_torch.bench import build_sim

    dev = cuda_or_skip()
    sim = build_sim(500, 1e5, 2e3, device=dev)
    n = 20
    forces.reset_launch_count()
    g, _ = run_scan(dataclasses.replace(sim), n, start_tstep=1)
    torch.cuda.synchronize()
    st = g.run_stats["graph"]
    assert forces.launch_count() == n + st["warmup_launches"]["forces"]
    per_prog = g._graph.captured_launches("forces")
    assert per_prog and all(1 <= k <= 3 for k in per_prog.values()), per_prog
    e, _ = run_scan(dataclasses.replace(sim), n, start_tstep=1, _eager=True)
    for f, x, y in zip(g.model.floes._fields, g.model.floes, e.model.floes):
        assert torch.equal(x, y), f
    half, _ = run_scan(dataclasses.replace(sim), n // 2, start_tstep=1)
    rest, _ = run_scan(dataclasses.replace(sim, model=half.model), n // 2,
                       start_tstep=1 + n // 2)
    for name in ("floes", "ocean"):
        for f, x, y in zip(getattr(g.model, name)._fields, getattr(rest.model, name),
                           getattr(g.model, name)):
            assert torch.equal(x, y), (name, f)


# ---------------------------------------------------------------------------
# the coupling's cell clip (B6)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_card_sum_is_torchs_sum_on_the_card(dtype):
    """``card_sum``, the grouping that B6's ring sum follows and that the
    CPU tests hold its shim to, is ``torch.sum(x, dim=1)`` on the card at
    the shapes the coupling's plain clip sums ([N, V, cap^2]) and others."""
    dev = cuda_or_skip()
    gen = torch.Generator().manual_seed(3)
    for shape in ((500, 32, 361), (2000, 32, 441), (64, 40, 441), (16, 128, 25),
                  (3, 7, 9), (5, 32, 256)):
        x = (1e3 * torch.randn(shape, generator=gen, dtype=dtype)).to(dev)
        assert torch.equal(torch.sum(x, dim=1), card_sum(x)), shape


# field: (floes, box side, binned broad phase, cell_cap as the benchmark's)
B6_FIELDS = {"shear_flow_500": (500, 1e5, False, 19),
             "field_16k": (16000, 5.66e5, True, 21)}


@pytest.mark.cuda
@pytest.mark.parametrize("field", sorted(B6_FIELDS))
def test_cuda_cell_clip_equals_plain_bitwise(field, monkeypatch):
    """B6 against the plain version on the card (``_cell_areas_plain``) on
    the field's coupling windows, f32 (and f64 at 500 floes): every area
    equal to the bit, one launch a call, and its count of the cells it
    clipped equal to the window mask's; the whole coupling with B6 and with
    the plain version in its place: every floe and ocean field to the bit."""
    from subzero_tpu_torch.bench import build_sim

    dev = cuda_or_skip()
    n, L, bins, cap = B6_FIELDS[field]
    for dtype in (torch.float32, torch.float64) if n == 500 else (torch.float32,):
        sim = dataclasses.replace(build_sim(n, L, 2e3, device=dev, dtype=dtype, bins=bins),
                                  cell_cap=cap)
        args = coupling_cell_inputs(sim)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        before = cell_clip.launch_count()
        got = tcpl._cell_areas(*args, count)
        torch.cuda.synchronize()
        assert cell_clip.launch_count() == before + 1
        ref = tcpl._cell_areas_plain(*args)
        assert torch.equal(_bits(got), _bits(ref)), (field, dtype)
        ok = args[6][:, :, None] & args[7][:, None, :]
        assert int(count) == int(ok.sum()) > 0
        assert bool((got > 0).any())
        del ref
        m = sim.model

        def couple():
            return tcpl.timestep_coupling(m.floes, m.grid, m.domain, m.ocean, m.atmos,
                                          sim.consts, sim.coupling_settings,
                                          sim.floe_settings, sim.dt, sim.cell_cap)

        f1, o1, ov1 = couple()
        with monkeypatch.context() as mp:
            mp.setattr(tcpl, "_cell_areas", tcpl._cell_areas_plain)
            f2, o2, ov2 = couple()
        for name, a, b in ((f"floes.{k}", x, y) for k, x, y in zip(f1._fields, f1, f2)):
            assert torch.equal(_bits(a), _bits(b)), (field, dtype, name)
        for k, x, y in zip(o1._fields, o1, o2):
            assert torch.equal(_bits(x), _bits(y)), (field, dtype, k)
        assert bool(ov1) == bool(ov2)


@pytest.mark.cuda
def test_cuda_cell_clip_in_the_graph():
    """On the 500-floe shear field, f32: the coupled step's program holds
    one B6 launch and the uncoupled one none, by the graphs' captured counts
    and by the card's own runs of the kernel in a profiled replay of each;
    the launch counter reads one a coupled step; the marks' ``window_cells``
    of a coupled step equals the window mask's count on its state and an
    uncoupled step adds none; and run_scan's replays equal the eager loop
    to the bit over 20 steps with two coupled ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from subzero_tpu_torch.bench import build_sim

    dev = cuda_or_skip()
    sim = build_sim(500, 1e5, 2e3, device=dev)
    n = 20
    cell_clip.reset_launch_count()
    g, _ = run_scan(dataclasses.replace(sim), n, start_tstep=1)
    torch.cuda.synchronize()
    st = g.run_stats["graph"]
    assert cell_clip.launch_count() == 2 + st["warmup_launches"]["cell_clip"]
    graph = g._graph
    assert graph.captured_launches("cell_clip") == {("step", True): 1, ("step", False): 0}
    for prog, want in ((("step", True), 1), (("step", False), 0)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):  # the lead takes the launches a trace may drop
                graph.replay(prog)
            torch.cuda.synchronize()
        runs = [e for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and "cell_clip_kernel" in e.name()]
        assert len(runs) in (3 * want, 2 * want), (prog, len(runs))
    e, _ = run_scan(dataclasses.replace(sim), n, start_tstep=1, _eager=True)
    for name in ("floes", "ocean"):
        for f, x, y in zip(getattr(g.model, name)._fields, getattr(g.model, name),
                           getattr(e.model, name)):
            assert torch.equal(x, y), (name, f)
    okx, oky = coupling_cell_inputs(sim)[6:]
    want = int((okx[:, :, None] & oky[:, None, :]).sum())
    one, _ = run_scan(dataclasses.replace(sim), 1, start_tstep=10)
    assert one.run_stats["graph"]["window_cells"] == want > 0
    two, _ = run_scan(one, 1, start_tstep=11)
    assert two.run_stats["graph"]["window_cells"] == 0


@pytest.mark.cuda
def test_cuda_grid_writer_takes_the_cell_clip(monkeypatch):
    """The grid writer's [N, nx, ny] clip (``writers.eulerian_data``, f64
    whatever the pool's dtype) is one B6 launch on the card, and every grid
    output equals the one the plain clip gives on the card to the bit."""
    from subzero_tpu_torch.bench import build_sim
    from subzero_tpu_torch.io.writers import eulerian_data

    dev = cuda_or_skip()
    m = build_sim(500, 1e5, 2e3, device=dev).model
    dims = (10, 12)
    before = cell_clip.launch_count()
    got = eulerian_data(m.floes, m.ocean, m.grid, dims)
    assert cell_clip.launch_count() == before + 1
    with monkeypatch.context() as mp:
        mp.setattr(tcpl, "_cell_areas", tcpl._cell_areas_plain)
        ref = eulerian_data(m.floes, m.ocean, m.grid, dims)
    assert cell_clip.launch_count() == before + 1
    assert sorted(got) == sorted(ref) and float(got["area_grid"].sum()) > 0
    for k in ref:
        assert np.array_equal(got[k], ref[k], equal_nan=True), k
