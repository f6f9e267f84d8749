"""The port on the card: the narrow-phase CUDA kernel against its plain
PyTorch version, the wrapper's checks, a short run_scan that goes through
the kernel and agrees with the CPU run, the step's CUDA graph against the
eager step (bitwise) and a capture that fails (it raises), ``pair_overlaps``
on the card against the CPU, a 20-step ``run`` with a fracture pass, and the
JAX package's f32 conservation gate (5 000 steps of head_on and
three_floes).

Every test is marked ``cuda`` and skips without an NVIDIA GPU.  The file
imports no JAX, so it runs on a machine that has none, without the JAX-side
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 those of tests/test_pallas_clip.py, f64 rtol 1e-9 (kernel
vs plain); 1e-6 of each field's largest magnitude for 10 f64 steps on the
card vs the CPU (summation order only, amplified by contact dynamics).
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
from subzero_tpu_torch.geometry import two_cross as tc_kernel
from subzero_tpu_torch.geometry.clip import (
    TWO_CROSS_ARGS,
    two_cross_dispatch,
    two_cross_pairs,
)
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
    Ranks,
    assert_two_cross_close,
    build_pair_list,
    cuda_or_skip,
    free_port,
    tt,
)

CASES = [(np.float32, 16), (np.float64, 16), (np.float32, 32), (np.float64, 32)]
IDS = ["f32-V16", "f64-V16", "f32-V32", "f64-V32"]


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
    wide = torch.zeros((8, 33, 2), dtype=p_verts.dtype, device=dev)
    with pytest.raises(ValueError, match="ring width"):
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
    assert tc_kernel.launch_count() == n + graph["warmup_launches"] == n + 2
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
        assert tc_kernel.launch_count() == 21 + st["warmup_launches"]
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
            assert st["host_pass_launches"]["fracture"] == 1
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
    assert sim.run_stats["graph"]["warmup_launches"] == 1
    assert tc_kernel.launch_count() == 5000 + 1
    assert sim.model.floes.verts.is_cuda
    for k in ("ke", "px", "py"):
        assert abs(drift[k]) < 0.01, drift
    assert abs(drift["l"]) < F32_DRIFT_BOUNDS[scenario], drift
