#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``subzero_tpu_torch``) on one NVIDIA GPU.

Builds the narrow-phase CUDA kernel from ``subzero_tpu_torch/csrc``, holds it
against its plain PyTorch version, and drives the port's device step
(collide, couple, integrate, remove) through ``simulation.run_scan`` on the
shear_flow_500 and many_floes_2000 configurations of ``bench.py``, built with
the port's own host setup from seed 1.  Imports no JAX.

Phases (one JSON line each; any failure raises and the exit code is not 0):

  device    torch / CUDA versions, the card, its power limit
  build     nvcc build of the kernel library, seconds
  kernel    kernel vs its plain version (clip.two_cross_pairs), both fed ring
            pools and a pair list: random star rings (V = 16 and 32, f32 and
            f64, 6144 rows over pools of 4096, rings shared between rows,
            some rows shifted, every 7th invalid) and the pair list
            timestep_collisions feeds the narrow phase on shear_flow_500
            after 20 steps (f32 and f64); then the kernel's times at the
            main path's batch: device_ms (its own device time, from
            torch.profiler), queued_ms (launches enqueued back to back
            between two events) with an empty kernel's beside them as the
            floor, call_ms (the whole Python call), plain_ms, and bound_ms
            from the batch's own bytes and operations
  slice     shear_flow_500, f32, 400 steps of run_scan on the card
  card_cpu  shear_flow_500, f64, 20 steps on the card (kernel) and on the
            CPU (plain versions): centroids, velocities, ocean stresses
  determinism  two 50-step runs on the card are bitwise equal
  many_floes_2000  50 steps of bench.build_sim(2000, 2e5, 2e3)'s counterpart,
            and the kernel's check and times at its batch (17 000 rows)
  profile   (only when named) where a shear_flow_500 step's time goes:
            step_ms with coupling or collisions off, as bench.py splits it,
            and torch.profiler's device time by operator over 20 steps

Then a {"kernels": [...]} line, the nvidia-smi name/power-limit line, and
last {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --parent _parent     # also time an older kernel

``--parent DIR`` names a checkout of an earlier commit of this repository
whose kernel took materialised ring batches (two_cross_cuda(pv, pn, qv, qn,
perturb)): a subprocess builds that kernel from DIR and times it on the same
batches with the same functions, so both kernels are measured on one card in
one run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PHASES = ("build", "kernel", "slice", "card_cpu", "determinism",
          "many_floes_2000")
EXTRA_PHASES = ("profile",)
SEED = 1

# kernel vs plain, f32: the tolerances of tests/test_pallas_clip.py (cnt and
# ok exact, geometry compared where the pair is ok); f64: rtol 1e-9
F32_TOL = {"contain": (1e-5, 1e-6), "area": (1e-4, 1e-6), "geometry": (1e-4, 1e-5)}
F64_TOL = {k: (1e-9, 1e-12) for k in F32_TOL}
# card vs CPU after 20 f64 steps: every compared field within this fraction
# of its largest magnitude.  The two differ in summation order only, but an
# overlap area is a shoelace sum over coordinates ~1e5 m, so a small
# contact's area (and force) moves by ~1e-9 relative, and contact dynamics
# amplify that about tenfold every 15 steps (tests/test_torch_slice.py)
CARD_CPU_TOL = 1e-6


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

def build_sim(n_floes, L, dx, *, device, dtype, seed=SEED, coupling=True,
              collisions=True):
    """The port's counterpart of ``bench.build_sim(n_floes, L, dx)``:
    periodic box, shear ocean, Voronoi floes at concentration 0.8 and mean
    height 0.25, E from the floe areas, dt 20, two-way coupling on, dense
    broad phase."""
    from subzero_tpu_torch.constants import Constants
    from subzero_tpu_torch.core import (BoundaryKind, initialize_floe_field,
                                        make_atmos, make_domain, make_grid,
                                        make_model, make_ocean)
    from subzero_tpu_torch.settings import (CollisionSettings,
                                            CouplingSettings, FloeSettings,
                                            SubGridPointsGenerator)
    from subzero_tpu_torch.simulation import Simulation

    kw = dict(dtype=dtype, device=device)
    grid = make_grid(0.0, L, 0.0, L, dx=dx, dy=dx)
    ny = grid.Ny + 1
    half = ny // 2 + 1
    uvels = np.concatenate([np.linspace(0, 0.5, half), np.linspace(0.5, 0, ny - half)])
    u_field = np.broadcast_to(uvels[None, :], (grid.Nx + 1, ny))
    ocean = make_ocean(grid, u=u_field, v=0.0, temp=0.0, **kw)
    atmos = make_atmos(grid, u=0.0, v=0.0, temp=-1.0, **kw)
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = FloeSettings(
        min_floe_area=1e6,
        subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2),
    )
    floes = initialize_floe_field(n_floes, [0.8], domain, 0.25, 0.0, fs,
                                  rng=np.random.default_rng(seed), **kw)
    area = floes.area[floes.active].cpu().numpy()
    modulus = 1.5e3 * (np.mean(np.sqrt(area)) + np.min(np.sqrt(area)))
    return Simulation(
        model=make_model(grid, ocean, atmos, domain, floes),
        consts=Constants(E=float(modulus)),
        dt=20,
        n_dt=0,
        floe_settings=fs,
        coupling_settings=CouplingSettings(coupling_on=coupling,
                                           two_way_coupling_on=True),
        collision_settings=CollisionSettings(collisions_on=collisions),
        bins=None,
    )


def fork(sim):
    """A second Simulation on the same (immutable) model state."""
    return dataclasses.replace(sim)


def build_pair_list(B, V, nmax, dtype, seed):
    """Ring pools and a pair list of 3B/2 rows (clip.TWO_CROSS_ARGS, numpy).
    The pools are random star rings as tests/test_pallas_clip.py:build_batch
    makes them (widened to ring width V and up to nmax vertices): Q ring k
    overlaps P ring k, is disjoint from it, lies inside it or holds it, in
    turn.  Rows 0..B-1 pair ring k with ring k unshifted; the rest pair
    random rings (rings are shared between rows) with Q shifted by up to a
    ring radius; every 7th row is invalid; the rows are shuffled."""
    rng = np.random.default_rng(seed)

    def star(nv, cx, cy, r0):
        th = np.sort(rng.random(nv)) * 2 * np.pi
        r = r0 * (0.5 + rng.random(nv))
        return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)

    pv = np.zeros((B, V, 2))
    qv = np.zeros((B, V, 2))
    pn = np.zeros((B,), np.int32)
    qn = np.zeros((B,), np.int32)
    for k in range(B):
        nv = int(rng.integers(3, nmax + 1))
        ring = star(nv, 0.0, 0.0, 1.0)
        pv[k, :nv], pv[k, nv:], pn[k] = ring, ring[-1], nv
        nw = int(rng.integers(3, nmax + 1))
        dx, dy, s = {0: (*rng.uniform(-1, 1, 2), 1.0), 1: (5.0 + rng.random(), 5.0, 1.0),
                     2: (0.0, 0.0, 0.15), 3: (0.0, 0.0, 8.0)}[k % 4]
        ring = star(nw, dx, dy, s)
        qv[k, :nw], qv[k, nw:], qn[k] = ring, ring[-1], nw
    E = B // 2
    qi = np.concatenate([np.arange(B), rng.integers(0, B, E)]).astype(np.int64)
    qj = np.concatenate([np.arange(B), rng.integers(0, B, E)]).astype(np.int64)
    shift = np.concatenate([np.zeros((B, 2)), rng.uniform(-1, 1, (E, 2))])
    order = rng.permutation(B + E)
    valid = (np.arange(B + E) % 7) != 3
    pert = 1e-6 * (1 + rng.random(B + E))
    return (pv.astype(dtype), pn, qv.astype(dtype), qn, qi[order], qj[order],
            shift[order].astype(dtype), pert.astype(dtype), valid)


def to_device(args, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args)


# ---------------------------------------------------------------------------
# checks and timing
# ---------------------------------------------------------------------------

def compare_two_cross(got, ref, f64: bool, valid=None) -> float:
    """Kernel result vs plain result; raises on a disagreement, returns the
    largest absolute difference over the compared values.  With ``valid``,
    every field of every invalid row must be exactly zero in both."""
    tol = F64_TOL if f64 else F32_TOL
    if valid is not None:
        for res, who in ((got, "kernel"), (ref, "plain")):
            for f, x in zip(res._fields, res):
                if bool(x[~valid].any()):
                    raise AssertionError(f"two_cross {f}: {who} left an invalid row nonzero")
    for f in ("cnt", "ok"):
        bad = int((getattr(got, f) != getattr(ref, f)).sum())
        if bad:
            raise AssertionError(f"two_cross {f}: {bad} pairs differ")
    ok = ref.ok
    worst = 0.0
    for f, kind in (("contain", "contain"), ("area", "area"), ("centroid", "geometry"),
                    ("chord_a", "geometry"), ("chord_b", "geometry"),
                    ("p_norm", "geometry")):
        g, r = getattr(got, f), getattr(ref, f)
        if kind == "geometry":
            g, r = g[ok], r[ok]
        if g.numel() == 0:
            continue
        rtol, atol = tol[kind]
        err = (g - r).abs()
        bad = ~(err <= atol + rtol * r.abs())
        if bool(bad.any()):
            raise AssertionError(
                f"two_cross {f}: {int(bad.sum())} values beyond rtol {rtol} "
                f"atol {atol}; max abs err {float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def median_ms(fn, reps=30, warmup=5) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dev_us(e) -> float:
    """A profiler event's own device time, microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def queued_ms(launch, n=50, reps=7) -> float:
    """ms per launch when n launches are enqueued back to back between two
    events (median of reps): the larger of the kernel's time and the host's
    cost of enqueueing one launch."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def profiled_kernel_ms(launch, kernel_name, n=20, tries=3) -> float:
    """The kernel's own device time, host taken out: torch.profiler over n
    launches, mean device time of the kernels whose name holds
    ``kernel_name``.  A trace now and then comes back without its device
    events (or drops one at its edge): such a trace is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                launch()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel_name in e.key]
        seen = sum(e.count for e in evs)
        if seen >= n // 2:
            return sum(dev_us(e) for e in evs) / 1e3 / seen
    raise AssertionError(
        f"profiler saw {seen} launches of {kernel_name} in its last of "
        f"{tries} traces, expected {n}")


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s;
# 67 TFLOP/s in f32 outside the tensor cores counts an FMA as two operations,
# and the kernel is built without FMA contraction, so its peak is half that.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12 / 2
OPS_PER_EDGE_PAIR = 30  # one crossing test (two_cross.cuh:edge_crossing)
OPS_PER_VERTEX = 3      # one shoelace term


def two_cross_bound(inputs, n_rows, pn, qn, live=None) -> dict:
    """The least time the card could take for one narrow-phase call: the
    larger of its bytes (every input tensor read once, 10 floats + cnt + ok
    written per row) over the memory rate and its operations (crossing tests
    over the live rows' own pn x qn edge pairs, shoelace terms over their
    vertices) over the f32 rate."""
    elt = inputs[0].element_size()
    nbytes = sum(x.numel() * x.element_size() for x in inputs) + n_rows * (10 * elt + 5)
    pn, qn = pn.long(), qn.long()
    if live is not None:
        pn, qn = pn[live], qn[live]
    edge_pairs = int((pn * qn).sum())
    ops = OPS_PER_EDGE_PAIR * edge_pairs + OPS_PER_VERTEX * int((pn + qn).sum())
    by_bytes = 1e3 * nbytes / H100_BYTES_PER_S
    by_ops = 1e3 * ops / H100_F32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "bytes_ms": by_bytes, "edge_pairs": edge_pairs,
            "operations": ops, "operations_ms": by_ops}


def time_kernel(nb) -> dict:
    """The kernel's times on one narrow-phase pair list (f32), its plain
    version's, an empty launch's and the bound from this list's sizes."""
    from subzero_tpu_torch.geometry import two_cross
    from subzero_tpu_torch.geometry.clip import two_cross_pairs

    args = nb.two_cross_args()
    PC = int(nb.pairs.qi.shape[0])
    buf = two_cross.alloc_output(PC, nb.p_verts.dtype, nb.p_verts.device)

    def launch():
        two_cross.launch_into(buf, *args)

    # what the time is made of: the first 128 rows alone (32 blocks, a warp
    # or two on an SM: one pair's dependent chain, nothing to hide it), and
    # the whole list with no row valid (launch, the rows' own loads, stores)
    head = args[:4] + tuple(x[:128].contiguous() for x in args[4:])
    none_valid = args[:8] + (torch.zeros_like(args[8]),)

    return {
        "B": PC,
        "device_ms_first_128_rows": profiled_kernel_ms(
            lambda: two_cross.launch_into(buf, *head), "two_cross_kernel"),
        "device_ms_no_row_valid": profiled_kernel_ms(
            lambda: two_cross.launch_into(buf, *none_valid), "two_cross_kernel"),
        "valid_rows": int(nb.pairs.valid.sum()),
        "plain_ms": median_ms(lambda: two_cross_pairs(*args)),
        "device_ms": profiled_kernel_ms(launch, "two_cross_kernel"),
        "queued_ms": queued_ms(launch),
        # the floor under any launch: an empty kernel timed the same two ways
        "empty_device_ms": profiled_kernel_ms(two_cross.empty_launch, "empty_kernel"),
        "empty_queued_ms": queued_ms(two_cross.empty_launch),
        "call_ms": median_ms(lambda: two_cross.two_cross_cuda(*args)),
        **two_cross_bound(args, PC, nb.p_n[nb.pairs.qi], nb.q_n[nb.pairs.qj],
                          live=nb.pairs.valid),
    }


# ---------------------------------------------------------------------------
# an earlier commit's kernel on the same batches (--parent)
# ---------------------------------------------------------------------------

def parent_worker(path: str) -> int:
    """Runs with an earlier checkout as the working directory: builds that
    checkout's kernel (materialised ring batches, one thread per pair, eight
    outputs) and times it on the batches saved at ``path`` with this file's
    timing functions.  Prints one JSON object."""
    sys.path.insert(0, os.getcwd())
    from subzero_tpu_torch.geometry import two_cross as tc
    from subzero_tpu_torch.geometry.clip import sliver_tol

    info = tc.build(force=True)
    lib = tc._load()
    out = {"ptxas": [ln.strip() for ln in info["log"].splitlines()
                     if "registers" in ln or "spill" in ln]}
    if hasattr(lib, "sz_empty_launch"):
        raise RuntimeError("--parent wants a checkout from before the kernel took pools")
    for name, batch in torch.load(path).items():
        pv, pn, qv, qn, pert = (x.cuda() for x in batch)
        res = tc.two_cross_cuda(pv, pn, qv, qn, pert)  # outputs allocated once
        outs = [getattr(res, f).data_ptr() for f in
                ("cnt", "ok", "contain", "area", "centroid", "chord_a",
                 "chord_b", "p_norm")]
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            rc = lib.sz_two_cross_f32(
                pv.data_ptr(), pn.data_ptr(), qv.data_ptr(), qn.data_ptr(),
                pert.data_ptr(), pv.shape[0], pv.shape[1], qv.shape[1],
                sliver_tol(pv.dtype), *outs, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed ({rc})")

        out[name] = {
            "B": int(pv.shape[0]),
            "device_ms": profiled_kernel_ms(launch, "two_cross_kernel"),
            "queued_ms": queued_ms(launch),
            "call_ms": median_ms(lambda: tc.two_cross_cuda(pv, pn, qv, qn, pert)),
            **two_cross_bound((pv, pn, qv, qn, pert), pv.shape[0], pn, qn),
        }
    print(json.dumps(out), flush=True)
    return 0


def time_parent_kernel(parent_dir: str, batches: dict) -> dict:
    """Times the kernel of the checkout at ``parent_dir`` on ``batches``
    (name -> materialised (pv, pn, qv, qn, perturb)) in a subprocess."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "batches.pt")
        torch.save({k: tuple(x.cpu() for x in v) for k, v in batches.items()}, path)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent-worker", path],
            cwd=parent_dir, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"timing the kernel of {parent_dir} failed:\n"
                           + proc.stdout + proc.stderr)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def check_finite(sim) -> None:
    for name, tree in (("floes", sim.model.floes), ("ocean", sim.model.ocean)):
        for f, x in zip(tree._fields, tree):
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{name}.{f} is not finite")


def run_timed(sim, n_steps):
    """run_scan of n_steps on the card, launch counts reset just before;
    returns the advanced sim and its numbers."""
    from subzero_tpu_torch.geometry import two_cross
    from subzero_tpu_torch.physics.collisions import find_candidate_pairs
    from subzero_tpu_torch.simulation import run_scan

    fl = sim.model.floes
    n_active = int(fl.count())
    pairs_per_step = int(find_candidate_pairs(fl, sim.model.domain,
                                              sim.pair_cap).valid.sum())
    torch.cuda.synchronize()
    two_cross.reset_launch_count()
    t0 = time.perf_counter()
    sim, _ = run_scan(sim, n_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = two_cross.launch_count()
    check_finite(sim)
    n_after = int(sim.model.floes.count())
    if launches < n_steps:
        raise AssertionError(f"kernel launched {launches} times in {n_steps} steps")
    if n_after != n_active:
        raise AssertionError(f"active floes {n_active} -> {n_after}")
    return sim, {
        "n_steps": n_steps,
        "seconds": seconds,
        "steps_per_s": n_steps / seconds,
        "step_ms": 1e3 * seconds / n_steps,
        "pairs_per_step": pairs_per_step,
        "pairs_per_s": pairs_per_step * n_steps / seconds,
        "active_floes": n_after,
        "n_overflow": sim.n_overflow,
        "kernel_launches": launches,
    }


def max_rel_diff(a, b) -> float:
    a = a.detach().cpu().double()
    b = b.detach().cpu().double()
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / scale if scale > 0 else float((a - b).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def bitwise_report(got, ref) -> dict:
    """Per field: whether kernel and plain agree to the bit and, where they
    do not, the largest absolute difference."""
    return {f: (True if torch.equal(g, r) else float((g - r).abs().max()))
            for f, g, r in zip(ref._fields, got, ref)}


def check_main_path_batch(nb, report_key, report) -> dict:
    """Kernel vs plain on a NarrowBatch of the main path, f32 as fed and
    cast to f64; keeps the materialised rings for --parent."""
    from subzero_tpu_torch.geometry.clip import two_cross_pairs
    from subzero_tpu_torch.geometry.two_cross import two_cross_cuda
    from subzero_tpu_torch.physics.collisions import ring_batch

    args = nb.two_cross_args()
    valid = nb.pairs.valid
    got, ref = two_cross_cuda(*args), two_cross_pairs(*args)
    err32 = compare_two_cross(got, ref, False, valid)
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    err64 = compare_two_cross(two_cross_cuda(*a64), two_cross_pairs(*a64), True, valid)
    report.setdefault("parent_batches", {})[report_key] = ring_batch(nb)
    return {"B": int(valid.shape[0]), "valid_pairs": int(valid.sum()),
            "two_crossing_ok": int(ref.ok.sum()),
            "max_abs_err_f32": err32, "max_abs_err_f64": err64,
            "f32_bitwise_equal": bitwise_report(got, ref)}


def phase_kernel(dev, report):
    from subzero_tpu_torch.geometry.clip import two_cross_pairs
    from subzero_tpu_torch.geometry.two_cross import two_cross_cuda
    from subzero_tpu_torch.physics.collisions import narrow_phase_batch
    from subzero_tpu_torch.simulation import run_scan

    synthetic = {}
    for dtype, V in ((np.float32, 16), (np.float64, 16), (np.float32, 32), (np.float64, 32)):
        args = to_device(build_pair_list(4096, V, V, dtype, seed=V), dev)
        got = two_cross_cuda(*args)
        ref = two_cross_pairs(*args)
        torch.cuda.synchronize()
        name = f"{np.dtype(dtype).name}_V{V}"
        synthetic[name] = compare_two_cross(got, ref, dtype == np.float64, args[-1])
        cnt = ref.cnt
        if not ((cnt == 0).any() and (cnt == 2).any() and (cnt > 2).any()
                and (ref.contain > 0).any() and ref.ok.any()):
            raise AssertionError(f"synthetic batch {name} misses a regime")
        again = two_cross_cuda(*args)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"synthetic batch {name}: two launches differ")

    # the pair list the main path gives the kernel: shear_flow_500 after 20 steps
    sim, _ = run_scan(build_sim(500, 1e5, 2e3, device=dev, dtype=torch.float32), 20)
    nb = narrow_phase_batch(sim.model.floes, sim.model.domain, sim.pair_cap)
    main_path = check_main_path_batch(nb, "shear_flow_500", report)
    timing = time_kernel(nb)
    report.update(max_abs_err=main_path["max_abs_err_f32"], timing=timing)
    emit("kernel", synthetic_max_abs_err=synthetic, main_path=main_path,
         timing=timing)


def phase_slice(dev, report):
    sim = build_sim(500, 1e5, 2e3, device=dev, dtype=torch.float32)
    from subzero_tpu_torch.simulation import run_scan

    run_scan(fork(sim), 5)  # warm-up: allocator, cuBLAS handles
    _, nums = run_timed(sim, 400)
    report["launches"] = nums["kernel_launches"]
    emit("slice", config="shear_flow_500", dtype="float32", **nums)


def phase_card_cpu(dev):
    from subzero_tpu_torch.simulation import run_scan

    n = 20
    on_card = build_sim(500, 1e5, 2e3, device=dev, dtype=torch.float64)
    on_cpu = build_sim(500, 1e5, 2e3, device="cpu", dtype=torch.float64)
    if not torch.equal(on_card.model.floes.verts.cpu(), on_cpu.model.floes.verts):
        raise AssertionError("host setup differs between the card and the CPU")
    on_card, _ = run_scan(on_card, n)
    on_cpu, _ = run_scan(on_cpu, n)
    fc, fh = on_card.model.floes, on_cpu.model.floes
    oc, oh = on_card.model.ocean, on_cpu.model.ocean
    if not torch.equal(fc.active.cpu(), fh.active):
        raise AssertionError("active floes differ between the card and the CPU")
    diffs = {f: max_rel_diff(getattr(fc, f), getattr(fh, f))
             for f in ("centroid", "u", "v", "xi", "collision_force")}
    # a cell whose ice area is roundoff (a floe edge grazing it) carries the
    # floe's stress divided by that roundoff area on both sides: compare the
    # ocean stress weighted by the ice fraction, i.e. its share of the force
    frac = torch.maximum(oc.si_frac.cpu(), oh.si_frac)
    for f in ("tau_x", "tau_y"):
        g, r = getattr(oc, f).cpu(), getattr(oh, f)
        w = torch.where(frac > 1e-8, torch.ones_like(frac), frac)
        diffs[f] = float(((g - r) * w).abs().max()) / float(r.abs().max())
    diffs["si_frac"] = max_rel_diff(oc.si_frac, oh.si_frac)
    worst = max(diffs.values())
    if not worst <= CARD_CPU_TOL:
        raise AssertionError(f"card vs CPU beyond {CARD_CPU_TOL}: {diffs}")
    emit("card_cpu", config="shear_flow_500", dtype="float64", n_steps=n,
         tolerance=CARD_CPU_TOL, max_rel_diff=diffs,
         n_overflow=[on_card.n_overflow, on_cpu.n_overflow])


def phase_determinism(dev):
    from subzero_tpu_torch.simulation import run_scan

    sim = build_sim(500, 1e5, 2e3, device=dev, dtype=torch.float32)
    a, _ = run_scan(fork(sim), 50)
    b, _ = run_scan(fork(sim), 50)
    for name in ("floes", "ocean"):
        ta, tb = getattr(a.model, name), getattr(b.model, name)
        for f, x, y in zip(ta._fields, ta, tb):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}.{f} differs between two runs")
    emit("determinism", config="shear_flow_500", dtype="float32", n_steps=50,
         bitwise_equal=True)


def phase_many_floes(dev, report):
    from subzero_tpu_torch.physics.collisions import narrow_phase_batch
    from subzero_tpu_torch.simulation import run_scan

    sim = build_sim(2000, 2e5, 2e3, device=dev, dtype=torch.float32)
    nb = narrow_phase_batch(sim.model.floes, sim.model.domain, sim.pair_cap)
    check = check_main_path_batch(nb, "many_floes_2000", report)
    timing = time_kernel(nb)
    run_scan(fork(sim), 5)  # warm-up
    _, nums = run_timed(sim, 50)
    emit("many_floes_2000", dtype="float32", kernel_timing=timing,
         kernel_check=check, **nums)


def step_ms(sim, n_steps) -> float:
    from subzero_tpu_torch.simulation import run_scan

    run_scan(fork(sim), 5)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_scan(sim, n_steps)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n_steps


def phase_profile(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from subzero_tpu_torch.simulation import run_scan

    def cfg(**kw):
        return build_sim(500, 1e5, 2e3, device=dev, dtype=torch.float32, **kw)

    # the three variants in turns, three rounds; medians (host time varies)
    runs = {"step": [], "no_coupling": [], "no_collisions": []}
    for _ in range(3):
        runs["step"].append(step_ms(cfg(), 100))
        runs["no_coupling"].append(step_ms(cfg(coupling=False), 100))
        runs["no_collisions"].append(step_ms(cfg(collisions=False), 100))
    full, no_cpl, no_col = (statistics.median(v) for v in runs.values())
    split = {"step": full, "collisions": full - no_col,
             "coupling_amortized": full - no_cpl,
             "integrate_remove_other": no_col + no_cpl - full, "runs_ms": runs}

    n = 20
    sim, _ = run_scan(cfg(), 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scan(sim, n)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    ops = sorted((e for e in avgs if e.device_type != DeviceType.CUDA and dev_us(e) > 0),
                 key=dev_us, reverse=True)
    emit("profile", config="shear_flow_500", dtype="float32",
         step_ms_split=split, profiled_steps=n,
         wall_ms_per_step_profiled=wall_ms / n,
         device_busy_ms_per_step=busy_ms / n,
         device_busy_share=busy_ms / wall_ms,
         kernel_launches_per_step=sum(e.count for e in kernels) / n,
         top_ops=[{"op": e.key[:80], "device_ms_per_step": dev_us(e) / 1e3 / n,
                   "calls_per_step": e.count / n} for e in ops[:15]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="a checkout of an earlier commit whose kernel took "
                    "materialised ring batches: time it on the same batches")
    ap.add_argument("--parent-worker", metavar="FILE", default=None,
                    help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    phases = [p for p in opts.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if opts.parent_worker:
        return parent_worker(opts.parent_worker)
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)

    from subzero_tpu_torch.geometry import two_cross

    info = two_cross.build(force=True)
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=info["seconds"], library=info["path"], ptxas=ptxas)

    report = {}
    if "kernel" in phases:
        phase_kernel(dev, report)
    if "slice" in phases:
        phase_slice(dev, report)
    if "card_cpu" in phases:
        phase_card_cpu(dev)
    if "determinism" in phases:
        phase_determinism(dev)
    if "many_floes_2000" in phases:
        phase_many_floes(dev, report)
    if "profile" in phases:
        phase_profile(dev)
    if opts.parent and report.get("parent_batches"):
        emit("parent_kernel", checkout=opts.parent,
             **time_parent_kernel(opts.parent, report["parent_batches"]))

    # the kernel's numbers at the main path's batch (shear_flow_500 after 20
    # steps): ms is its own device time, call_ms the whole Python call
    t = report.get("timing", {})
    print(json.dumps({"kernels": [{
        "name": "two_cross",
        "route": "cuda",
        "source": "subzero_tpu_torch/csrc/two_cross.cu",
        "replaces": "subzero_tpu/geometry/pallas_clip.py:52",
        "launches": report.get("launches"),
        "max_abs_err": report.get("max_abs_err"),
        "ms": t.get("device_ms"),
        "plain_ms": t.get("plain_ms"),
        "bound_ms": t.get("bound_ms"),
        "bound_by": t.get("bound_by"),
        "library_ms": None,  # no one PyTorch call computes this function
        "device_ms": t.get("device_ms"),
        "queued_ms": t.get("queued_ms"),
        "empty_device_ms": t.get("empty_device_ms"),
        "empty_queued_ms": t.get("empty_queued_ms"),
        "call_ms": t.get("call_ms"),
    }]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
