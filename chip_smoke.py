#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``subzero_tpu_torch``) on one NVIDIA GPU.

Builds the narrow-phase CUDA kernel (B1) and the slow clip's (B2) from
``subzero_tpu_torch/csrc`` and the native host clip library from
``subzero_tpu_torch/native``, holds each kernel against its plain PyTorch
version (and B2 against its g++ host shim), and drives the port on the card: the
device step (collide, couple, integrate, remove) through
``simulation.run_scan`` on the five configurations of ``bench.py`` (through
``subzero_tpu_torch.bench``, 500 to 32 000 floes) and the conservation
scenarios in f32, and ``simulation.run`` with the host life cycle
(fracture, ridge/raft, weld, fuse) on the configuration of
``examples/many_floes.py``, all built with the
port's own host setup from seed 1, ``run`` with the output writers and
across a checkpoint/restart on the port's ``examples`` (simple_strait,
many_floes, restart_sim), and ``parallel.run_decomp`` as rank processes
(examples/distributed_shear_flow.py).  Imports no JAX.

Phases (one JSON line each; any failure raises and the exit code is not 0):

  device    torch / CUDA versions, the card, its power limit
  build     nvcc builds of the two kernel libraries and, for the regions
            and bench phases, the slow clip's clocked build (all at once),
            seconds
  kernel    kernel vs its plain version (clip.two_cross_pairs), both fed ring
            pools and a pair list: random star rings (V = 16, 32 and 40 (the
            wide instantiation), f32 and f64, 6144 rows over pools of 4096,
            rings shared between rows, some rows shifted, every 7th invalid;
            times at V = 32 and 40) and the pair list
            timestep_collisions feeds the narrow phase on shear_flow_500
            after 20 steps (f32 and f64); then the kernel's times at the
            main path's batch: device_ms (its own device time, from
            torch.profiler), queued_ms (launches enqueued back to back
            between two events) with an empty kernel's beside them as the
            floor, call_ms (the whole Python call), plain_ms, and bound_ms
            from the batch's own bytes and operations
  slice     shear_flow_500, f32, 200 steps of run_scan on the card (the
            step's graph captured before the clock starts)
  card_cpu  shear_flow_500, f64, 20 steps on the card (kernel) and on the
            CPU (plain versions): centroids, velocities, ocean stresses
  determinism  two 50-step runs on the card are bitwise equal
  many_floes_2000  50 steps of bench.build_sim(2000, 2e5, 2e3)'s counterpart,
            and the kernel's check and times at its batch (17 000 rows)
  binned    bench.build_sim(8000, 4e5, 2e3, bins=True)'s counterpart: the
            binned and the dense candidate list hold the same canonical pairs
            once each at step 0; the kernel's check and times at its batch
            (68 000 rows); timestep_collisions' overflow counters
            (with_debug=True) card against CPU at step 0; 50 steps of
            run_scan; ms/step binned and dense on that field and on
            many_floes_2000, in turns
  overlaps  shear_flow_500 after 100 steps, f32 and f64: pair_overlaps and
            pair_interactions on the card (kernel) against a CPU copy of the
            state (plain versions); the overflow counters card against CPU
            on its step-0 pool
  lifecycle examples/many_floes.py's configuration (1 000 floes in a pool of
            2 000, open boundaries, fracture every 75 steps, ridge/raft every
            150, weld every 500), f32, 601 steps of run, twice from one seed:
            topology changed, state finite, heights in bounds, mass ledger,
            bitwise equal; seconds by host pass, segments, pool transfers,
            host synchronisations a step, kernel launches by caller; on the
            pool at step 0 and after the run, the step's batch through the
            kernel and its plain version, and pair_overlaps and
            pair_interactions on the card against a CPU copy
  regions   the slow clip's kernel (B2: clip and parity retry in one launch,
            n_slow read on the card) against its g++ host shim, bitwise, and
            its plain
            version on the card (regions.held_against_plain: counts and
            flags as the plain version at the same dtype decides them,
            every floating field within LIMIT_SAME eps L^p of it, L the
            row's largest coordinate, and areas and first moments within
            LIMIT_F64 eps L^p of the plain version in f64), f32 and f64, on
            the slow rows of shear_flow_500 and many_floes_8000 after 20
            steps and of the life-cycle pool after the lifecycle phase's
            run, with n_slow cut to 0, on lattice polygons whose parities
            come out odd (the retry runs and resolves rows), and on combs of
            up to 40 vertices against bars (rings 40 wide, CAP 48, more than
            32 crossings a row); the kernel's own device time at each batch
            and at n_slow = 0, an empty launch's, the plain version's, the
            bound; and where a row's time goes: the clocked build's SM
            cycles by phase of the row's chain (median and 90th percentile
            over the live rows; bench adds the 16k and 32k batches)
  cell_clip the coupling's cell clip (B6) against its plain version on the
            card, f32, bitwise, on the coupling windows of shear_flow_500
            (cell_cap 19) and a 16 000-floe field (cell_cap 21) after 20
            steps, its count of the cells it clipped against the mask's; its
            own device time, queued, the plain version's, and the bound from
            the batch's bytes and operations
  graph     the step as a CUDA graph (step_graph.StepGraph, which
            run_scan, run and the bench replay on the card) against the same
            steps launched eagerly: one eager step of each program
            under torch.cuda.set_sync_debug_mode("error"); shear_flow_500
            (200 steps) and many_floes_8000 binned (50) through run_scan and
            the life-cycle run (601 steps of run, the lifecycle phase's) all
            bitwise equal in f32, one B1, one B2 and one B4 launch a step
            each side and one B6 launch on each coupled step (none on the
            others), held against the card's own count under replay; host
            synchronisations between run_scan's first and last step (none)
            and over the life-cycle run's first 100 steps by source line
            (none from the step's body), graph and eager; torch.profiler's
            host launch calls and device kernels a step, graph and eager;
            capture seconds and recaptures
  lifecycle_card_cpu  the same configuration and width, f64, with the
            fracture pass's deformation on (so that run calls
            pair_interactions) and weaker ice (so that the first pass
            fractures floes): the card against the CPU to just past the
            first fracture pass (76 steps)
  writers   examples/simple_strait.py through the port's
            examples.simple_strait.build (500 floes in a pool of 1 000,
            topography, its floe, grid and initial-state writers, the floe
            writer also writing interaction rows), f32, 201 steps of run:
            eulerian_data and the interaction rows on the card against a CPU
            copy at step 0 and at the end; the floe groups and grid times
            written, the last floe group bitwise equal to the pool pulled
            straight from the card; seconds by writer; launches by the step
            and by the writer's pair_interactions.  Without h5py (the card's
            machine has none) the writers' file halves keep their arrays in
            memory and the device halves run as they do with files
  restart   examples/many_floes.py's configuration at its width (f32): one
            run to step 450 against a run to step 300 with initial-state and
            checkpoint writers, restarted (device=None) from its checkpoint
            at 300 and run on to 450: every pool field, the ocean and the
            generator state bitwise equal (ids up to one offset), and the
            resumed leg fractured floes; then examples/restart_sim.py (20
            floes, f64) in three parts against one run, bitwise.  With h5py
            through the files, without through the writers' arrays
            (restore_simulation); seconds of restart itself
  decomp    parallel/decomp.py as rank processes of this script on the card
            (several ranks share one card through gloo: NCCL refuses two
            ranks on one GPU): examples/distributed_shear_flow.py at its
            width (500 floes, f32, 4 x-slabs, 500 steps; the single-device
            run of the same build after it), the kernel on a rank's
            halo-extended pool against its plain version, card against CPU
            ranks (f64, 20 steps), decomposed (1-D and 2 x 2) against the
            single-device step (f64, 5 steps), two runs with fracture
            bitwise equal with every rank's pool hashed after each host
            pass, many_floes_8000's field over 4 slabs (20 steps); then one
            rank through nccl (D = 1) against the single-device run, and
            four ranks through nccl where there are four cards; with
            --parent, the example's ranks of this tree and of the parent
            checkout in turns (this tree, parent, parent, this tree)
  bench     subzero_tpu_torch.bench's five configurations (bench.py's:
            shear_flow_500, many_floes_2000, 8000, 16000 and 32000) as the
            bench runs them, with one timed run where the bench takes the
            best of four, without its phase split: floes and candidate
            pairs equal to the JAX field's, end state finite and no floe
            lost, one kernel launch a step; two 20-step runs of
            many_floes_8000 bitwise equal; the kernel against its plain
            version, and its times, at the 16k and 32k batches, and the slow
            clip's (as the regions phase) at their slow rows; the slow
            path's device time and kernels a step (8k, 16k, 32k); the contact
            sums (collisions._segment_sum) card against CPU, bitwise, at the
            32k pool's rows; the bench's JSON line, with each
            configuration's capture seconds and peak memory (allocated, and
            reserved with the graphs' pool)
  f32_drift tests/test_f32_drift.py's gate through the kernel: head_on and
            three_floes, 5 000 f32 steps each (one process a scenario, both
            at once), drift within the JAX bounds
  profile   (only when named) where a shear_flow_500 step's time goes:
            step_ms with coupling or collisions off, as bench.py splits it,
            and torch.profiler's device time by operator and by kernel over
            20 eager steps
  e2e_shear_flow  (only when named) tools/e2e_shear_flow.py through the
            port's tools.e2e_shear_flow: 5 000 steps of run with the floe
            writer, 16 candidate rows a floe; fails on a step over capacity
  lifecycle_walltime  (only when named) tools/lifecycle_walltime.py through
            the port's tools.lifecycle_walltime: weld, smooth, a fracture of
            5% of the pool and fuse on the 8 016-floe pool pulled from the
            card, each against many_floes_8000's step at its cadence
  overflow_source  (only when named) tools/probe_overflow_source.py through
            the port's tool: which capacity fires the overflow flag, hit
            totals by term and the crowded floe, on its own configuration
            (shear_flow, 2 000 steps, 16 rows a floe), the lifecycle phase's
            run (probed through run's callback; the same overflow count as
            without it) and the overlap query on its final pool, and
            simple_strait's step 0
  scaling   (only when named) tools/measure_scaling.py through the port's
            tool as 4 gloo ranks sharing the card (not a scaling figure):
            comm isolation against decomp.COMM_IDENTITY, bytes a step
            against comm_bytes_per_step, the NVLink projection from this
            card's own per-slab step; with nccl where there are four cards
  lifecycle_overhead  (only when named) tools/lifecycle_overhead.py through
            the port's tool as 4 gloo ranks: the JAX tool's fracture-on
            field at 1 and 4 ranks, the rows the host passes are handed and
            the passes' count and mean time
  memory_by_seed  (only when named) the benchmark's field_16k.scan cell as
            benchmark/run.py builds it, for each of MEMORY_SEEDS: the seed's
            bins and sub-floe points a floe, the transient peak (allocated) of an eager broad phase and
            of an eager coupling, then the graphs' capture pools, the
            allocated and reserved peaks after the warm-up and after one
            pass of run_scan calls (device_mem_gib reads the reserved one)

Then a line with each phase's seconds, a {"kernels": [...]} line, the
nvidia-smi name/power-limit line, and
last {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --parent _parent     # also time an older kernel

``--parent DIR`` names a checkout of an earlier commit of this repository.
With the bench phase, bench's five configurations run in turns, this tree's
(the step's graph) and that checkout's own (a process of its code), with
step_ms and peak memory of each; with the decomp phase, the distributed
example's ranks of both run in turns.  And both kernels (B1 and B2) of this
tree and of that checkout (one whose slow clip takes pools, a pair list and
a slow selection) run on the batches the phases gave them, in turns (this
tree, a process of the checkout's code twice, this tree): each batch's own
device time a call, and the outputs equal to the bit where the checkout's
kernel takes the batch.

On the card run_scan and run replay the step captured as a CUDA graph; each
graph runs its program once eagerly before the capture (a warm-up), and those
kernel launches are counted apart from a path's own (``path_launches``).
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

PHASES = ("build", "kernel", "slice", "card_cpu", "determinism",
          "many_floes_2000", "binned", "overlaps", "lifecycle", "regions", "forces",
          "cell_clip", "graph",
          "lifecycle_card_cpu", "writers", "restart", "bench", "f32_drift",
          "decomp")
EXTRA_PHASES = ("profile", "e2e_shear_flow", "lifecycle_walltime", "overflow_source",
                "scaling", "lifecycle_overhead", "memory_by_seed")
SEED = 1
LIFECYCLE_N_DT = 600   # the life-cycle runs of examples/many_floes.py: steps 0..600

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


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

def build_sim(n_floes, L, dx, **kw):
    """``subzero_tpu_torch.bench.build_sim``: the port's counterpart of
    ``bench.build_sim(n_floes, L, dx, bins=)`` (imported when called: the
    --parent worker imports an older checkout's package)."""
    from subzero_tpu_torch.bench import build_sim

    return build_sim(n_floes, L, dx, **kw)


def build_many_floes(n_floes, *, device, dtype, n_dt, seed=SEED, deform=False,
                     pstar=None):
    """The port's ``examples.many_floes.build`` (the configuration of
    ``examples/many_floes.py``: a 2e5 m open box on a 1e4 m grid, ocean
    u = -0.2, ``n_floes`` Voronoi floes at concentration 0.8 in a pool of
    twice as many, dt 20, one-way coupling, Hibler fracture into 3 pieces
    every 75 steps, ridge/raft every 150, weld every 500 on a 4x4 grid) with
    what this script states: no writers, not verbose, its own name and seed,
    the fracture pass's deformation when ``deform``, and ``pstar`` in place
    of the yield curve's ice strength (the example keeps HiblerYieldCurve's
    default)."""
    from subzero_tpu_torch.examples import many_floes

    sim = many_floes.build(dtype=dtype, n_dt=n_dt, n_floes=n_floes, device=device)
    fr = dataclasses.replace(sim.fracture_settings, deform_on=deform)
    if pstar is not None:
        fr = dataclasses.replace(fr, criteria=dataclasses.replace(fr.criteria, pstar=pstar))
    return dataclasses.replace(sim, seed=seed, name="chip_smoke_many_floes",
                               verbose=False, fracture_settings=fr)


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


# torch.profiler traces that held only part of their measured launches'
# device events (profiled_ms takes such a trace again): each one's kernel name
# part, launches, events by kernel from the trace's own device events and
# from key_averages, and the measured host calls with no device event; the
# seconds line prints them
PARTIAL_TRACES = []


def traced_events(launch, name_part, n, lead=4):
    """One torch.profiler trace of ``lead`` calls of ``launch`` and then n
    measured ones: the profiler, the durations (ns) of the measured calls'
    own device events whose name holds ``name_part``, by name (matched to
    the measured calls' host launch calls by correlation id), and which of
    those host calls (their order) have no device event in the trace.  The
    first calls only lead: a trace's first launches can have no device
    event, one early in a run and ten after some minutes (the H100 with
    torch 2.11)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            launch()
        with record_function("measured"):
            for _ in range(n):
                launch()
        torch.cuda.synchronize()
    ev = prof.profiler.kineto_results.events()
    span = next(e for e in ev if e.name() == "measured")
    calls = sorted((e.start_ns(), e.correlation_id()) for e in ev
                   if e.device_type() == DeviceType.CPU and e.name().startswith("cu")
                   and ("Launch" in e.name() or "Memset" in e.name())
                   and span.start_ns() <= e.start_ns() <= span.end_ns())
    mine = {c for _, c in calls}
    by_name, on_card = {}, set()
    for e in ev:
        if e.device_type() == DeviceType.CUDA and e.correlation_id() in mine:
            on_card.add(e.correlation_id())
            if name_part in e.name():
                by_name.setdefault(e.name(), []).append(e.duration_ns())
    return prof, by_name, [k for k, (_, c) in enumerate(calls) if c not in on_card]


def profiled_ms(launch, name_part, n=20, tries=6):
    """(device ms a call, kernels a call, traces taken), host taken out:
    torch.profiler over n calls of ``launch`` (traced_events), each of
    which launches each kernel whose name holds ``name_part`` once (the
    parent's slow clip two kernels, every other launch here one): the sum
    of those kernels' mean device times, read from the trace's own device
    events (each one whole kernel's time), and how many such kernels there
    are.  A reading comes only from a whole trace, one that holds an event
    of every measured launch of every such kernel: a trace that comes back
    with some dropped is kept in PARTIAL_TRACES and taken again, with a
    lead longer by the host calls it lost, up to ``tries`` traces, and if
    none is whole AssertionError names the events each trace held."""
    from torch.autograd import DeviceType

    launch()
    torch.cuda.synchronize()
    lead = 4
    for k in range(tries):
        prof, by_name, missing = traced_events(launch, name_part, n, lead)
        counts = {name: len(d) for name, d in by_name.items()}
        if by_name and not missing and all(c == n for c in counts.values()):
            return (sum(sum(d) / n for d in by_name.values()) / 1e6, len(by_name), k + 1)
        averaged = {e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and name_part in e.key}
        PARTIAL_TRACES.append({"name": name_part, "launches": n, "lead": lead,
                               "events": counts, "key_averages": averaged,
                               "missing_launches": missing})
        lead += (max(missing) + 1 if missing else 0) + 4
    raise AssertionError(f"profiler: none of {tries} traces of {n} launches held "
                         f"every event of {name_part}: {PARTIAL_TRACES[-tries:]}")


def memset_ms(launch, n=20) -> dict:
    """The memsets' mean device time over n calls of ``launch`` and the
    number of memset events the trace held (traced_events); used for no
    kernel's time."""
    launch()
    torch.cuda.synchronize()
    d = traced_events(launch, "Memset", n)[1].get("Memset (Device)", [])
    return {"device_ms": sum(d) / len(d) / 1e6 if d else None, "events": len(d),
            "launches": n}


def profiled_kernel_ms(launch, kernel_name, n=20) -> float:
    """The kernel's own device time a launch, from a whole trace
    (profiled_ms)."""
    return profiled_ms(launch, kernel_name, n)[0]


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s;
# 67 TFLOP/s in f32 outside the tensor cores counts an FMA as two operations,
# and the kernel is built without FMA contraction, so its peak is half that.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12 / 2
OPS_PER_EDGE_PAIR = 30  # one crossing test (two_cross.cuh:edge_crossing)
# torch.profiler's names of B1's device functions hold this: two_cross_kernel
# (rings up to 32 vertices) and two_cross_wide_kernel (wider)
B1_EVENT = "two_cross_"
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


def time_kernel(args) -> dict:
    """The kernel's times on one narrow-phase pair list (its arguments,
    clip.TWO_CROSS_ARGS; f32), its plain version's, an empty launch's and
    the bound from this list's sizes."""
    from subzero_tpu_torch.geometry import two_cross
    from subzero_tpu_torch.geometry.clip import two_cross_pairs

    p_verts, p_n, q_verts, q_n, qi, qj = args[:6]
    valid = args[8]
    PC = int(qi.shape[0])
    buf = two_cross.alloc_output(PC, p_verts.dtype, p_verts.device)

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
            lambda: two_cross.launch_into(buf, *head), B1_EVENT),
        "device_ms_no_row_valid": profiled_kernel_ms(
            lambda: two_cross.launch_into(buf, *none_valid), B1_EVENT),
        "V": int(p_verts.shape[1]), "W": int(q_verts.shape[1]),
        "valid_rows": int(valid.sum()),
        "plain_ms": median_ms(lambda: two_cross_pairs(*args)),
        "device_ms": profiled_kernel_ms(launch, B1_EVENT),
        "queued_ms": queued_ms(launch),
        # the floor under any launch: an empty kernel timed the same two ways
        "empty_device_ms": profiled_kernel_ms(two_cross.empty_launch, "empty_kernel"),
        "empty_queued_ms": queued_ms(two_cross.empty_launch),
        "call_ms": median_ms(lambda: two_cross.two_cross_cuda(*args)),
        **two_cross_bound(args, PC, p_n[qi], q_n[qj], live=valid),
    }


# ---------------------------------------------------------------------------
# the slow clip (B2) on the main path's slow batches
# ---------------------------------------------------------------------------

OPS_PER_EDGE_PAIR_B2 = 25  # a crossing test of the slow clip, with its share of the rest
# the wide batches: rings wider than a warp and more than 32 crossings a row
# kept (the JAX package runs any width and any clip_cap)
WIDE_V = 40
WIDE_CAP = 48
_REGIONS_SHIM = []


def regions_shim():
    """The slow clip's host shim (g++), built once a process."""
    from subzero_tpu_torch.geometry import regions

    if not _REGIONS_SHIM:
        _REGIONS_SHIM.append(regions.build_host_shim())
    return _REGIONS_SHIM[0]


def slow_selection(nb, pair_cap):
    """The step's slow selection on a narrow-phase batch: the rows the
    narrow-phase kernel leaves to the slow clip, the first slow_cap of them
    (ssel, PC where unused) and their count n_slow, on the card."""
    from subzero_tpu_torch.geometry.clip import first_true, two_cross_dispatch

    tc = two_cross_dispatch(*nb.two_cross_args())
    slow = (tc.cnt > 0) & ~tc.ok
    return first_true(slow, max(pair_cap // 128, 32), nb.pairs.qi.shape[0]), slow.sum()


def regions_bound(args, ssel, n_slow, cap) -> dict:
    """The least time the card could take for one slow clip: the larger of
    its bytes (the selection and n_slow; for each live row its indices,
    shift, perturbation, vertex counts and two rings; the packed output of
    every row) over the memory rate, and ~25 operations for each edge pair
    of the live rows' rings over the f32 rate."""
    from subzero_tpu_torch.geometry import regions

    p_verts, p_n, q_verts, q_n, qi, qj = args[:6]
    R, elt = ssel.shape[0], p_verts.element_size()
    live = min(int(n_slow), R)
    rows = ssel[:live]
    pn, qn = p_n[qi[rows]].long(), q_n[qj[rows]].long()
    nbytes = (8 * R + 8 + live * (16 + 3 * elt + 8) + int((pn + qn).sum()) * 2 * elt
              + regions.output_bytes(R, cap, p_verts.dtype))
    ops = OPS_PER_EDGE_PAIR_B2 * int((pn * qn).sum())
    by_bytes = 1e3 * nbytes / H100_BYTES_PER_S
    by_ops = 1e3 * ops / H100_F32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": ops, "live_rows": live}


def regions_against(args, ssel, n_slow, cap, what) -> dict:
    """The slow clip's kernel (clip and retry) against its host shim, to the
    bit, and its plain version on the card (regions.held_against_plain);
    rows past n_slow zeros."""
    from subzero_tpu_torch.geometry import regions

    got, gbad = regions.regions_cuda(*args, ssel, n_slow, cap, retry_cap())
    first, _ = regions.regions_cuda(*args, ssel, n_slow, cap, 0)
    host, hbad = regions.run_host_shim(regions_shim(), *(x.cpu() for x in args),
                                       ssel.cpu(), n_slow.cpu(), cap, retry_cap())
    torch.cuda.synchronize()
    if not torch.equal(gbad.cpu(), hbad) or not all(
            torch.equal(x.cpu(), y) for x, y in zip(got, host)):
        raise AssertionError(f"{what}: the slow clip's kernel and its host shim differ")
    live = min(int(n_slow), ssel.shape[0])
    if any(bool(x[live:].any()) for x in got):
        raise AssertionError(f"{what}: a row past n_slow is not zeros")
    try:
        held = regions.held_against_plain(got, gbad, *args, ssel, n_slow, cap,
                                          retry_cap())
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from e
    return {"bitwise_equal_shim": True, "plain": held,
            "odd_rows": int(gbad.sum()),
            "resolved_by_retry": int((gbad & ~got.overflow).sum()),
            "rows_the_retry_changed": int(torch.stack(
                [(a != b).reshape(a.shape[0], -1).any(1) for a, b in zip(first, got)]
            ).any(0).sum())}


def time_regions(args, ssel, n_slow, cap) -> dict:
    """The slow clip's times on one slow batch: its kernel's own device time
    (torch.profiler), at this n_slow and at n_slow = 0, queued and whole
    call, an empty launch's, the plain version's, and the bound."""
    from subzero_tpu_torch.geometry import regions

    dtype, dev = args[0].dtype, args[0].device
    buf = regions.alloc_output(ssel.shape[0], cap, dtype, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def launch(n=n_slow):
        return lambda: regions.launch_into(buf, *args, ssel, n, cap, retry_cap())

    return {
        "device_ms": profiled_kernel_ms(launch(), "regions_kernel"),
        "device_ms_n_slow_0": profiled_kernel_ms(launch(zero), "regions_kernel"),
        "queued_ms": queued_ms(launch()), "queued_ms_n_slow_0": queued_ms(launch(zero)),
        # the 8-byte memset of the call's ticket before the kernel
        "ticket_memset": memset_ms(launch()),
        "empty_device_ms": profiled_kernel_ms(regions.empty_launch, "empty_kernel"),
        "empty_queued_ms": queued_ms(regions.empty_launch),
        "call_ms": median_ms(lambda: regions.regions_cuda(
            *args, ssel, n_slow, cap, retry_cap())),
        "plain_ms": median_ms(lambda: regions.slow_regions_plain(
            *args, ssel, n_slow, cap, retry_cap()), reps=10),
        **regions_bound(args, ssel, n_slow, cap),
        "bound_ms_n_slow_0": regions_bound(args, ssel, zero, cap)["bound_ms"],
    }


def sm_clocks() -> dict:
    """The card's SM clock now and its maximum, MHz (nvidia-smi), to read
    cycles as time."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        now, peak = (float(x) for x in out.split(","))
        return {"sm_mhz": now, "max_sm_mhz": peak}
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return {"sm_mhz": None, "max_sm_mhz": None}


def phase_cycles(args, ssel, n_slow, cap) -> dict:
    """Where a slow row's time goes: one launch of the clocked build
    (regions.clocked_cycles, -DSZ_REGIONS_CLOCK, built only for this) on the
    batch; the median and 90th percentile over the live rows of the SM
    cycles of each phase of a row's chain, of the whole chain, and of the
    retry's chain over the rows that were retried."""
    from subzero_tpu_torch.geometry import regions

    clk = regions.clocked_cycles(*args, ssel, n_slow, cap, retry_cap())
    live = min(int(n_slow), ssel.shape[0])
    c = clk[:live].double().cpu()

    def spread(x):
        if not x.numel():
            return None
        return {"median": float(x.quantile(0.5)), "p90": float(x.quantile(0.9))}

    phases = regions.CLOCK_PHASES
    out = {name: spread(c[:, k]) for k, name in enumerate(phases[:-1])}
    out["row_chain"] = spread(c[:, :len(phases) - 1].sum(1))
    retried = c[:, -1]
    out["retry"] = spread(retried[retried > 0])
    return dict(out, rows=live, rows_retried=int((retried > 0).sum()), **sm_clocks())


B2_BATCH_KEYS = ("device_ms", "device_ms_n_slow_0", "bound_ms", "bound_by",
                 "plain_ms", "live_rows")


def regions_on_batch(nb, pair_cap, cap, what, report) -> dict:
    """The slow clip on a main-path narrow-phase batch's own slow rows: f32
    as fed and cast to f64 against shim and plain, and its f32 times (kept
    for the kernels line under ``what``)."""
    args = nb.two_cross_args()[:8]
    ssel, n_slow = slow_selection(nb, pair_cap)
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    keep_for_parent(report, "regions", what, args, ssel, n_slow, cap)
    out = {"slow_cap": int(ssel.shape[0]), "n_slow": int(n_slow), "cap": cap,
           "float32": regions_against(args, ssel, n_slow, cap, what),
           "float64": regions_against(a64, ssel, n_slow, cap, what + " (f64)"),
           "timing": time_regions(args, ssel, n_slow, cap),
           "cycles": phase_cycles(args, ssel, n_slow, cap)}
    report.setdefault("regions_by_batch", {})[what] = {
        "slow_cap": out["slow_cap"], "n_slow": out["n_slow"],
        **{k: out["timing"][k] for k in B2_BATCH_KEYS}}
    return out


def wide_slow_rows(dev, seed=SEED, K=256, V=WIDE_V, max_cross=None):
    """A slow batch of rings V wide (40 unless said) with up to
    ``max_cross`` (V unless said) crossings a row (f32): combs of V / 4 - 2
    to V / 4 teeth (4 vertices a tooth) against bars across their first
    max_cross / 4 teeth (4 crossings a tooth), each bar a trapezoid (its
    thickness grows along it, so no region's P-chain normal cancels), under
    a random rotation, scale and shift.  Every row is slow (ssel 0..K-1)."""
    rng = np.random.default_rng(seed)
    pv, qv = np.zeros((K, V, 2)), np.zeros((K, V, 2))
    pn, qn = np.zeros(K, np.int32), np.zeros(K, np.int32)
    for k in range(K):
        teeth = int(rng.integers(V // 4 - 2, V // 4 + 1))
        w, gap, base, H = rng.uniform(0.5, 1.5), rng.uniform(1.5, 3), 2.0, 10.0
        L = teeth * w + (teeth - 1) * gap
        comb = [(0.0, 0.0), (L, 0.0)]
        for m in range(teeth - 1, -1, -1):
            xl = m * (w + gap)
            comb += [(xl + w, base + H), (xl, base + H)]
            if m > 0:
                comb += [(xl, base), (xl - gap, base)]
        y0 = base + rng.uniform(2, 4)
        crossed = min(teeth, (max_cross or V) // 4)
        end = L + 1.0 if crossed == teeth else crossed * (w + gap) - gap / 2
        bar = [(-1.0, y0), (end, y0 - 0.5), (end, y0 + 4.0), (-1.0, y0 + 1.5)]
        th, sc = rng.uniform(0, 2 * np.pi), 10.0 ** rng.uniform(2, 4)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        t = rng.uniform(-1e5, 1e5, 2)
        for v, n, ring in ((pv, pn, comb), (qv, qn, bar)):
            r = sc * np.asarray(ring) @ rot.T + t
            v[k, :len(r)], v[k, len(r):], n[k] = r, r[-1], len(r)
    pert = np.abs(pv).max(axis=(1, 2)) * 1e-9
    idx = torch.arange(K, device=dev)
    f = dict(dtype=torch.float32, device=dev)
    args = (torch.tensor(pv, **f), torch.tensor(pn, device=dev), torch.tensor(qv, **f),
            torch.tensor(qn, device=dev), idx, idx, torch.zeros((K, 2), **f),
            torch.tensor(pert, **f))
    return args, idx.clone(), torch.tensor(K, device=dev)


def lattice_slow_rows(dev, seed=SEED, K=64):
    """A slow batch whose parities come out odd: polygons with vertices on a
    coarse lattice against translated copies of themselves and each other
    (shared edges, vertices on edges), with a perturbation of ~1e-8 of the
    coordinates, which f32 rounds away on some of them and the retry's
    -41 times it does not.  Every row is slow (ssel 0..K-1)."""
    rng = np.random.default_rng(seed)
    V = 16
    pv, qv = np.zeros((K, V, 2)), np.zeros((K, V, 2))
    pn, qn = np.zeros(K, np.int32), np.zeros(K, np.int32)

    def lattice_poly():
        nv = int(rng.integers(3, 9))
        th = np.sort(rng.choice(np.arange(16), nv, replace=False)) * 2 * np.pi / 16
        r = rng.integers(2, 5, nv)
        return np.round(np.stack([r * np.cos(th), r * np.sin(th)], 1))

    for k in range(K):
        P = lattice_poly()
        Q = P + rng.integers(-2, 3, 2) if k % 2 else lattice_poly()
        for v, n, ring in ((pv, pn, P), (qv, qn, Q)):
            v[k, :len(ring)] = ring
            v[k, len(ring):] = ring[-1]
            n[k] = len(ring)
    pert = np.abs(pv).max(axis=(1, 2)) * 10.0 ** rng.uniform(-8.5, -7.5, K)
    idx = torch.arange(K, device=dev)
    f = dict(dtype=torch.float32, device=dev)
    args = (torch.tensor(pv, **f), torch.tensor(pn, device=dev), torch.tensor(qv, **f),
            torch.tensor(qn, device=dev), idx, idx, torch.zeros((K, 2), **f),
            torch.tensor(pert, **f))
    return args, idx.clone(), torch.tensor(K, device=dev)


def phase_regions(dev, report):
    """The slow clip's kernel (B2) against its host shim (bitwise) and its
    plain version (regions.held_against_plain), f32 and f64, on the slow
    rows real steps give it: shear_flow_500 after 20 steps, many_floes_8000
    (binned) after 20 steps, the life-cycle pool after the lifecycle
    phase's run (at step 0 when that phase did not run); with n_slow cut
    to 0; and on lattice
    polygons whose parities come out odd, so that the retry runs and
    resolves rows.  Times at each batch (bench adds the 16k and 32k
    fields')."""
    from subzero_tpu_torch.geometry import regions
    from subzero_tpu_torch.physics.collisions import narrow_phase_batch
    from subzero_tpu_torch.simulation import run_scan

    out = {}
    for name, (n, L, bins) in {"shear_flow_500": (500, 1e5, False),
                               "many_floes_8000": (8000, 4e5, True)}.items():
        sim, _ = run_scan(build_sim(n, L, 2e3, device=dev, dtype=torch.float32,
                                    bins=bins), 20)
        m = sim.model
        nb = narrow_phase_batch(m.floes, m.domain, sim.pair_cap, sim.bins)
        out[name] = regions_on_batch(nb, sim.pair_cap, sim.clip_cap, name, report)
        if name == "shear_flow_500":
            ssel, _ = slow_selection(nb, sim.pair_cap)
            args = nb.two_cross_args()[:8]
            none = torch.zeros((), dtype=torch.int64, device=dev)
            out["n_slow_0"] = regions_against(args, ssel, none, sim.clip_cap, "n_slow 0")
            keep_for_parent(report, "regions", "n_slow 0", args, ssel, none, sim.clip_cap)
            report["regions_timing"] = out[name]["timing"]
        del sim, nb
        torch.cuda.empty_cache()
    lc = report.get("lifecycle_run") or build_many_floes(
        1000, device=dev, dtype=torch.float32, n_dt=LIFECYCLE_N_DT)
    m = lc.model
    nb = narrow_phase_batch(m.floes, m.domain, lc.pair_cap, lc.bins)
    out["lifecycle_pool"] = dict(regions_on_batch(nb, lc.pair_cap, lc.clip_cap,
                                                  "lifecycle pool", report),
                                 after_the_run="lifecycle_run" in report)
    args, ssel, n_slow = lattice_slow_rows(dev)
    keep_for_parent(report, "regions", "lattice", args, ssel, n_slow, 16)
    out["retry_lattice"] = dict(regions_against(args, ssel, n_slow, 16, "lattice"),
                                timing=time_regions(args, ssel, n_slow, 16),
                                cycles=phase_cycles(args, ssel, n_slow, 16))
    if not out["retry_lattice"]["resolved_by_retry"]:
        raise AssertionError(f"the retry resolved no row: {out['retry_lattice']}")
    report.setdefault("regions_by_batch", {})["lattice"] = {
        "slow_cap": int(ssel.shape[0]), "n_slow": int(n_slow),
        **{k: out["retry_lattice"]["timing"][k] for k in B2_BATCH_KEYS}}
    # rings 40 wide, CAP 48: crossings past a warp's 32 lanes
    args, ssel, n_slow = wide_slow_rows(dev)
    what = f"wide V{WIDE_V} CAP {WIDE_CAP}"
    keep_for_parent(report, "regions", what, args, ssel, n_slow, WIDE_CAP)
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    out["wide"] = {"V": WIDE_V, "cap": WIDE_CAP, "n_slow": int(n_slow),
                   "float32": regions_against(args, ssel, n_slow, WIDE_CAP, what),
                   "float64": regions_against(a64, ssel, n_slow, WIDE_CAP, what + " (f64)"),
                   "timing": time_regions(args, ssel, n_slow, WIDE_CAP),
                   "cycles": phase_cycles(args, ssel, n_slow, WIDE_CAP)}
    kept = int(regions.regions_cuda(*args, ssel, n_slow, WIDE_CAP, 0)[0].n_cross.sum(1).max())
    if kept <= 32:
        raise AssertionError(f"{what}: no row kept more than 32 crossings ({kept})")
    out["wide"]["most_crossings_kept"] = kept
    report["regions_by_batch"][what] = {
        "slow_cap": int(ssel.shape[0]), "n_slow": int(n_slow),
        **{k: out["wide"]["timing"][k] for k in B2_BATCH_KEYS}}
    # the widest the kernel takes: rings of 120-128 vertices (257 prefix-sum
    # terms), 64 crossings a row at CAP 64; held_against_plain's limits of
    # the summed fields grow with the terms there (regions.READ_VERTS)
    V, cap = regions.MAX_VERTS, regions.MAX_CAP
    args, ssel, n_slow = wide_slow_rows(dev, K=64, V=V, max_cross=cap)
    what = f"widest V{V} CAP {cap}"
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    out["widest"] = {"V": V, "cap": cap, "n_slow": int(n_slow),
                     "float32": regions_against(args, ssel, n_slow, cap, what),
                     "float64": regions_against(a64, ssel, n_slow, cap, what + " (f64)"),
                     "timing": time_regions(args, ssel, n_slow, cap)}
    report["regions_by_batch"][what] = {
        "slow_cap": int(ssel.shape[0]), "n_slow": int(n_slow),
        **{k: out["widest"]["timing"][k] for k in B2_BATCH_KEYS}}
    report["regions_max_abs_err"] = max(
        max(v.get("float32", v)["plain"]["max_abs"]["same_dtype"].values())
        for v in out.values())
    emit("regions", dtype="float32 (and the same batches in float64)",
         limit_eps_L={"same_dtype": regions.LIMIT_SAME, "float64": regions.LIMIT_F64},
         field_power=regions.FIELD_POWER,
         retry_rows=retry_cap(), **out)


# ---------------------------------------------------------------------------
# the force law (B4) on the main path's contact lists
# ---------------------------------------------------------------------------

# torch.profiler's name of B4's device function holds this
B4_EVENT = "forces_kernel"


def force_law_inputs(sim):
    """The force law's inputs at a Simulation's state, as its step makes
    them: (model, narrow-phase batch, B1's result, the slow path)."""
    from subzero_tpu_torch.geometry.clip import two_cross_dispatch
    from subzero_tpu_torch.physics import collisions

    m = sim.model
    nb = collisions.narrow_phase_batch(m.floes, m.domain, sim.pair_cap, sim.bins)
    tc = two_cross_dispatch(*nb.two_cross_args())
    slow = collisions._slow_path(nb, tc, sim.pair_cap, sim.clip_cap, retry=True)
    return m, nb, tc, slow


def forces_bound(law_args, buf, inputs) -> dict:
    """The least time the card could take for one force-law launch: every
    input array it reads (``inputs``) once and its output buffer written
    once, over the memory rate (its ~150 operations an item are ~0.02 us at
    4 800 items)."""
    nbytes = buf.numel() + sum(x.numel() * x.element_size() for x in inputs)
    return {"bound_ms": 1e3 * nbytes / H100_BYTES_PER_S, "bound_by": "bytes",
            "bytes": nbytes, "items": law_args.PC + law_args.S * law_args.R}


def phase_forces(dev, report):
    """The force law's kernel (B4) against the plain force law on the card,
    f32, to the bit (with the step's marking and without), and its times, on
    the contact lists of shear_flow_500 and many_floes_8000 (binned) after 20
    steps: its own device time from whole traces (torch.profiler), queued,
    the plain force law's time (the ~380 kernels it replaces), an empty
    launch's, and the byte bound."""
    from subzero_tpu_torch.physics import collisions, forces
    from subzero_tpu_torch.simulation import run_scan

    out = {}
    for name, (n, L, bins) in {"shear_flow_500": (500, 1e5, False),
                               "many_floes_8000": (8000, 4e5, True)}.items():
        sim, _ = run_scan(build_sim(n, L, 2e3, device=dev, dtype=torch.float32,
                                    bins=bins), 20)
        m, nb, tc, slow = force_law_inputs(sim)
        pairs = nb.pairs
        for marking in (True, False):
            cs = sim.collision_settings if marking else None
            got = collisions._force_law(sim.consts, sim.dt, cs, m.domain.vals, m.floes,
                                        nb, tc, slow, marking)
            ref = collisions._force_law_plain(sim.consts, sim.dt, cs, m.domain.vals,
                                              m.floes, nb, tc, slow, marking)
            torch.cuda.synchronize()
            for f, a, b in zip(forces.ForceLaw._fields, got, ref):
                pairs_ab = zip(a, b) if f == "s_sides" else [(a, b)]
                for x, y in pairs_ab:
                    if x is not None and not torch.equal(bits_of(x), bits_of(y)):
                        raise AssertionError(f"{name}: B4 and the plain force law "
                                             f"differ in {f} (marking {marking})")
        args = forces.prepare(sim.consts, sim.dt, sim.collision_settings, m.domain.vals,
                              m.floes, nb.q_table, pairs.qi, pairs.qj, pairs.shift,
                              pairs.valid, tc, slow.sel, slow.i, slow.j, slow.shift,
                              slow.regions, True)
        law_args, buf, inputs = args[0], args[1], args[3]

        def launch():
            forces.launch(law_args, torch.float32)

        def plain():
            collisions._force_law_plain(sim.consts, sim.dt, sim.collision_settings,
                                        m.domain.vals, m.floes, nb, tc, slow, True)

        out[name] = {
            "candidate_rows": int(pairs.qi.shape[0]),
            "valid_rows": int(pairs.valid.sum()),
            "slow_rows": int(slow.sel.shape[0]), "live_slow_rows": int(slow.valid.sum()),
            "regions_a_slow_row": int(slow.regions.area.shape[1]),
            "bitwise_equal_plain": True,
            "device_ms": profiled_kernel_ms(launch, B4_EVENT),
            "queued_ms": queued_ms(launch),
            "plain_ms": median_ms(plain),
            "plain_device_ops": plain_device_ops(plain),
            "empty_device_ms": profiled_kernel_ms(forces_empty_launch, "empty_kernel"),
            **forces_bound(law_args, buf, inputs),
        }
        del sim, nb, tc, slow, args
        torch.cuda.empty_cache()
    report["forces_timing"] = out["shear_flow_500"]
    emit("forces", dtype="float32", **out)


# ---------------------------------------------------------------------------
# the coupling's cell clip (B6) on the coupling windows
# ---------------------------------------------------------------------------

# torch.profiler's name of B6's device function holds this
B6_EVENT = "cell_clip_kernel"
# field: (floes, box side, binned broad phase, cell_cap as the benchmark's
# cells run them: shear_flow's 19, field_16k's 21)
B6_FIELDS = {"shear_flow_500": (500, 1e5, False, 19),
             "field_16k": (16000, 5.66e5, True, 21)}


def phase_cell_clip(dev, report):
    """The coupling's cell clip (B6) against its plain version on the card,
    f32, to the bit, on the coupling windows of shear_flow_500 and a 16 000-
    floe field (binned) after 20 steps: one launch a call, its count of the
    cells it clipped equal to the window mask's; its own device time from
    whole traces (torch.profiler), queued, the plain version's time (the
    ~120 kernels it replaces) and device operations, and the bound from
    these inputs' bytes and operations (benchmark/roofline/cell_clip.py,
    the b6_roofline metric's count)."""
    from benchmark.roofline import cell_clip as b6_count
    from subzero_tpu_torch.physics import cell_clip
    from subzero_tpu_torch.physics import coupling as C
    from subzero_tpu_torch.simulation import run_scan

    out = {}
    for name, (n, L, bins, cap) in B6_FIELDS.items():
        sim = dataclasses.replace(build_sim(n, L, 2e3, device=dev, dtype=torch.float32,
                                            bins=bins), cell_cap=cap)
        sim, _ = run_scan(sim, 20)
        m = sim.model
        args = C.window_inputs(m.floes, m.grid, m.domain, cap)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        l0 = cell_clip.launch_count()
        got = C._cell_areas(*args, count)
        ref = C._cell_areas_plain(*args)
        torch.cuda.synchronize()
        if cell_clip.launch_count() != l0 + 1:
            raise AssertionError(f"{name}: B6 counted {cell_clip.launch_count() - l0} "
                                 "launches in one call")
        if not torch.equal(bits_of(got), bits_of(ref)):
            raise AssertionError(f"{name}: B6 and the plain cell clip differ, largest "
                                 f"by {float((got - ref).abs().max())}")
        okx, oky = args[6], args[7]
        kept = (okx[:, :, None] & oky[:, None, :]).sum((1, 2))
        if int(count) != int(kept.sum()) or int(count) == 0:
            raise AssertionError(f"{name}: B6 counted {int(count)} cells, the mask "
                                 f"keeps {int(kept.sum())}")
        del got, ref
        launch_args = cell_clip.prepare(*args)

        def launch():
            cell_clip.launch(launch_args[0], torch.float32)

        def plain():
            C._cell_areas_plain(*args)

        N, A, B = okx.shape[0], okx.shape[1], oky.shape[1]
        c = b6_count.bound({"N": N, "A": A, "B": B, "elt": 4,
                            "nverts": args[1].cpu().numpy(), "kept": kept.cpu().numpy()},
                           {"bytes_per_s": H100_BYTES_PER_S,
                            "f32_ops_per_s": H100_F32_OPS_PER_S})
        out[name] = {
            "floes": N, "cell_cap": cap, "kept_cells": int(count),
            "floes_with_kept_cells": c["live_rows"], "bitwise_equal_plain": True,
            "device_ms": profiled_kernel_ms(launch, B6_EVENT),
            "queued_ms": queued_ms(launch),
            "plain_ms": median_ms(plain, reps=10, warmup=2),
            "plain_device_ops": plain_device_ops(plain),
            "bound_ms": 1e3 * c["bound_s"], "bound_by": c["bound_by"],
            "bytes": c["bytes"], "operations": c["operations"],
        }
        del sim, m, args, launch_args
        torch.cuda.empty_cache()
    report["cell_clip_timing"] = out
    emit("cell_clip", dtype="float32", **out)


def bits_of(x):
    """A tensor's bits: floats as the integers of their width."""
    x = x.contiguous()
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def forces_empty_launch():
    """An empty kernel through B4's library: the floor under its launch."""
    from subzero_tpu_torch.geometry import two_cross
    from subzero_tpu_torch.physics import forces

    two_cross.empty_launch(forces._load())


def plain_device_ops(fn) -> int:
    """The device operations (kernels and memsets) one call of ``fn`` runs
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


# ---------------------------------------------------------------------------
# an earlier commit's kernel on the same batches (--parent)
# ---------------------------------------------------------------------------

def keep_for_parent(report, kernel: str, name: str, *batch) -> None:
    """Keep a batch the main path gave a kernel (CPU copies of its tensors,
    and its ints) so that --parent can run the parent's kernel on it."""
    if not report.get("parent_dir"):
        return
    report.setdefault("parent_batches", {}).setdefault(kernel, {})[name] = tuple(
        x.cpu() if torch.is_tensor(x) else x for x in batch)


def time_kept_batches(batches, turns=1) -> tuple:
    """B1's and B2's own device time a call on each kept batch, ``turns``
    times, with the kernels of the code this process imports (this tree's,
    or in the --parent worker the parent's), and their outputs.  A batch the
    kernel refuses (ValueError: past its limits) is None."""
    from subzero_tpu_torch.geometry import regions, two_cross

    times, outs = {}, {}
    for name, args in batches.get("two_cross", {}).items():
        a = [x.cuda() for x in args]
        key = "two_cross/" + name
        try:
            outs[key] = [x.cpu() for x in two_cross.two_cross_cuda(*a)]
        except ValueError:
            times[key] = outs[key] = None
            continue
        buf = two_cross.alloc_output(a[4].shape[0], a[0].dtype, a[0].device)
        times[key] = [profiled_ms(lambda: two_cross.launch_into(buf, *a), B1_EVENT)
                      for _ in range(turns)]
    for name, (args, ssel, n_slow, cap) in batches.get("regions", {}).items():
        a = [x.cuda() for x in args]
        sel, ns = ssel.cuda(), n_slow.cuda()
        key = "regions/" + name
        try:
            got, bad = regions.regions_cuda(*a, sel, ns, cap, retry_cap())
        except ValueError:
            times[key] = outs[key] = None
            continue
        outs[key] = [x.cpu() for x in (*got, bad)]
        buf = regions.alloc_output(sel.shape[0], cap, a[0].dtype, a[0].device)
        times[key] = [profiled_ms(
            lambda: regions.launch_into(buf, *a, sel, ns, cap, retry_cap()), "regions_")
            for _ in range(turns)]
    return times, outs


def parent_worker(path: str) -> int:
    """Runs with an earlier checkout as the working directory: builds that
    checkout's kernels and times them, twice in a row, on the batches kept
    at ``path`` with this file's timing functions; saves their outputs
    beside it.  Prints one JSON object."""
    sys.path.insert(0, os.getcwd())
    from subzero_tpu_torch.geometry import regions, two_cross

    logs = [k.build(force=True)["log"] for k in (two_cross, regions)]
    times, outs = time_kept_batches(torch.load(path), turns=2)
    torch.save(outs, path + ".out")
    print(json.dumps({"times": times, "ptxas": [
        ln.strip() for log in logs for ln in log.splitlines()
        if "registers" in ln or "spill" in ln]}), flush=True)
    return 0


def kernels_vs_parent(parent_dir: str, report) -> dict:
    """Both kernels of this tree and of the checkout at ``parent_dir`` on
    the batches the phases kept, in turns: this tree, the parent twice (a
    process of its own code), this tree; each batch's own device time a
    call and kernels a call, and whether the outputs are equal to the bit
    (they must be, where the parent takes the batch: B1's first
    instantiation is the parent's code, and B2 equals its shim in both)."""
    batches = report["parent_batches"]
    first, ours = time_kept_batches(batches)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "batches.pt")
        torch.save(batches, path)
        env = dict(os.environ, PYTHONPATH=os.path.abspath(parent_dir))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent-worker", path],
            cwd=parent_dir, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"the kernels of {parent_dir} failed:\n"
                               + proc.stdout[-3000:] + proc.stderr[-3000:])
        parent = json.loads(proc.stdout.strip().splitlines()[-1])
        theirs = torch.load(path + ".out")
    last, _ = time_kept_batches(batches)
    out = {}
    for key, mine in ours.items():
        p = parent["times"][key]
        same = None
        if theirs[key] is not None:
            same = all(torch.equal(x, y) for x, y in zip(mine, theirs[key]))
            if not same:
                raise AssertionError(f"{key}: this tree's kernel and the parent's differ")
        out[key] = {"order": "this tree, parent, parent, this tree",
                    "ms": [first[key][0][0], *(t[0] for t in p or []), last[key][0][0]],
                    # each reading from a whole trace, the n-th taken
                    "trace_taken": [first[key][0][2], *(t[2] for t in p or []),
                                    last[key][0][2]],
                    "kernels_a_call": {"this_tree": first[key][0][1],
                                       "parent": p[0][1] if p else None},
                    "bitwise_equal": same}
    return dict(out, parent_ptxas=parent["ptxas"])


# a checkout's own bench on one configuration, in a process of its own: the
# field built once, then bench.measure twice; one JSON line
PARENT_BENCH = """
import json, sys, torch
from subzero_tpu_torch import bench
cfg = bench.CONFIGS[sys.argv[1]]
sim = bench.build_sim(cfg["n"], cfg["L"], bench.DX, bins=cfg["bins"], device="cuda")
out = []
for _ in range(2):
    r = bench.measure(sim, cfg["n_steps"])
    r["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    out.append(r)
print(json.dumps(out))
"""
BENCH_KEYS = ("step_ms", "pairs_per_s", "n_overflow", "peak_mem_gib",
              "peak_reserved_gib", "capture_s", "capture_pool_gib")


def bench_in_turns(parent_dir: str, dev) -> dict:
    """bench's five configurations, timed as the bench times them (best of
    its timed runs after a warm-up), this tree's and the checkout's at
    ``parent_dir`` (its own code) in turns in this call: this tree, the
    checkout twice (a process of its own code on its own field), this tree
    again.  step_ms and peak memory of each."""
    from subzero_tpu_torch import bench

    env = dict(os.environ, PYTHONPATH=os.path.abspath(parent_dir))
    out = {}
    for name, cfg in bench.CONFIGS.items():
        sim = bench.build_sim(cfg["n"], cfg["L"], bench.DX, bins=cfg["bins"], device=dev)
        ours = [bench.measure(sim, cfg["n_steps"])]
        torch.cuda.empty_cache()
        proc = subprocess.run([sys.executable, "-c", PARENT_BENCH, name],
                              cwd=os.path.abspath(parent_dir), env=env,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"the bench of {parent_dir} on {name} failed:\n"
                               + proc.stdout[-3000:] + proc.stderr[-3000:])
        parent = json.loads(proc.stdout.strip().splitlines()[-1])
        ours.append(bench.measure(sim, cfg["n_steps"]))
        out[name] = {
            "order": "this tree, parent, parent, this tree",
            "this_tree": [{k: r.get(k) for k in BENCH_KEYS} for r in ours],
            "parent": [{k: r.get(k) for k in BENCH_KEYS} for r in parent],
        }
        del sim
        torch.cuda.empty_cache()
    return out


_WARMUPS_AT_RESET = {"two_cross": 0, "regions": 0}


def b2_per_step() -> int:
    """The slow clip's launches in one timestep_collisions: one, the clip
    with its parity retry (pair_overlaps and pair_interactions make one
    without the retry)."""
    from subzero_tpu_torch.geometry import regions

    return regions.LAUNCHES_WITH_RETRY


def retry_cap() -> int:
    """The rows the step's parity retry takes (collisions.RETRY_CAP)."""
    from subzero_tpu_torch.physics import collisions

    return collisions.RETRY_CAP


def reset_launches() -> None:
    """Set the kernels' launch counts to 0 just before a path's run."""
    from subzero_tpu_torch import step_graph

    for k, mod in step_graph.KERNELS.items():
        mod.reset_launch_count()
        _WARMUPS_AT_RESET[k] = step_graph.warmup_launch_count(k)


def path_launches(kernel: str = "two_cross") -> int:
    """A kernel's launches since ``reset_launches`` that the path's steps,
    passes and writers made (``kernel``: "two_cross", B1, or "regions", B2):
    the count, less the launches of the step graphs' warm-ups (a StepGraph
    runs each program once eagerly, outputs dropped, before it captures it;
    those launches are real, and the kernels line reports them apart,
    ``graph_warmup_launches``)."""
    from subzero_tpu_torch import step_graph

    return step_graph.KERNELS[kernel].launch_count() - (
        step_graph.warmup_launch_count(kernel) - _WARMUPS_AT_RESET[kernel])


def b2_path(report, key: str, launches) -> None:
    """Record the slow clip's launches on a path for the kernels line."""
    report.setdefault("b2_launches_by_path", {})[key] = launches


def check_finite(sim) -> None:
    for name, tree in (("floes", sim.model.floes), ("ocean", sim.model.ocean)):
        for f, x in zip(tree._fields, tree):
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{name}.{f} is not finite")


def same_state(a, b, what) -> None:
    """Two runs' floes and ocean equal to the bit (of two Simulations, or
    their models)."""
    a, b = getattr(a, "model", a), getattr(b, "model", b)
    for name in ("floes", "ocean"):
        ta, tb = getattr(a, name), getattr(b, name)
        for f, x, y in zip(ta._fields, ta, tb):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: {name}.{f} differs between two runs")


def capture_steps(sim, n_steps) -> float:
    """Capture the programs of ``sim``'s first ``n_steps`` steps into the
    graphs ``sim`` keeps (each warmed up first); the seconds that took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = sim.step_graph()
    graph.prepare({graph.step_prog(t) for t in range(n_steps)})
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def replay_from(sim, n_steps, **kw):
    """run_scan of ``n_steps`` on ``sim`` itself, so that it replays the
    graphs ``sim`` keeps; returns the end model and puts ``sim``'s model
    back as it was."""
    from subzero_tpu_torch.simulation import run_scan

    m0 = sim.model
    run_scan(sim, n_steps, **kw)
    end, sim.model = sim.model, m0
    return end


# the names of each kernel's device functions, as torch.profiler lists them
KERNEL_EVENTS = {"two_cross": ("two_cross_kernel", "two_cross_wide_kernel"),
                 "regions": ("regions_kernel",), "forces": ("forces_kernel",),
                 "cell_clip": ("cell_clip_kernel",)}


def runs_under_replay(fn, n_expected, tries=3, kernel="two_cross") -> int:
    """A kernel's launches over ``fn`` (graph replays; the narrow phase's
    unless ``kernel`` names another), counted two ways: by its wrapper (a
    replay adds the launches its graph captured) and as the runs of its
    device functions the card made, by torch.profiler.  Both must be
    ``n_expected``; returns the card's count.  A trace now and then drops
    device events: such a trace is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from subzero_tpu_torch import step_graph

    mod, names = step_graph.KERNELS[kernel], KERNEL_EVENTS[kernel]
    torch.cuda.synchronize()
    for _ in range(tries):
        l0 = mod.launch_count()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counted = mod.launch_count() - l0
        if counted != n_expected:
            raise AssertionError(f"the wrapper of {kernel} counted {counted} launches, "
                                 f"expected {n_expected}")
        ran = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and any(k in e.key for k in names))
        if ran == n_expected:
            return ran
    raise AssertionError(f"the card ran {names} {ran} times in the last of "
                         f"{tries} traces; the wrapper counted {n_expected}")


def runs_per_replay(graph, kernel="two_cross") -> dict:
    """Each program a StepGraph captured, replayed once: the launches its
    replay adds to the wrapper's count, held against the card's runs of the
    kernel (runs_under_replay)."""
    return {"/".join(map(str, prog)): runs_under_replay(lambda: graph.replay(prog), n,
                                                      kernel=kernel)
            for prog, n in sorted(graph.captured_launches(kernel).items(), key=str)}


def run_timed(sim, n_steps):
    """run_scan of n_steps on the card, replaying a step graph captured
    before the clock starts; launch counts reset just before.  Returns the
    advanced sim and its numbers."""
    from subzero_tpu_torch.physics.collisions import find_candidate_pairs
    from subzero_tpu_torch.simulation import run_scan

    fl = sim.model.floes
    n_active = int(fl.count())
    pairs_per_step = int(find_candidate_pairs(fl, sim.model.domain,
                                              sim.pair_cap, sim.bins).valid.sum())
    capture_s = capture_steps(sim, n_steps)
    reset_launches()
    t0 = time.perf_counter()
    sim, _ = run_scan(sim, n_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, b2 = path_launches(), path_launches("regions")
    check_finite(sim)
    n_after = int(sim.model.floes.count())
    if launches != n_steps or b2 != b2_per_step() * n_steps:
        raise AssertionError(f"kernels launched {launches} (B1) and {b2} (B2) times "
                             f"in {n_steps} steps")
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
        "slow_clip_launches": b2,
        "capture_seconds": capture_s,
        "graph": sim.run_stats["graph"],
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
    cast to f64; keeps the batch for --parent."""
    from subzero_tpu_torch.geometry.clip import two_cross_pairs
    from subzero_tpu_torch.geometry.two_cross import two_cross_cuda

    args = nb.two_cross_args()
    valid = nb.pairs.valid
    got, ref = two_cross_cuda(*args), two_cross_pairs(*args)
    err32 = compare_two_cross(got, ref, False, valid)
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    err64 = compare_two_cross(two_cross_cuda(*a64), two_cross_pairs(*a64), True, valid)
    keep_for_parent(report, "two_cross", report_key, *args)
    return {"B": int(valid.shape[0]), "valid_pairs": int(valid.sum()),
            "two_crossing_ok": int(ref.ok.sum()),
            "max_abs_err_f32": err32, "max_abs_err_f64": err64,
            "f32_bitwise_equal": bitwise_report(got, ref)}


def phase_kernel(dev, report):
    from subzero_tpu_torch.geometry.clip import two_cross_pairs
    from subzero_tpu_torch.geometry.two_cross import two_cross_cuda
    from subzero_tpu_torch.physics.collisions import narrow_phase_batch
    from subzero_tpu_torch.simulation import run_scan

    synthetic, wide = {}, {}
    for dtype, V in ((np.float32, 16), (np.float64, 16), (np.float32, 32), (np.float64, 32),
                     (np.float32, WIDE_V), (np.float64, WIDE_V)):
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
        if dtype == np.float32 and V in (32, WIDE_V):
            # rings of 32 vertices (the first instantiation) against 40 (the
            # wide one) on lists of one size
            wide[name] = time_kernel(args)
            keep_for_parent(report, "two_cross", f"synthetic {name}", *args)
    report["timing_wide"] = wide[f"float32_V{WIDE_V}"]

    # the pair list the main path gives the kernel: shear_flow_500 after 20 steps
    sim, _ = run_scan(build_sim(500, 1e5, 2e3, device=dev, dtype=torch.float32), 20)
    nb = narrow_phase_batch(sim.model.floes, sim.model.domain, sim.pair_cap)
    main_path = check_main_path_batch(nb, "shear_flow_500", report)
    timing = time_kernel(nb.two_cross_args())
    report.update(max_abs_err=main_path["max_abs_err_f32"], timing=timing)
    emit("kernel", synthetic_max_abs_err=synthetic, main_path=main_path,
         timing=timing, synthetic_timing=wide)


def phase_slice(dev, report):
    sim = build_sim(500, 1e5, 2e3, device=dev, dtype=torch.float32)
    from subzero_tpu_torch.simulation import run_scan

    run_scan(fork(sim), 5)  # warm-up: allocator, cuBLAS handles
    _, nums = run_timed(sim, 200)
    report["launches"] = nums["kernel_launches"]
    report["launches_by_path"]["run_scan step (slice)"] = nums["kernel_launches"]
    report["b2_launches"] = nums["slow_clip_launches"]
    b2_path(report, "run_scan step (slice)", nums["slow_clip_launches"])
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
    same_state(a, b, "shear_flow_500")
    emit("determinism", config="shear_flow_500", dtype="float32", n_steps=50,
         bitwise_equal=True)


def phase_many_floes(dev, report):
    from subzero_tpu_torch.physics.collisions import narrow_phase_batch
    from subzero_tpu_torch.simulation import run_scan

    sim = build_sim(2000, 2e5, 2e3, device=dev, dtype=torch.float32)
    nb = narrow_phase_batch(sim.model.floes, sim.model.domain, sim.pair_cap)
    check = check_main_path_batch(nb, "many_floes_2000", report)
    timing = time_kernel(nb.two_cross_args())
    run_scan(fork(sim), 5)  # warm-up
    _, nums = run_timed(sim, 50)
    emit("many_floes_2000", dtype="float32", kernel_timing=timing,
         kernel_check=check, **nums)


def canonical_pairs(pairs, N):
    """The valid rows of a candidate list as sorted canonical rows (i, j,
    shift x, shift y): a floe-floe pair is turned so that i < j, its shift
    negated with it (tests/test_binned.py).  Raises on a duplicate."""
    v = pairs.valid.cpu().numpy()
    qi = pairs.qi.cpu().numpy()[v].astype(np.int64)
    qj = pairs.qj.cpu().numpy()[v].astype(np.int64)
    sh = np.round(pairs.shift.cpu().numpy()[v].astype(np.float64), 3) + 0.0
    turn = (qj < N) & (qj < qi)
    i = np.where(turn, qj, qi)
    j = np.where(turn, qi, qj)
    sh = np.where(turn[:, None], -sh + 0.0, sh)
    rows = np.stack([i, j, sh[:, 0], sh[:, 1]], axis=1)
    rows = rows[np.lexsort(rows.T[::-1])]
    uniq = np.unique(rows, axis=0)
    if len(uniq) != len(rows):
        raise AssertionError(f"{len(rows) - len(uniq)} candidate pairs listed twice")
    return rows


def phase_binned(dev, report):
    from subzero_tpu_torch.physics.collisions import (find_candidate_pairs,
                                                      narrow_phase_batch)
    from subzero_tpu_torch.simulation import run_scan

    t0 = time.perf_counter()
    sim = build_sim(8000, 4e5, 2e3, device=dev, dtype=torch.float32, bins=True)
    setup_s = time.perf_counter() - t0
    fl, dom = sim.model.floes, sim.model.domain
    N = fl.capacity
    dense_sim = dataclasses.replace(sim, bins=None)

    # step 0: the same canonical pairs, once each, from both broad phases
    binned = find_candidate_pairs(fl, dom, sim.pair_cap, sim.bins)
    dense = find_candidate_pairs(fl, dom, sim.pair_cap, None)
    if bool(binned.overflow) or bool(dense.overflow):
        raise AssertionError("broad phase overflowed at step 0")
    rows_b, rows_d = canonical_pairs(binned, N), canonical_pairs(dense, N)
    if rows_b.shape != rows_d.shape or not np.array_equal(rows_b, rows_d):
        raise AssertionError(
            f"binned and dense candidate lists differ: {len(rows_b)} vs {len(rows_d)} pairs")
    nb = narrow_phase_batch(fl, dom, sim.pair_cap, sim.bins)
    check = check_main_path_batch(nb, "many_floes_8000", report)
    timing = time_kernel(nb.two_cross_args())
    counters = counters_card_vs_cpu(sim)
    report["launches_by_path"]["timestep_collisions with_debug (counters, many_floes_8000)"] = \
        counters["kernel_launches"]
    b2_path(report, "timestep_collisions with_debug (counters, many_floes_8000)",
            counters["slow_clip_launches"])

    run_scan(fork(sim), 3)  # warm-up
    _, nums = run_timed(fork(sim), 50)
    if nums["n_overflow"]:
        raise AssertionError(f"{nums['n_overflow']} overflow steps on many_floes_8000")
    report["launches_by_path"]["run_scan step (binned)"] = nums["kernel_launches"]
    b2_path(report, "run_scan step (binned)", nums["slow_clip_launches"])

    # dense against binned, in turns (host time drifts within a call); each
    # run replays the graphs its Simulation captured in the warm-up
    def ms(s, n=30):
        torch.cuda.synchronize()
        t = time.perf_counter()
        replay_from(s, n)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n

    replay_from(sim, 3)
    replay_from(dense_sim, 3)
    step_ms_8000 = {"binned": [], "dense": []}
    for _ in range(2):
        step_ms_8000["binned"].append(ms(sim))
        step_ms_8000["dense"].append(ms(dense_sim))
    small = build_sim(2000, 2e5, 2e3, device=dev, dtype=torch.float32)
    small_binned = build_sim(2000, 2e5, 2e3, device=dev, dtype=torch.float32, bins=True)
    replay_from(small, 3)
    replay_from(small_binned, 3)
    step_ms_2000 = {"binned": [], "dense": []}
    for _ in range(2):
        step_ms_2000["binned"].append(ms(small_binned))
        step_ms_2000["dense"].append(ms(small))
    emit("binned", config="many_floes_8000", dtype="float32",
         host_setup_seconds=setup_s, bins=list(sim.bins), pair_cap=sim.pair_cap,
         canonical_pairs_step0=int(len(rows_b)), binned_equals_dense=True,
         narrow_phase_rows=int(nb.pairs.qi.shape[0]),
         narrow_phase_valid_pairs=int(nb.pairs.valid.sum()),
         dense_rows=int(dense.qi.shape[0]), kernel_check=check,
         step_0_counters_card_vs_cpu=counters,
         kernel_timing=timing,
         step_ms_many_floes_8000=step_ms_8000,
         bins_many_floes_2000=list(small_binned.bins),
         step_ms_many_floes_2000=step_ms_2000, **nums)


def sorted_valid_rows(cols, valid, keys):
    """The valid rows of some device columns on the host, sorted by the
    ``keys`` columns (exact partner codes first, then a coordinate)."""
    v = valid.cpu().numpy()
    host = {k: c.cpu().numpy()[v].astype(np.float64) for k, c in cols.items()}
    order = np.lexsort([np.round(host[k], 3) for k in reversed(keys)])
    return {k: a[order] for k, a in host.items()}


def compare_rows(card, cpu, exact, close, f64: bool) -> dict:
    """Rows of the card against the CPU copy: the ``exact`` columns equal,
    the ``close`` ones within the kernel-vs-plain tolerance of their kind,
    relative to the column's largest magnitude.  Returns the largest
    relative difference by column."""
    for k in exact:
        if card[k].shape != cpu[k].shape or not np.array_equal(card[k], cpu[k]):
            raise AssertionError(
                f"{k}: the card's valid rows differ from the CPU's "
                f"({len(card[k])} vs {len(cpu[k])} rows)")
    rtol, atol = (F64_TOL if f64 else F32_TOL)["area"]
    worst = {}
    for k in close:
        if cpu[k].size == 0:  # no row at all (a field whose floes only touch)
            worst[k] = 0.0
            continue
        scale = float(np.abs(cpu[k]).max())
        err = np.abs(card[k] - cpu[k])
        if not (err <= atol * max(scale, 1.0) + rtol * np.abs(cpu[k])).all():
            raise AssertionError(f"{k}: card vs CPU beyond rtol {rtol}; max abs err "
                                 f"{float(err.max())} at scale {scale}")
        worst[k] = float(err.max()) / scale if scale > 0 else float(err.max())
    return worst


def drop_borderline_rows(card, cpu, nverts, f64: bool):
    """Contact rows of one (i, j) pair that the card and the CPU list in
    different numbers.  Past the kernel both sides run the same plain
    PyTorch, whose sums differ in their last bits between the card and the
    CPU, and two gates in it are discrete: the general clip keeps or drops a
    region whose area is roundoff of the coordinates, and the force law
    drops a region below min(nverts_i, nverts_j) * 100 / 1.75 in area
    (collisions.py:_region_forces).  Such a pair's rows are taken out of both
    sides and returned apart, and the surplus must be of that kind: every
    region of the longer side beyond the shorter side's count (nearest to
    the gate first) within the area tolerance of zero (at the scale of the
    list's largest overlap) or of the gate.  Returns (card, cpu, the pairs
    taken out)."""
    rtol, atol = (F64_TOL if f64 else F32_TOL)["area"]
    key = lambda rows: list(zip(rows["i"].astype(np.int64), rows["j"].astype(np.int64)))
    kc, kh = key(card), key(cpu)
    count = lambda ks: {k: ks.count(k) for k in set(ks)}
    nc, nh = count(kc), count(kh)
    odd = {k for k in set(nc) | set(nh) if nc.get(k, 0) != nh.get(k, 0)}
    scale = max(float(np.abs(cpu["overlap"]).max()) if cpu["overlap"].size else 0.0, 1.0)
    taken = []
    for k in sorted(odd):
        gate = min(int(nverts[k[0]]), int(nverts[k[1]]) if k[1] >= 0 else 4) * 100.0 / 1.75
        oc = card["overlap"][[x == k for x in kc]]
        oh = cpu["overlap"][[x == k for x in kh]]
        longer = oc if len(oc) > len(oh) else oh
        off = np.minimum(np.abs(longer), np.abs(longer - gate))
        surplus = np.sort(off)[:abs(len(oc) - len(oh))]
        if not (surplus <= atol * scale + rtol * max(scale, gate)).all():
            raise AssertionError(
                f"pair {k}: the card lists regions of overlap {oc.tolist()}, the CPU "
                f"{oh.tolist()}; the surplus lies neither at zero (scale {scale}) nor at "
                f"the min-area gate {gate}")
        taken.append({"i": int(k[0]), "j": int(k[1]), "min_area_gate": gate,
                      "overlap_card": oc.tolist(), "overlap_cpu": oh.tolist()})
    keep_c = np.array([x not in odd for x in kc], bool)
    keep_h = np.array([x not in odd for x in kh], bool)
    return ({k: v[keep_c] for k, v in card.items()},
            {k: v[keep_h] for k, v in cpu.items()}, taken)


def cpu_copy(floes, domain):
    """A pool and its domain moved to the CPU."""
    return floes.to("cpu"), dataclasses.replace(
        domain, vals=domain.vals.cpu(), velocities=domain.velocities.cpu(),
        topography=type(domain.topography)(*(x.cpu() for x in domain.topography)))


# timestep_collisions' result card against CPU, f32, on a step-0 pool: the
# flags and marks exactly, the sums within this fraction of their largest
# magnitude (the kernel equals its plain version to the bit; the plain
# PyTorch around it may add in another order)
COUNTERS_RESULT_TOL = 1e-4


def counters_card_vs_cpu(sim) -> dict:
    """``timestep_collisions(..., with_debug=True)`` on the state of ``sim``
    on the card (kernel, one launch) against a CPU copy (plain versions):
    every counter of the JAX package's dict exactly equal (integers and
    flags), and the result as the step uses it (forces, torques, overlap
    and stress within COUNTERS_RESULT_TOL of their largest; overflow,
    removal and fuse marks exactly)."""
    from subzero_tpu_torch.physics.collisions import timestep_collisions

    t0 = time.perf_counter()
    fl, dom = sim.model.floes, sim.model.domain
    args = (sim.consts, float(sim.dt), sim.collision_settings, sim.pair_cap,
            sim.clip_cap, sim.bins)
    reset_launches()
    card, dbg = timestep_collisions(fl, dom, *args, with_debug=True)
    launches, b2 = path_launches(), path_launches("regions")
    cpu, cdbg = timestep_collisions(*cpu_copy(fl, dom), *args, with_debug=True)
    got = {k: v.item() for k, v in dbg.items()}
    want = {k: v.item() for k, v in cdbg.items()}
    if got != want or launches != 1 or b2 != b2_per_step():
        raise AssertionError(f"counters card {got} vs CPU {want}; {launches} (B1) and "
                             f"{b2} (B2) launches")
    if bool(card.overflow) != bool(cpu.overflow):
        raise AssertionError("overflow flag differs between the card and the CPU")
    for f in ("remove", "fuse_with"):
        if not torch.equal(getattr(card.floes, f).cpu(), getattr(cpu.floes, f)):
            raise AssertionError(f"floes.{f} differs between the card and the CPU")
    diffs = {f: max_rel_diff(getattr(card.floes, f), getattr(cpu.floes, f))
             for f in ("collision_force", "collision_trq", "overarea")}
    diffs["stress_instant"] = max_rel_diff(card.stress_instant, cpu.stress_instant)
    if not max(diffs.values()) <= COUNTERS_RESULT_TOL:
        raise AssertionError(f"timestep_collisions card vs CPU beyond "
                             f"{COUNTERS_RESULT_TOL}: {diffs}")
    return {"counters": got, "result_max_rel_diff": diffs,
            "tolerance": COUNTERS_RESULT_TOL, "kernel_launches": launches,
            "slow_clip_launches": b2, "seconds": time.perf_counter() - t0}


def overlaps_card_vs_cpu(sim, f64: bool, bins=None, full_ok=False) -> dict:
    """pair_overlaps and pair_interactions on the state of ``sim`` on the
    card (kernel) against the same functions on a CPU copy of it (plain
    versions): the same valid rows and partners, areas and forces within the
    kernel-vs-plain tolerance.  The kernel's launches are counted from 0
    around each call on the card and must be one each.  A query that ran out
    of capacity fails the check, unless ``full_ok`` (the crowded pool a
    life-cycle run leaves): then it must have run out on both sides, the
    rows it kept are compared, and a pair with a region that only one side
    lists is reported apart (drop_borderline_rows)."""
    from subzero_tpu_torch.physics.collisions import pair_interactions, pair_overlaps

    fl, dom = sim.model.floes, sim.model.domain
    fl_cpu, dom_cpu = cpu_copy(fl, dom)

    reset_launches()
    i, j, area, valid, ovf = pair_overlaps(fl, dom, sim.pair_cap, sim.clip_cap, bins)
    n_po, b2_po = path_launches(), path_launches("regions")
    ci, cj, carea, cvalid, covf = pair_overlaps(fl_cpu, dom_cpu, sim.pair_cap,
                                                sim.clip_cap, bins)
    if bool(ovf) != bool(covf) or (bool(ovf) and not full_ok):
        raise AssertionError(f"pair_overlaps overflowed: card {bool(ovf)}, CPU {bool(covf)}")
    po = compare_rows(
        sorted_valid_rows({"i": i, "j": j, "area": area}, valid, ("i", "j")),
        sorted_valid_rows({"i": ci, "j": cj, "area": carea}, cvalid, ("i", "j")),
        ("i", "j"), ("area",), f64)

    reset_launches()
    rows = pair_interactions(fl, dom, sim.consts, float(sim.dt), sim.pair_cap,
                             sim.clip_cap, bins)
    n_pi, b2_pi = path_launches(), path_launches("regions")
    crows = pair_interactions(fl_cpu, dom_cpu, sim.consts, float(sim.dt),
                              sim.pair_cap, sim.clip_cap, bins)
    if bool(rows["overflow"]) != bool(crows["overflow"]) or (
            bool(rows["overflow"]) and not full_ok):
        raise AssertionError(f"pair_interactions overflowed: card {bool(rows['overflow'])}, "
                             f"CPU {bool(crows['overflow'])}")
    cols = ("i", "j", "px", "fx", "fy", "py", "torque", "overlap")
    card_rows = sorted_valid_rows({k: rows[k] for k in cols}, rows["valid"], ("i", "j", "px"))
    cpu_rows = sorted_valid_rows({k: crows[k] for k in cols}, crows["valid"], ("i", "j", "px"))
    borderline = []
    if full_ok:
        card_rows, cpu_rows, borderline = drop_borderline_rows(
            card_rows, cpu_rows, fl_cpu.nverts.numpy(), f64)
    pi = compare_rows(card_rows, cpu_rows, ("i", "j"), cols[2:], f64)
    if n_po != 1 or n_pi != 1 or b2_po != 1 or b2_pi != 1:
        raise AssertionError(f"kernel launches: pair_overlaps {n_po} (B1), {b2_po} "
                             f"(B2), pair_interactions {n_pi}, {b2_pi}; expected 1 each")
    return {
        "overlap_rows": int(valid.sum()), "interaction_rows": int(rows["valid"].sum()),
        "pair_overlaps_max_rel_diff": po, "pair_interactions_max_rel_diff": pi,
        "overflowed": {"pair_overlaps": bool(ovf), "pair_interactions": bool(rows["overflow"])},
        "pairs_with_a_borderline_region_on_one_side": borderline,
        "kernel_launches": {"pair_overlaps": n_po, "pair_interactions": n_pi},
        "slow_clip_launches": {"pair_overlaps": b2_po, "pair_interactions": b2_pi},
    }


def phase_overlaps(dev, report):
    from subzero_tpu_torch.simulation import run_scan

    out = {}
    n_po = n_pi = 0
    for dtype, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        sim, _ = run_scan(build_sim(500, 1e5, 2e3, device=dev, dtype=dtype), 100)
        out[name] = overlaps_card_vs_cpu(sim, dtype == torch.float64, sim.bins)
        if out[name]["overlap_rows"] == 0 or out[name]["interaction_rows"] == 0:
            raise AssertionError("no overlapping pair after 100 steps")
        n_po += out[name]["kernel_launches"]["pair_overlaps"]
        n_pi += out[name]["kernel_launches"]["pair_interactions"]
    by_path = report["launches_by_path"]
    by_path["pair_overlaps (overlaps phase)"] = n_po
    by_path["pair_interactions (overlaps phase)"] = n_pi
    for q in ("pair_overlaps", "pair_interactions"):
        b2_path(report, f"{q} (overlaps phase)",
                sum(v["slow_clip_launches"][q] for v in out.values()))
    # the overflow flag's counters on the step-0 pool, card against CPU
    counters = counters_card_vs_cpu(build_sim(500, 1e5, 2e3, device=dev, dtype=torch.float32))
    by_path["timestep_collisions with_debug (counters, shear_flow_500)"] = \
        counters["kernel_launches"]
    b2_path(report, "timestep_collisions with_debug (counters, shear_flow_500)",
            counters["slow_clip_launches"])
    emit("overlaps", config="shear_flow_500 after 100 steps",
         tolerance={"float32": F32_TOL["area"], "float64": F64_TOL["area"]},
         step_0_counters_card_vs_cpu=counters, **out)


def count_host_syncs(fn, top=10):
    """Run ``fn`` with PyTorch's synchronisation warnings on and count them
    by the source line that made them: every blocking read of the device by
    the host (item, tolist, cpu, a boolean test or a boolean index of a
    tensor, nonzero) and every blocking copy to it.  Launches through ctypes
    are not seen.  Returns (fn's result, count, the ``top`` largest sources;
    None: all)."""
    import collections

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    by = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in rec
        if "synchroniz" in str(w.message))
    return out, sum(by.values()), dict(by.most_common(top))


class PoolTransfers:
    """Counts and times the pool's crossings between the card and the host
    while the block runs: every ``HostFloes(floes)`` (a pull, which also
    waits for the device to finish the steps queued before it) and every
    ``HostFloes.to_state()`` (a push)."""

    def __enter__(self):
        from subzero_tpu_torch.physics.lifecycle_host import HostFloes

        self.cls = HostFloes
        self.saved = (HostFloes.__init__, HostFloes.to_state)
        self.stats = {"pulls": 0, "pull_seconds": 0.0, "pushes": 0, "push_seconds": 0.0}

        def timed(fn, count, seconds):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.stats[count] += 1
                self.stats[seconds] += time.perf_counter() - t0
                return out
            return wrapper

        HostFloes.__init__ = timed(self.saved[0], "pulls", "pull_seconds")
        HostFloes.to_state = timed(self.saved[1], "pushes", "push_seconds")
        return self.stats

    def __exit__(self, *exc):
        self.cls.__init__, self.cls.to_state = self.saved
        return False


def lifecycle_checks(sim, mass0, id0):
    """What a life-cycle run must leave behind; returns its figures."""
    fs = sim.floe_settings
    fl = sim.model.floes
    act = fl.active
    check_finite(sim)
    max_id = int(fl.id.max())
    if max_id <= id0:
        raise AssertionError("no floe was created: the topology did not change")
    h = fl.height[act]
    if not (bool((h >= fs.min_floe_height - 1e-6).all())
            and bool((h <= fs.max_floe_height + 1e-6).all())):
        raise AssertionError(f"heights outside [{fs.min_floe_height}, "
                             f"{fs.max_floe_height}]: {float(h.min())}..{float(h.max())}")
    mass = float(fl.mass[act].double().sum()) + float(sim.model.ocean.dissolved.double().sum())
    if not mass <= mass0 * (1 + 1e-6):
        raise AssertionError(f"floe mass + dissolved {mass} above the initial {mass0}")
    return {"active_floes": int(act.sum()), "max_floe_id": max_id,
            "mass_over_initial": mass / mass0}


def lifecycle_batch_checks(sim, key, report) -> dict:
    """On the pool of a life-cycle run, at its full width: the step's
    narrow-phase batch through the kernel and its plain version, and
    pair_overlaps / pair_interactions on the card against a CPU copy (a full
    pool may run these queries out of capacity, as it does inside the run,
    which counts it in n_overflow)."""
    from subzero_tpu_torch.physics.collisions import narrow_phase_batch

    nb = narrow_phase_batch(sim.model.floes, sim.model.domain, sim.pair_cap, sim.bins)
    return {"step_batch": check_main_path_batch(nb, key, report),
            "overlap_queries": overlaps_card_vs_cpu(sim, False, sim.bins, full_ok=True)}


def phase_lifecycle(dev, report):
    from subzero_tpu_torch import native
    from subzero_tpu_torch.simulation import run

    n_dt = LIFECYCLE_N_DT
    base = build_many_floes(1000, device=dev, dtype=torch.float32, n_dt=n_dt)
    fl0 = base.model.floes
    mass0 = float(fl0.mass[fl0.active].double().sum())
    id0 = int(fl0.id.max())
    batches = {"step_0": lifecycle_batch_checks(base, "many_floes_lifecycle_step_0", report)}
    warm = fork(base)
    warm.n_dt = 5
    run(warm)

    runs = []
    for _ in range(2):
        sim = fork(base)
        with PoolTransfers() as transfers, warnings.catch_warnings():
            warnings.simplefilter("ignore")  # overflow and pool-full notes
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            sim = run(sim)
            launches = (path_launches(), path_launches("regions"))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        runs.append((sim, seconds, launches, transfers))
    (a, seconds, (launches, b2), transfers), (b, seconds_b, _, _) = runs
    report["lifecycle_run"] = a  # the graph phase holds it against eager steps
    for f, x, y in zip(a.model.floes._fields, a.model.floes, b.model.floes):
        if not torch.equal(x, y):
            raise AssertionError(f"floes.{f} differs between two runs from one seed")
    figures = lifecycle_checks(a, mass0, id0)
    st = a.run_stats
    by, by2 = (st["host_pass_launches"][k] for k in ("two_cross", "regions"))
    step_launches, step_b2 = launches - sum(by.values()), b2 - sum(by2.values())
    # B1 once a step and once a host-pass query; B2 (the slow clip) its
    # launches a step (clip and retry) and once a query; each as measured
    n_rr = st["host_pass_count"]["ridge_raft"]
    if step_launches != st["steps"] or by["ridge_raft"] != n_rr:
        raise AssertionError(f"kernel launches: step {step_launches} in {st['steps']} "
                             f"steps, host passes {by} of {st['host_pass_count']}")
    if step_b2 != b2_per_step() * st["steps"] or by2 != by:
        raise AssertionError(f"slow clip launches: step {step_b2} in {st['steps']} "
                             f"steps, host passes {by2} of {st['host_pass_count']}")
    b2_path(report, "run step (lifecycle)", step_b2)
    b2_path(report, "pair_overlaps (lifecycle ridge/raft)", by2["ridge_raft"])
    by_path = report["launches_by_path"]
    by_path["run step (lifecycle)"] = step_launches
    by_path["pair_overlaps (lifecycle ridge/raft)"] = by["ridge_raft"]
    batches["after_the_run"] = lifecycle_batch_checks(
        a, "many_floes_lifecycle_after_the_run", report)
    for q in ("pair_overlaps", "pair_interactions"):
        by_path[f"{q} (lifecycle, held against the CPU)"] = sum(
            v["overlap_queries"]["kernel_launches"][q] for v in batches.values())

    # host synchronisations a step: a third, shorter run under sync warnings
    short = fork(base)
    short.n_dt = 99
    short, syncs, sync_sources = count_host_syncs(lambda: run(short))
    # and of device steps alone: 50 steps of run_scan on the same field
    from subzero_tpu_torch.simulation import run_scan

    _, scan_syncs, scan_sources = count_host_syncs(lambda: run_scan(fork(base), 50))
    host_s = sum(st["host_pass_seconds"].values())
    emit("lifecycle", config="examples/many_floes.py, 1000 floes in a pool of 2000",
         dtype="float32", n_dt=n_dt, steps=st["steps"], seconds=seconds,
         seconds_second_run=seconds_b, step_ms=1e3 * seconds / st["steps"],
         device_steps_seconds=seconds - host_s,
         host_pass_seconds=st["host_pass_seconds"],
         host_pass_count=st["host_pass_count"], segments=st["segments"],
         pool_transfers=transfers,
         host_syncs_per_step_first_100_steps=syncs / short.run_stats["steps"],
         host_sync_sources_first_100_steps=sync_sources,
         host_syncs_per_step_run_scan_50_steps=scan_syncs / 50,
         host_sync_sources_run_scan_50_steps=scan_sources,
         host_pass_count_first_100_steps=short.run_stats["host_pass_count"],
         kernel_launches={"step": step_launches, "pair_overlaps": by["ridge_raft"],
                          "pair_interactions": by["fracture"]},
         slow_clip_launches=b2,
         kernel_and_queries_vs_plain=batches,
         n_overflow=a.n_overflow, bitwise_equal_second_run=True,
         native_clip_served=native.available(), **figures)


# the step graph against the same steps launched eagerly, bitwise (f32)
GRAPH_CONFIGS = {"shear_flow_500": dict(n=500, L=1e5, bins=False, n_steps=200),
                 "many_floes_8000": dict(n=8000, L=4e5, bins=True, n_steps=50)}
GRAPH_SYNC_STEPS = 50
GRAPH_PROFILE_STEPS = 20
# where a step reads nothing on the host any more (their lines must not show
# among a life-cycle run's synchronisations)
STEP_BODY_FILES = ("physics/collisions.py", "physics/coupling.py",
                   "physics/update_floe.py", "physics/simplification.py",
                   "geometry/clip.py", "geometry/two_cross.py", "geometry/regions.py",
                   "core/domain.py", "step_graph.py")


def graph_against_eager(sim, name) -> dict:
    """run_scan of the configuration's steps from one state, replaying the
    step's graph (captured before the clock starts) and launching the same
    steps eagerly (``_eager``): end states equal to the bit, one kernel
    launch a step on each side; ms a step of each.  Then the graph's run
    again under torch.profiler: the card ran the kernel once a step, as the
    wrapper's count says."""
    from subzero_tpu_torch.simulation import build_step, run_scan

    n = GRAPH_CONFIGS[name]["n_steps"]
    # a synchronisation inside the step raises here, before any capture
    step, m = build_step(sim), sim.model
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in (0, 1):  # the coupling step and the plain step
            step(m.floes, m.ocean, m.domain, t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    capture_s = capture_steps(sim, n)
    graph = sim.step_graph()
    out = {"n_steps": n, "capture_seconds": capture_s,
           "captures": graph.stats["captures"],
           "capture_pool_gib": {"/".join(map(str, p)): b / 2**30
                                for p, b in graph.capture_pool_bytes.items()}}
    # B6: one launch on each coupled step, none on the others
    n_coupled = sum(graph.couples(t) for t in range(n))
    ends = {}
    for how in ("graph", "eager"):
        reset_launches()
        t0 = time.perf_counter()
        if how == "graph":
            end = replay_from(sim, n)
        else:
            end = run_scan(fork(sim), n, _eager=True)[0].model
        torch.cuda.synchronize()
        out[f"{how}_step_ms"] = 1e3 * (time.perf_counter() - t0) / n
        if (path_launches() != n or path_launches("regions") != b2_per_step() * n
                or path_launches("forces") != n
                or path_launches("cell_clip") != n_coupled):
            raise AssertionError(f"{name} ({how}): {path_launches()} (B1), "
                                 f"{path_launches('regions')} (B2), "
                                 f"{path_launches('forces')} (B4) and "
                                 f"{path_launches('cell_clip')} (B6) launches in {n} "
                                 f"steps, {n_coupled} of them coupled")
        ends[how] = end
    same_state(ends["graph"], ends["eager"], f"{name}: graph against eager")
    if not torch.equal(ends["graph"].domain.vals, ends["eager"].domain.vals):
        raise AssertionError(f"{name}: domain differs between graph and eager")
    out["kernel_runs_on_the_card"] = runs_under_replay(lambda: replay_from(sim, n), n)
    out["slow_clip_runs_on_the_card"] = runs_under_replay(
        lambda: replay_from(sim, n), b2_per_step() * n, kernel="regions")
    out["force_law_runs_on_the_card"] = runs_under_replay(
        lambda: replay_from(sim, n), n, kernel="forces")
    out["cell_clip_runs_on_the_card"] = runs_under_replay(
        lambda: replay_from(sim, n), n_coupled, kernel="cell_clip")
    if graph.stats["captures"] != out["captures"]:
        raise AssertionError(f"{name}: run_scan captured again: {graph.stats}")
    out.update(bitwise_equal=True, kernel_launches_per_step=1,
               slow_clip_launches_per_step=b2_per_step(),
               recaptures=graph.stats["recaptures"],
               kernel_runs_per_replay=runs_per_replay(graph),
               slow_clip_runs_per_replay=runs_per_replay(graph, "regions"),
               force_law_runs_per_replay=runs_per_replay(graph, "forces"),
               coupled_steps=n_coupled,
               cell_clip_runs_per_replay=runs_per_replay(graph, "cell_clip"))
    return out


def launch_profile(fn, n) -> dict:
    """torch.profiler over ``fn`` (n steps): the host's CUDA launch calls a
    step by name (kernel launches and graph launches), and the device's
    kernels a step, their busy time and the slow clip kernels' share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    api = {e.key: e.count / n for e in avgs
           if e.key.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch"))}
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    b2 = [e for e in kernels if any(k in e.key for k in KERNEL_EVENTS["regions"])]
    return {"host_launch_calls_per_step": api,
            "device_kernels_per_step": sum(e.count for e in kernels) / n,
            "device_busy_ms_per_step": busy_ms / n,
            "slow_clip_device_ms_per_step": sum(dev_us(e) for e in b2) / 1e3 / n,
            "wall_ms_per_step_profiled": wall_ms / n,
            "device_busy_share": busy_ms / wall_ms}


def coupling_clip_widths_card(sim) -> dict:
    """The coupling's cell clip (B6 on the card) on 16 vertex slots against
    the full width (the step takes the full width; the JAX package picks 16
    slots by a lax.cond when every ring fits)."""
    from subzero_tpu_torch.physics import coupling as C

    m = sim.model
    verts, nverts, *rects = C.window_inputs(m.floes, m.grid, m.domain, sim.cell_cap)
    full = C._cell_areas(verts, nverts, *rects)
    narrow = C._cell_areas(verts[:, :16], nverts, *rects)
    return {"largest_ring": int(nverts.max()), "bitwise_equal": torch.equal(full, narrow),
            "max_abs_diff": float((full - narrow).abs().max())}


def phase_graph(dev, report):
    """The step as a CUDA graph (subzero_tpu_torch/step_graph.py) against
    the same steps launched eagerly: shear_flow_500 (200 steps) and
    many_floes_8000 binned (50 steps) through run_scan, and the life-cycle
    run (601 steps of run, with slow pairs, parity retries and fuse passes),
    bitwise in f32; host synchronisations between run_scan's first and last
    step (none) and a life-cycle run's by source line; host launch calls
    and device kernels a step by torch.profiler."""
    from subzero_tpu_torch import tracing
    from subzero_tpu_torch.simulation import run, run_scan

    out = {}
    for name, cfg in GRAPH_CONFIGS.items():
        sim = build_sim(cfg["n"], cfg["L"], 2e3, device=dev, dtype=torch.float32,
                        bins=cfg["bins"])
        out[name] = graph_against_eager(sim, name)
        # the card's own count of the kernel's runs under replay
        report["launches_by_path"][f"run_scan step, graph replay (graph, {name})"] = \
            out[name]["kernel_runs_on_the_card"]
        report["runs_on_the_card"][f"{name}'s programs, one replay each"] = \
            out[name]["kernel_runs_per_replay"]
        b2_path(report, f"run_scan step, graph replay (graph, {name})",
                out[name]["slow_clip_runs_on_the_card"])
        report.setdefault("b2_runs_on_the_card", {})[
            f"{name}'s programs, one replay each"] = out[name]["slow_clip_runs_per_replay"]
        report.setdefault("b6_launches_by_path", {})[
            f"run_scan step, graph replay (graph, {name})"] = \
            out[name]["cell_clip_runs_on_the_card"]
        report.setdefault("b6_runs_on_the_card", {})[
            f"{name}'s programs, one replay each"] = out[name]["cell_clip_runs_per_replay"]
        if name == "shear_flow_500":
            # between run_scan's first and last step nothing is read: the one
            # read is the marks' buffer's (n_overflow with the counters),
            # after the last step, in tracing.py, whose only read of the
            # card is that one (Marks.read)
            end_file = os.path.relpath(tracing.__file__)
            _, syncs, sources = count_host_syncs(
                lambda: replay_from(sim, GRAPH_SYNC_STEPS), top=None)
            within = syncs - sum(n for src, n in sources.items()
                                 if src.rsplit(":", 1)[0] == end_file)
            if within != 0 or syncs > 1:
                raise AssertionError(f"run_scan read the device {within} times between "
                                     f"its first and last step: {sources}")
            _, e_syncs, e_sources = count_host_syncs(
                lambda: run_scan(fork(sim), GRAPH_SYNC_STEPS, _eager=True), top=None)
            n = GRAPH_PROFILE_STEPS
            out[name].update(
                run_scan_syncs={"steps": GRAPH_SYNC_STEPS, "graph": syncs,
                                "graph_between_first_and_last_step": within,
                                "graph_sources": sources, "eager": e_syncs,
                                "eager_sources": e_sources},
                profile={"graph": launch_profile(lambda: replay_from(sim, n), n),
                    "eager": launch_profile(
                        lambda: run_scan(fork(sim), n, _eager=True), n)},
                coupling_clip_16_slots=coupling_clip_widths_card(sim))
        del sim
        torch.cuda.empty_cache()

    # the life-cycle run: the lifecycle phase's (graph) against eager steps
    base = build_many_floes(1000, device=dev, dtype=torch.float32, n_dt=LIFECYCLE_N_DT)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = report.get("lifecycle_run") or run(fork(base))
        t0 = time.perf_counter()
        e = run(fork(base), _eager=True)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    same_state(g, e, "life-cycle run: graph against eager")
    for k in ("steps", "segments", "host_pass_count", "rng_state", "max_floe_id"):
        if g.run_stats[k] != e.run_stats[k]:
            raise AssertionError(f"life-cycle run: {k} differs, graph {g.run_stats[k]}, "
                                 f"eager {e.run_stats[k]}")
    if g.n_overflow != e.n_overflow:
        raise AssertionError(f"life-cycle run: n_overflow {g.n_overflow} vs {e.n_overflow}")
    st = g.run_stats
    # every program of the run's graph (the whole step, and the halves of
    # the ridge/raft steps): one replay adds what the card ran.  They are
    # captured anew on the run's end state: under torch.profiler, a replay
    # of a graph captured in an earlier phase crashed inside the launch
    # (after the phases before this one had profiled and dropped other
    # graphs), while its plain replays ran
    progs = g.step_graph().captured_launches()
    fresh = fork(g)
    fresh.step_graph().prepare(set(progs))
    if fresh.step_graph().captured_launches() != progs:
        raise AssertionError(f"life-cycle programs captured anew hold other launches: "
                             f"{fresh.step_graph().captured_launches()} vs {progs}")
    per_replay = runs_per_replay(fresh.step_graph())
    b2_per_replay = runs_per_replay(fresh.step_graph(), "regions")
    b6_per_replay = runs_per_replay(fresh.step_graph(), "cell_clip")
    del fresh
    report["runs_on_the_card"]["life-cycle run's programs, one replay each"] = per_replay
    report.setdefault("b2_runs_on_the_card", {})[
        "life-cycle run's programs, one replay each"] = b2_per_replay
    report.setdefault("b6_runs_on_the_card", {})[
        "life-cycle run's programs, one replay each"] = b6_per_replay
    life = {"steps": st["steps"], "bitwise_equal": True, "segments": st["segments"],
            "kernel_runs_per_replay": per_replay,
            "slow_clip_runs_per_replay": b2_per_replay,
            "cell_clip_runs_per_replay": b6_per_replay,
            "host_pass_count": st["host_pass_count"], "n_overflow": g.n_overflow,
            "graph": st["graph"], "graph_seconds": st["seconds"],
            "eager_seconds": eager_s}

    # synchronisations a step over its first 100 steps, by source line
    def syncs_of(eager):
        short = fork(base)
        short.n_dt = 99
        short, n_syncs, src = count_host_syncs(lambda: run(short, _eager=eager), top=None)
        return n_syncs / short.run_stats["steps"], src

    life["host_syncs_per_step_first_100_steps"], life["host_sync_sources"] = syncs_of(False)
    body = {k: v for k, v in life["host_sync_sources"].items()
            if any(f in k for f in STEP_BODY_FILES)}
    if body:
        raise AssertionError(f"the step body read the device: {body}")
    life["eager_host_syncs_per_step_first_100_steps"], life["eager_host_sync_sources"] = \
        syncs_of(True)
    emit("graph", dtype="float32", **out, lifecycle=life)


def fracture_margins(floes, sim):
    """For the state a fracture pass would see: which floes it would
    fracture (ids), how many it would at the yield curve's default ice
    strength, and how far each floe's principal stresses lie from the yield
    curve, as a fraction of the curve's size, for the floes whose stress is
    not exactly zero (a floe never touched has principal stresses (0, 0), the
    tip of the Hibler ellipse: the pass decides it from the curve's own
    roundoff, which is the same on the card and on the CPU as long as the
    mean height is, and it is counted apart)."""
    from subzero_tpu_torch.physics import lifecycle_host as lh
    from subzero_tpu_torch.settings import HiblerYieldCurve

    hf = lh.HostFloes(floes)
    f = hf.fields
    chosen = lh.determine_fractures(hf, sim.fracture_settings.criteria, sim.floe_settings)
    at_default = lh.determine_fractures(hf, HiblerYieldCurve(), sim.floe_settings)
    idxs = np.nonzero(f["active"] & ~f["remove"])[0]
    poly = lh.criteria_polygon(sim.fracture_settings.criteria, f["height"][idxs])
    evals = np.linalg.eigvalsh(f["stress_accum"][idxs].astype(float))
    a, b = poly, np.roll(poly, -1, axis=0)
    ab = b - a
    t = np.clip(np.einsum("kvd,vd->kv", evals[:, None, :] - a[None], ab)
                / np.maximum((ab * ab).sum(1), 1e-300), 0.0, 1.0)
    near = a[None] + t[..., None] * ab[None]
    dist = np.sqrt(((evals[:, None, :] - near) ** 2).sum(-1)).min(1)
    size = float(np.abs(poly).max())
    stressed = (evals != 0).any(1)
    margins = dict(zip((int(x) for x in f["id"][idxs][stressed]),
                       (dist[stressed] / size).tolist()))
    return (set(int(f["id"][i]) for i in chosen), margins, int((~stressed).sum()),
            len(at_default))


def phase_lifecycle_card_cpu(dev, report):
    from subzero_tpu_torch.simulation import build_step, run

    def counted_run(sim, where, **kw):
        """run(sim); on the card the kernels' launches (B1, B2) are counted
        from 0 just before it and read just after."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            reset_launches()
            sim = run(sim, **kw)
            n = (path_launches(), path_launches("regions"))
        if where == "cpu" and any(n):
            raise AssertionError(f"the CPU run launched the kernels {n} times")
        return sim, n

    n_before = 75   # steps 0..74: device steps only; the pass follows step 75
    sims, launches = {}, {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        # the example's field at its full width, with the fracture pass's
        # deformation on (so that run calls pair_interactions) and the ice
        # strength lowered: at the curve's default no floe of this field has
        # yielded by step 75 (counted below), at pstar = 200 many have
        sim = build_many_floes(1000, device=device, dtype=torch.float64,
                               n_dt=n_before - 1, deform=True, pstar=200.0)
        id0 = int(sim.model.floes.id.max())
        t0 = time.perf_counter()
        sims[where], launches[where] = counted_run(sim, where)
        if where == "cpu":
            cpu_seconds = time.perf_counter() - t0
    card, cpu = sims["card"], sims["cpu"]
    if launches["card"] != (n_before, b2_per_step() * n_before) or any(
            any(by.values()) for by in card.run_stats["host_pass_launches"].values()):
        raise AssertionError(f"{launches['card']} kernel launches in {n_before} steps "
                             f"without an overlap query: {card.run_stats['host_pass_launches']}")
    if card.run_stats["rng_state"] != cpu.run_stats["rng_state"]:
        raise AssertionError("the generators parted before the first fracture pass")

    # continuous fields after 75 steps, held to what contact dynamics predict
    # of a 1e-9 difference: tenfold every 15 steps
    tol = 1e-9 * 10 ** (n_before / 15)
    fc, fh = card.model.floes, cpu.model.floes
    for f in ("active", "id", "nverts"):
        if not torch.equal(getattr(fc, f).cpu(), getattr(fh, f)):
            raise AssertionError(f"floes.{f} differs between the card and the CPU")
    diffs = {f: max_rel_diff(getattr(fc, f), getattr(fh, f))
             for f in ("centroid", "u", "v", "xi", "collision_force", "stress_accum")}
    if not max(diffs.values()) <= tol:
        raise AssertionError(f"card vs CPU beyond {tol}: {diffs}")

    # the state the fracture pass will see (one more device step, outside
    # the counted runs), and how near any floe's stress lies to the yield curve
    seen = {}
    for where, sim in sims.items():
        m = sim.model
        floes, *_ = build_step(sim)(m.floes, m.ocean, m.domain, n_before)
        seen[where] = fracture_margins(floes, sim)
    (chosen_c, margin_c, _, _), (chosen_h, margin_h, n_zero, n_default) = (
        seen["card"], seen["cpu"])
    flipped = sorted(chosen_c ^ chosen_h)
    if flipped:
        raise AssertionError(
            "fracture decisions differ between the card and the CPU for floe ids "
            + ", ".join(f"{i} (distance to the yield curve {margin_h.get(i)} of its "
                        f"size on the CPU, {margin_c.get(i)} on the card)" for i in flipped))

    # step 75 with its fracture pass (deformation on: pair_interactions)
    for where, sim in sims.items():
        sim.rng_state = sim.run_stats["rng_state"]
        sim.n_dt = 0
        sims[where], launches[where] = counted_run(sim, where, start_tstep=n_before)
    card, cpu = sims["card"], sims["cpu"]
    n_pi, n_pi2 = (card.run_stats["host_pass_launches"][k]["fracture"]
                   for k in ("two_cross", "regions"))
    n_step, n_step2 = launches["card"][0] - n_pi, launches["card"][1] - n_pi2
    if (n_step, n_pi, n_step2, n_pi2) != (1, 1, b2_per_step(), 1):
        raise AssertionError(f"step {n_before} with its fracture pass launched B1 "
                             f"{n_step} and B2 {n_step2} times from the step and "
                             f"{n_pi} and {n_pi2} times from pair_interactions; "
                             f"expected 1 and {b2_per_step()}, 1 and 1")
    fc, fh = card.model.floes, cpu.model.floes
    ids_c = set(fc.id[fc.active].cpu().tolist())
    ids_h = set(fh.id[fh.active].tolist())
    parents_c = set(fc.parent_id[fc.active & (fc.id > id0)].cpu().tolist())
    parents_h = set(fh.parent_id[fh.active & (fh.id > id0)].tolist())
    if ids_c != ids_h or parents_c != parents_h:
        raise AssertionError(f"floe ids or fractured floes differ: ids {sorted(ids_c ^ ids_h)}, "
                             f"parents {sorted(parents_c ^ parents_h)}")
    if not parents_h:
        raise AssertionError("no floe fractured at the first fracture pass")
    if card.run_stats["rng_state"] != cpu.run_stats["rng_state"]:
        raise AssertionError("the generators parted in the fracture pass")
    after = {f: max_rel_diff(getattr(fc, f), getattr(fh, f))
             for f in ("centroid", "u", "v", "area", "height")}
    if not max(after.values()) <= tol:
        raise AssertionError(f"card vs CPU after the fracture pass beyond {tol}: {after}")
    by_path = report["launches_by_path"]
    by_path["run step (lifecycle_card_cpu)"] = n_before + n_step
    by_path["pair_interactions (lifecycle_card_cpu fracture)"] = n_pi
    b2_path(report, "run step (lifecycle_card_cpu)", b2_per_step() * n_before + n_step2)
    b2_path(report, "pair_interactions (lifecycle_card_cpu fracture)", n_pi2)
    emit("lifecycle_card_cpu",
         config="examples/many_floes.py, 1000 floes in a pool of 2000, deform_on, pstar 200",
         dtype="float64", n_steps=n_before + 1, tolerance=tol,
         max_rel_diff_before_pass=diffs, max_rel_diff_after_pass=after,
         fractured_floes=len(parents_h), floes_after=len(ids_h),
         would_fracture_at_the_default_pstar=n_default,
         smallest_distance_to_yield_curve=min(margin_h.values()),
         floes_with_zero_stress=n_zero, cpu_seconds_75_steps=cpu_seconds,
         kernel_launches={"step": n_before + n_step, "pair_interactions": n_pi})


# ---------------------------------------------------------------------------
# writers and restart
# ---------------------------------------------------------------------------

# card against a CPU copy of one state, f32: each gridded output within this
# fraction of its largest magnitude
EULERIAN_TOL = 1e-5
WRITERS = ("initial_state", "floes", "grid", "checkpoint")


def h5py_available() -> bool:
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def keep_in_memory(writers) -> dict:
    """Replace each writer's file half (``write_arrays``, the h5py part) by a
    list that keeps what it would have written; the device halves run as
    they do with files.  Returns the lists by writer."""
    kept = {}
    for name in WRITERS:
        w = getattr(writers, name)
        if w is not None:
            kept[name] = []
            w.write_arrays = lambda *a, _k=kept[name]: _k.append(a)
    return kept


def run_settings(sim) -> dict:
    """What ``restart`` must be handed to resume ``sim`` exactly: every
    setting the files do not hold (the process settings and capacities)."""
    skip = {"model", "consts", "dt", "n_dt", "name", "writers", "rng_state"}
    return {f.name: getattr(sim, f.name) for f in dataclasses.fields(sim)
            if f.init and f.name not in skip}


def resume(initial, checkpoint, new_n_dt, settings, writers=None):
    """``restart(..., device=None)`` from an initial-state and a checkpoint
    file (paths), or without files ``restore_simulation`` from the arrays the
    device halves handed the file halves (the lists of ``keep_in_memory``).
    Returns (sim, last step, seconds)."""
    from subzero_tpu_torch.io.writers import restart, restore_simulation

    t0 = time.perf_counter()
    if isinstance(initial, str):
        sim, last = restart(initial, checkpoint, new_n_dt, writers=writers,
                            device=None, **settings)
    else:
        (arrays,), (last, ckpt) = initial[0], checkpoint[-1]
        sim = restore_simulation(arrays, ckpt, new_n_dt, writers=writers,
                                 device=None, **settings)
    torch.cuda.synchronize()
    return sim, last, time.perf_counter() - t0


def sources(files, out_dir, kept, name):
    """Where ``resume`` reads the ``initial_state`` or the ``checkpoint``
    writer's output: its file in ``out_dir``, or the arrays
    ``keep_in_memory`` kept."""
    return os.path.join(out_dir, f"{name}.h5") if files else kept[name]


def assert_same_run(got, want, what, id_base=None) -> int:
    """Two runs' final states bitwise equal: every pool field slot for slot,
    the ocean and the generator state.  With ``id_base`` the ids above it
    (floes made after a restart) may differ by one offset throughout, as
    they do where the id counter of the run that was not restarted ran
    ahead of the largest id left in the pool; returns that offset."""
    fg, fw = got.model.floes, want.model.floes
    offset = 0
    for f, x, y in zip(fw._fields, fg, fw):
        if id_base is not None and f in ("id", "parent_id"):
            new = y > id_base
            d = torch.unique((y - x)[new])
            if d.numel() > 1 or not torch.equal(x[~new], y[~new]):
                raise AssertionError(f"{what}: floes.{f} differs beyond one id offset")
            offset = int(d[0]) if d.numel() else offset
        elif not torch.equal(x, y):
            raise AssertionError(f"{what}: floes.{f} differs")
    for f, x, y in zip(want.model.ocean._fields, got.model.ocean, want.model.ocean):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: ocean.{f} differs")
    if got.run_stats["rng_state"] != want.run_stats["rng_state"]:
        raise AssertionError(f"{what}: the generator states differ")
    return offset


def eulerian_card_vs_cpu(model, dims) -> dict:
    """eulerian_data on the card against a CPU copy of the same pool: each
    output within EULERIAN_TOL of its largest magnitude.  A cell whose ice
    area is roundoff (a floe edge grazing it: below 1e-8 of the cell on
    either side) divides each floe quantity by that roundoff area, so its
    averages are noise on both sides; there an average is held weighted by
    the ice fraction (its share of the cell), as tests/test_torch_writers.py
    holds the port to the JAX package.  Returns the largest relative
    difference by output."""
    from subzero_tpu_torch.io.writers import eulerian_data

    card = eulerian_data(model.floes, model.ocean, model.grid, dims)
    cpu = eulerian_data(model.floes.to("cpu"), model.ocean, model.grid, dims)
    fc, fh = card["si_frac_grid"], cpu["si_frac_grid"]
    real = (np.minimum(fc, fh) > 1e-8) | (np.maximum(fc, fh) == 0)
    weight = np.where(real, 1.0, np.maximum(fc, fh))
    worst = {}
    for k, r in cpu.items():
        scale = float(np.abs(r).max())
        err = float((np.abs(card[k] - r) * weight).max())
        worst[k] = err / scale if scale > 0 else err
        if not err <= EULERIAN_TOL * scale:
            raise AssertionError(f"eulerian_data {k}: card vs CPU {err} at scale {scale}")
    if not fh.any():
        raise AssertionError("eulerian_data: no ice on the grid")
    worst["roundoff_ice_cells"] = int((~real).sum())
    return worst


def phase_writers(dev, report):
    from subzero_tpu_torch.examples import simple_strait
    from subzero_tpu_torch.simulation import run

    n_dt = 200  # the example runs 5 000
    files = h5py_available()
    stats = {"seconds": dict.fromkeys(WRITERS, 0.0), "events": dict.fromkeys(WRITERS, 0),
             "write_data_seconds": 0.0, "launches": 0, "slow_clip_launches": 0}
    with tempfile.TemporaryDirectory() as tmp:
        sim = simple_strait.build(n_dt=n_dt, out_dir=tmp, device=dev)
        w = sim.writers
        # the one difference from the example: the floe writer's interaction
        # rows, so that the writer path launches the kernel (pair_interactions)
        w.floes.outputs = tuple(w.floes.outputs) + ("interactions",)
        kept = None if files else keep_in_memory(w)
        last = {}

        for name in WRITERS:
            wr = getattr(w, name)
            if wr is None:
                continue

            def timed(*a, _write=wr.write, _name=name, **kw):
                if _name == "floes":  # the pool as the writer was handed it
                    last["tstep"], last["floes"] = a[0], type(a[1])(*(x.clone() for x in a[1]))
                t0 = time.perf_counter()
                _write(*a, **kw)
                stats["seconds"][_name] += time.perf_counter() - t0
                stats["events"][_name] += 1

            wr.write = timed
        write_data = w.write_data

        def timed_write_data(*a, **kw):
            torch.cuda.synchronize()  # the steps queued before are not the writers'
            l0, l2, t0 = path_launches(), path_launches("regions"), time.perf_counter()
            write_data(*a, **kw)
            torch.cuda.synchronize()
            stats["write_data_seconds"] += time.perf_counter() - t0
            stats["launches"] += path_launches() - l0
            stats["slow_clip_launches"] += path_launches("regions") - l2

        w.write_data = timed_write_data

        m0 = sim.model
        at_step_0 = {"eulerian_data": eulerian_card_vs_cpu(m0, w.grid.dims),
                     "interaction_rows": overlaps_card_vs_cpu(sim, False, sim.bins,
                                                              full_ok=True)}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # overflow and pool-full notes
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            sim = run(sim)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches, b2 = path_launches(), path_launches("regions")
        st = sim.run_stats
        check_finite(sim)
        at_last_step = {"eulerian_data": eulerian_card_vs_cpu(sim.model, w.grid.dims),
                        "interaction_rows": overlaps_card_vs_cpu(sim, False, sim.bins,
                                                                 full_ok=True)}
        writer_launches = stats["launches"]
        step_launches = (launches - writer_launches
                         - sum(st["host_pass_launches"]["two_cross"].values()))
        if step_launches != st["steps"] or writer_launches != stats["events"]["floes"]:
            raise AssertionError(
                f"kernel launches: step {step_launches} in {st['steps']} steps, writer "
                f"{writer_launches} in {stats['events']['floes']} floe-writer events")
        writer_b2 = stats["slow_clip_launches"]
        step_b2 = b2 - writer_b2 - sum(st["host_pass_launches"]["regions"].values())
        if (step_b2 != b2_per_step() * st["steps"] or writer_b2 != writer_launches
                or st["host_pass_launches"]["regions"] != st["host_pass_launches"]["two_cross"]):
            raise AssertionError(
                f"slow clip launches: step {step_b2} in {st['steps']} steps, writer "
                f"{writer_b2}, host passes {st['host_pass_launches']}")
        by_path = report["launches_by_path"]
        by_path["run step (writers)"] = step_launches
        by_path["pair_interactions (FloeOutputWriter)"] = writer_launches
        b2_path(report, "run step (writers)", step_b2)
        b2_path(report, "pair_interactions (FloeOutputWriter)", writer_b2)

        # what the writers wrote: the steps, and at the last floe-writer event
        # every dataset bitwise equal to the pool pulled straight from the card
        want = {k: v.cpu().numpy()[last["floes"].active.cpu().numpy()]
                for k, v in last["floes"]._asdict().items()}
        floe_steps, grid_times = list(range(0, n_dt + 1, w.floes.interval)), [0.0, 100.0, 200.0]
        if files:
            import h5py

            with h5py.File(os.path.join(tmp, "floes.h5"), "r") as f:
                steps = sorted(int(k) for k in f.keys())
                got = {k: v[()] for k, v in f[str(last["tstep"])].items()}
            with h5py.File(os.path.join(tmp, "gridded_data.nc"), "r") as f:
                times = list(f["time"][()])
        else:
            steps = [a[0] for a in kept["floes"]]
            got = kept["floes"][-1][1]
            times = [float(a[0]) for a in kept["grid"]]
        if steps != floe_steps or times != grid_times or last["tstep"] != n_dt:
            raise AssertionError(f"floe groups {steps}, grid times {times}")
        fields = [k for k in w.floes.outputs if k != "interactions"]
        for k in fields:
            if not np.array_equal(got[k], want[k]) or got[k].dtype != want[k].dtype:
                raise AssertionError(f"floe writer at step {n_dt}: {k} differs from the pool")
        if set(got) != set(fields) | {"interactions", "num_inters"}:
            raise AssertionError(f"floe writer datasets {sorted(got)}")
        if got["interactions"].shape[1] != 8 or len(got["num_inters"]) != len(want["id"]):
            raise AssertionError("floe writer: interaction datasets of the wrong shape")
    examples, ex_counts = run_every_example(files)
    by_path["run step (every example, 21 steps each)"] = ex_counts["step_launches"]
    b2_path(report, "run step (every example, 21 steps each)",
            ex_counts["slow_clip_step_launches"])
    host_s = sum(st["host_pass_seconds"].values())
    writer_s = stats["write_data_seconds"]
    emit("writers", config="examples/simple_strait.py, 500 floes in a pool of 1 000, "
         "floe writer with interactions", dtype="float32", n_dt=n_dt, steps=st["steps"],
         files=files, seconds=seconds, step_ms=1e3 * seconds / st["steps"],
         device_steps_seconds=seconds - host_s - writer_s,
         write_data_seconds=writer_s, write_seconds_by_writer=stats["seconds"],
         write_data_other_seconds=writer_s - sum(stats["seconds"].values()),
         writer_events=stats["events"], host_pass_seconds=st["host_pass_seconds"],
         kernel_launches={"step": step_launches, "pair_interactions_writer": writer_launches,
                          "host_passes": st["host_pass_launches"]},
         eulerian_tolerance=EULERIAN_TOL, card_vs_cpu_step_0=at_step_0,
         card_vs_cpu_last_step=at_last_step, floe_groups=steps, grid_times=times,
         interaction_rows_last_event=int(got["interactions"].shape[0]),
         n_overflow=sim.n_overflow, active_floes=int(sim.model.floes.count()),
         every_example_21_steps=examples, every_example_launches=ex_counts)


EXAMPLES = ("uniform_flow", "shear_flow", "simple_strait", "converge_diverge_flow",
            "forcing_contained_floes", "moving_bounds", "many_floes", "restart_sim")


def run_every_example(files, n_dt=20) -> dict:
    """Each of the port's single-device examples built by its own ``build``
    with its own arguments (out_dir given, device None: the card) and run
    n_dt steps with its writers, not verbose: the state finite, the kernel
    launched once a step, and every writer that fires at step 0 wrote.
    Returns the figures by example and the launch counts."""
    import importlib

    counts = dict.fromkeys(COUNTS, 0)
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES:
            mod = importlib.import_module(f"subzero_tpu_torch.examples.{name}")
            out_dir = os.path.join(tmp, name)
            t0 = time.perf_counter()
            sim = mod.build(out_dir=out_dir)
            if isinstance(sim, tuple):  # restart_sim: (sim, settings)
                sim = sim[0]
            setup_s = time.perf_counter() - t0
            sim.n_dt, sim.verbose = n_dt, False
            kept = None if files else keep_in_memory(sim.writers)
            t0 = time.perf_counter()
            sim = run_and_count(sim, counts)
            torch.cuda.synchronize()
            check_finite(sim)
            fired = [w for w in WRITERS if getattr(sim.writers, w) is not None]
            wrote = (sorted(f for f in os.listdir(out_dir)) if files
                     else sorted(w for w in fired if kept[w]))
            if len(wrote) != len(fired):
                raise AssertionError(f"example {name}: writers {fired} wrote {wrote}")
            figures[name] = {"floes": int(sim.model.floes.count()),
                             "dtype": str(sim.model.floes.verts.dtype).split(".")[-1],
                             "host_setup_seconds": setup_s,
                             "run_seconds": time.perf_counter() - t0, "wrote": wrote}
    check_counts(counts, "examples")
    return figures, counts


COUNTS = ("steps", "step_launches", "pass_launches", "slow_clip_step_launches",
          "slow_clip_pass_launches")


def run_and_count(sim, counts, **kw):
    """``run(sim)``; adds its steps and its kernels' launches (B1 and B2,
    from the step and from the host passes, each counted from 0 just
    before) to ``counts``."""
    from subzero_tpu_torch.simulation import run

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        reset_launches()
        sim = run(sim, **kw)
        n, n2 = path_launches(), path_launches("regions")
    passes, passes2 = (sum(sim.run_stats["host_pass_launches"][k].values())
                       for k in ("two_cross", "regions"))
    counts["steps"] += sim.run_stats["steps"]
    counts["step_launches"] += n - passes
    counts["pass_launches"] += passes
    counts["slow_clip_step_launches"] += n2 - passes2
    counts["slow_clip_pass_launches"] += passes2
    return sim


def check_counts(counts, what) -> None:
    """B1 once a step, B2 b2_per_step() times a step, and one of each a
    host-pass query."""
    if (counts["step_launches"] != counts["steps"]
            or counts["slow_clip_step_launches"] != b2_per_step() * counts["steps"]
            or counts["slow_clip_pass_launches"] != counts["pass_launches"]):
        raise AssertionError(f"{what}: kernel launches {counts}")


def phase_restart(dev, report):
    from subzero_tpu_torch.examples import restart_sim
    from subzero_tpu_torch.io.writers import (CheckpointOutputWriter,
                                              InitialStateOutputWriter, OutputWriters)

    files = h5py_available()
    counts = dict.fromkeys(COUNTS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        # the life cycle: one run to step 450 against a run to step 300 that
        # checkpoints every 150 steps, restarted from its last checkpoint
        n_ckpt, n_end = 300, 450
        base = build_many_floes(1000, device=dev, dtype=torch.float32, n_dt=n_end)
        settings = run_settings(base)
        t0 = time.perf_counter()
        cont = run_and_count(fork(base), counts)
        cont_s = time.perf_counter() - t0
        leg = fork(base)
        leg.n_dt = n_ckpt
        leg.writers = OutputWriters(
            initial_state=InitialStateOutputWriter(dir=tmp, overwrite=True),
            checkpoint=CheckpointOutputWriter(150, dir=tmp, overwrite=True))
        kept = None if files else keep_in_memory(leg.writers)
        run_and_count(leg, counts)
        resumed, last, restart_s = resume(
            sources(files, tmp, kept, "initial_state"),
            sources(files, tmp, kept, "checkpoint"), n_end - n_ckpt, settings)
        if last != n_ckpt or resumed.model.floes.verts.device.type != torch.device(dev).type:
            raise AssertionError(f"restarted at {last} on {resumed.model.floes.verts.device}")
        id_base = int(resumed.model.floes.id.max())
        resumed = run_and_count(resumed, counts, start_tstep=last)
        fractured = resumed.run_stats["host_pass_count"]["fracture"]
        new_ids = int((resumed.model.floes.id > id_base).sum())
        if not fractured or not new_ids:
            raise AssertionError(f"the resumed leg made no floe ({fractured} fracture passes)")
        offset = assert_same_run(resumed, cont, "many_floes restarted at 300", id_base)
        life = {"n_dt": n_end, "restarted_at": last, "restart_seconds": restart_s,
                "continuous_seconds": cont_s, "fracture_passes_after_restart": fractured,
                "floes_made_after_restart": new_ids, "id_offset": offset,
                "active_floes": int(cont.model.floes.count()),
                "max_floe_id": int(cont.model.floes.id.max()), "bitwise_equal": True}

        # the restart_sim example at its width: three parts against one run
        out = [os.path.join(tmp, f"run_{i + 1}") for i in range(restart_sim.N_PART_SIM)]
        part, _ = restart_sim.build(out_dir=out[0], device=dev)
        settings = run_settings(part)
        one = fork(part)
        one.writers = None
        one.n_dt = restart_sim.N_PART_SIM * restart_sim.N_DT_PART
        one = run_and_count(one, counts)
        kept = first = None if files else keep_in_memory(part.writers)
        part = run_and_count(part, counts)
        seconds = []
        for prev, nxt in zip(out[:-1], out[1:]):
            # the initial state lives with part 1, the checkpoint with the last
            writers = restart_sim._writers(nxt)
            nxt_kept = None if files else keep_in_memory(writers)
            part, last, s = resume(sources(files, out[0], first, "initial_state"),
                                   sources(files, prev, kept, "checkpoint"),
                                   restart_sim.N_DT_PART, settings, writers)
            seconds.append(s)
            part = run_and_count(part, counts, start_tstep=last)
            kept = nxt_kept
        assert_same_run(part, one, "restart_sim in three parts")
        example = {"parts": restart_sim.N_PART_SIM, "steps_a_part": restart_sim.N_DT_PART,
                   "restart_seconds": seconds, "active_floes": int(one.model.floes.count()),
                   "bitwise_equal": True}
    check_counts(counts, "restart")
    report["launches_by_path"]["run step (restart)"] = counts["step_launches"]
    b2_path(report, "run step (restart)", counts["slow_clip_step_launches"])
    emit("restart", files=files,
         config="examples/many_floes.py, 1000 floes in a pool of 2000 (f32); "
         "examples/restart_sim.py, 20 floes (f64)",
         many_floes=life, restart_sim=example, kernel_launches=counts)


# ---------------------------------------------------------------------------
# decomp: parallel/decomp.py as rank processes on the card
# ---------------------------------------------------------------------------

DECOMP_RANKS = 4
DECOMP_TIMEOUT = 420      # seconds for the gloo ranks' parts, start-up included
# n_overflow of the JAX package's run_decomp on examples/distributed_shear_flow.py
# (4 slabs, 500 floes, f32, 500 steps) on an 8-device virtual CPU mesh:
# tests/jax_decomp_reference.py
JAX_DSF_N_OVERFLOW = 0
DECOMP_EXAMPLE_STEPS = 500   # the example's own n_dt
# decomposed against single-device: tests/test_parallel.py:178-186 (si_frac :184)
VS_SINGLE_TOL = {"centroid": dict(rtol=0, atol=1e-4), "u": dict(rtol=1e-4, atol=1e-10),
                 "v": dict(rtol=1e-4, atol=1e-10), "xi": dict(rtol=1e-4, atol=1e-12),
                 "height": dict(rtol=1e-9, atol=0)}
VS_SINGLE_SI_FRAC = dict(rtol=1e-4, atol=1e-10)


def launch_ranks(cmd, world, tag, out_dir, timeout, one_card_a_rank=False, cwd=None):
    """Start ``world`` processes of ``cmd`` as the ranks of one process group
    (the environment torchrun sets: env://, RANK, LOCAL_RANK) and wait for
    them, in ``cwd`` (default this file's directory); a rank that fails or
    does not end within ``timeout`` seconds kills the others and fails the
    phase.  Every rank runs on card 0 unless ``one_card_a_rank``.  Returns
    each rank's log file."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
        if not one_card_a_rank:
            env["CUDA_VISIBLE_DEVICES"] = "0"   # every rank on the one card
        logs.append(os.path.join(out_dir, f"{tag}.rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                          env=env, cwd=cwd or here))
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            if any(c not in (None, 0) for c in codes) or time.monotonic() > deadline:
                tails = "\n---\n".join(open(f).read()[-4000:] for f in logs)
                raise RuntimeError(f"ranks of {tag} ended with {codes} "
                                   f"(None: killed at the time limit):\n{tails}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return logs


def decomp_launch(world, backend, parts, out_dir, timeout, one_card_a_rank=False,
                  checkout=None):
    """The named parts of the decomp phase as ``world`` rank processes of this
    script (``--decomp-rank``; with ``checkout``, of that checkout's
    chip_smoke.py on its own package) on a process group of ``backend``;
    returns each rank's results."""
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, f"{backend}{world}.json")
    with open(spec, "w") as f:
        json.dump({"backend": backend, "parts": parts, "out_dir": out_dir}, f)
    script = (os.path.join(os.path.abspath(checkout), "chip_smoke.py") if checkout
              else os.path.abspath(__file__))
    launch_ranks([sys.executable, script, "--decomp-rank", spec], world,
                 f"{backend}{world}", out_dir, timeout, one_card_a_rank,
                 cwd=os.path.dirname(script))
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{backend}{world}.result{r}.json")) as f:
            out.append(json.load(f))
    return out


def decomp_rank(spec_path: str) -> int:
    """One rank process of the decomp phase: joins the process group the
    environment names (env://), runs the named parts on every rank, and
    writes this rank's results.  Any failure raises: the exit code is not 0."""
    import torch.distributed as dist

    from subzero_tpu_torch.parallel import multihost

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(2)
    multihost.initialize(backend=spec["backend"])
    rank = dist.get_rank()
    out = {"rank": rank, "backend": spec["backend"], "world": dist.get_world_size(),
           "device": str(multihost.rank_device(None))}
    for part in spec["parts"]:
        t0 = time.perf_counter()
        out[part] = DECOMP_PARTS[part](spec)
        out[part]["part_seconds"] = time.perf_counter() - t0
    with open(os.path.join(spec["out_dir"],
                           f"{spec['backend']}{out['world']}.result{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _example(dtype, n_dt, device, pair_rows=None, **over):
    """The port's examples/shear_flow.py field, as distributed_shear_flow
    builds it: 500 floes, two-way coupling, writers kept in memory."""
    from subzero_tpu_torch.examples.shear_flow import build

    sim = build(dtype=dtype, n_dt=n_dt, out_dir="unused", n_floes=500, device=device)
    kept = keep_in_memory(sim.writers)
    if pair_rows is not None:
        sim.pair_cap = pair_rows * sim.model.floes.capacity
    return dataclasses.replace(sim, **over) if over else sim, kept


def _ids(floes):
    return sorted(floes.id[floes.active].tolist())


def _timed_decomp(sim, dec):
    """run_decomp on every rank with this rank's kernel counts from 0;
    returns (sim, seconds, (B1 launches, B2 launches))."""
    from subzero_tpu_torch.parallel import run_decomp

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        sim = run_decomp(sim, dec)
        launches = (path_launches(), path_launches("regions"))
        torch.cuda.synchronize()
    return sim, time.perf_counter() - t0, launches


def _check_launches(sim, launches, what):
    """B1 once a step and once a host-pass query, B2 (the slow clip)
    b2_per_step() times a step (clip and retry) and once a query, each
    kernel's host-pass launches as the run counted them."""
    (b1, b2), st = launches, sim.run_stats
    by, by2 = (st["host_pass_launches"][k] for k in ("two_cross", "regions"))
    host, host2 = sum(by.values()), sum(by2.values())
    if b1 - host != st["steps"] or b2 - host2 != b2_per_step() * st["steps"] or by != by2:
        raise AssertionError(f"{what}: {b1} (B1) and {b2} (B2) kernel launches in "
                             f"{st['steps']} steps; in host passes {by} and {by2}")
    return {"step": b1 - host, "host_pass_queries": host, "steps": st["steps"],
            "slow_clip_step": b2 - host2, "slow_clip_host_pass_queries": host2}


class _CaptureExtended:
    """Keeps the last halo-extended pool a rank's step hands
    timestep_collisions (owned_rows set: the run's last step, whose floes are
    in contact), to hold the kernel against its plain version on it."""

    def __init__(self):
        from subzero_tpu_torch.physics import collisions

        self.mod, self.orig, self.args = collisions, collisions.timestep_collisions, None

    def __enter__(self):
        def wrapped(floes, domain, consts, dt, cls, pair_cap, clip_cap=16, bins=None,
                    owned_rows=None):
            if owned_rows is not None:
                self.args = (floes, domain, pair_cap, owned_rows)
            return self.orig(floes, domain, consts, dt, cls, pair_cap, clip_cap, bins,
                             owned_rows=owned_rows)

        self.mod.timestep_collisions = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.timestep_collisions = self.orig
        return False


def part_example(spec):
    """examples/distributed_shear_flow.py at its width on every rank: 500
    floes, f32, 4 x-slabs, 500 steps, floe writer every 50 steps (rank 0);
    then the single-device ``run`` of the same build on rank 0 while the
    others wait."""
    import torch.distributed as dist

    from subzero_tpu_torch.parallel import make_decomp, multihost
    from subzero_tpu_torch.parallel.decomp import comm_bytes_per_step
    from subzero_tpu_torch.physics.collisions import narrow_phase_batch
    from subzero_tpu_torch.simulation import run

    dev = multihost.rank_device(None)
    rank = dist.get_rank()
    sim, kept = _example(torch.float32, DECOMP_EXAMPLE_STEPS, dev)
    fl0 = sim.model.floes
    ids0, mass0 = _ids(fl0), float(fl0.mass[fl0.active].double().sum())
    dec = make_decomp(fl0, sim.model.domain)
    bound = comm_bytes_per_step(sim, dec)
    with _CaptureExtended() as cap:
        sim, seconds, launches = _timed_decomp(sim, dec)
    counts = _check_launches(sim, launches, f"rank {rank}")
    check_finite(sim)
    fl1 = sim.model.floes
    ids1, mass1 = _ids(fl1), float(fl1.mass[fl1.active].double().sum())
    st = sim.run_stats
    # no floe is lost: a floe leaves the pool only by fusing, and each fused
    # floe (a new id) takes the place of two or more
    gone, new = sorted(set(ids0) - set(ids1)), sorted(set(ids1) - set(ids0))
    if (gone or new) and not st["host_pass_count"]["fuse"] or len(gone) < 2 * len(new):
        raise AssertionError(f"floes {gone} left the pool, {new} came, in "
                             f"{st['host_pass_count']['fuse']} fuse passes")
    if sim.n_overflow != JAX_DSF_N_OVERFLOW:
        raise AssertionError(f"n_overflow {sim.n_overflow}, the JAX package's is "
                             f"{JAX_DSF_N_OVERFLOW}")
    written = {k: len(v) for k, v in kept.items()}
    if written != ({"initial_state": 1, "floes": DECOMP_EXAMPLE_STEPS // 50 + 1}
                   if rank == 0 else
                   {"initial_state": 0, "floes": 0}):
        raise AssertionError(f"rank {rank} wrote {written}")
    steps = st["steps"]
    out = {"seconds": seconds, "ms_per_step": 1e3 * seconds / steps, "steps": steps,
           "kernel_launches": counts, "n_overflow": sim.n_overflow,
           "capacities": {"local_cap": dec.local_cap, "halo_cap": dec.halo_cap,
                          "mig_cap": dec.mig_cap, "margin": dec.margin,
                          "local_cap_at_end": st["local_cap"]},
           "comm_per_step": {k: v / steps for k, v in st["comm"].items()},
           "comm_bytes_per_step_bound": bound,
           "host_pass_count": st["host_pass_count"], "segments": st["segments"],
           "active": [len(ids0), len(ids1)], "ids_gone": gone, "ids_new": new,
           "mass": [mass0, mass1], "written": written}
    if rank == 0:
        ext, domain, pair_cap, owned = cap.args
        nb = narrow_phase_batch(ext, domain, pair_cap, None, owned)
        out["b1_on_extended_pool"] = dict(
            check_main_path_batch(nb, "decomp_extended_pool", {}),
            ext_cap=ext.capacity, owned_rows=owned)
        if not all(v is True for v in out["b1_on_extended_pool"]["f32_bitwise_equal"].values()):
            raise AssertionError(f"B1 on the extended pool: {out['b1_on_extended_pool']}")
    dist.barrier()
    if rank == 0:  # the single-device run of the same build, the card to itself
        single, _ = _example(torch.float32, DECOMP_EXAMPLE_STEPS, dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single = run(single)
            torch.cuda.synchronize()
        s1 = time.perf_counter() - t0
        out["single_device"] = {"seconds": s1, "ms_per_step": 1e3 * s1 / steps,
                                "n_overflow": single.n_overflow,
                                "active": int(single.model.floes.count())}
    dist.barrier()
    return out


def _field_diffs(got, want, tol, what):
    """Row for row: integer and boolean fields equal, each floating field
    within ``tol`` of its largest magnitude; returns the relative diffs."""
    out = {}
    for f, x, y in zip(want._fields, got, want):
        x = x.detach().cpu()
        if x.is_floating_point():
            out[f] = max_rel_diff(x, y)
            if not out[f] <= tol:
                raise AssertionError(f"{what}: {f} differs by {out[f]} of its largest")
        elif not torch.equal(x, y.detach().cpu()):
            raise AssertionError(f"{what}: {f} differs")
    return out


def part_card_cpu(spec):
    """The example's field in f64, 20 steps over the 4 ranks: on the card,
    then on the CPU (same processes, gloo without staging); rank 0 holds the
    gathered pools row for row and the ocean against each other."""
    import torch.distributed as dist

    from subzero_tpu_torch.parallel import make_decomp, multihost, run_decomp

    runs = {}
    for where, dev in (("card", multihost.rank_device(None)), ("cpu", "cpu")):
        sim, _ = _example(torch.float64, 19, dev, writers=None)
        dec = make_decomp(sim.model.floes, sim.model.domain)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs[where] = (run_decomp(sim, dec), time.perf_counter() - t0)
    (card, card_s), (cpu, cpu_s) = runs["card"], runs["cpu"]
    out = {"steps": card.run_stats["steps"], "seconds": {"card": card_s, "cpu": cpu_s},
           "n_overflow": [card.n_overflow, cpu.n_overflow]}
    if dist.get_rank() == 0:
        out["floes_max_rel_diff"] = _field_diffs(card.model.floes, cpu.model.floes,
                                                 CARD_CPU_TOL, "card vs CPU floes")
        oc, oh = card.model.ocean, cpu.model.ocean
        frac = torch.maximum(oc.si_frac.cpu(), oh.si_frac)
        diffs = {}
        for f in ("tau_x", "tau_y"):
            # a roundoff sliver of ice divides the floe's stress: weight by it
            g, r = getattr(oc, f).cpu(), getattr(oh, f)
            w = torch.where(frac > 1e-8, torch.ones_like(frac), frac)
            diffs[f] = float(((g - r) * w).abs().max()) / float(r.abs().max())
        for f in ("si_frac", "dissolved"):
            diffs[f] = max_rel_diff(getattr(oc, f), getattr(oh, f))
        if not max(diffs.values()) <= CARD_CPU_TOL:
            raise AssertionError(f"card vs CPU ocean beyond {CARD_CPU_TOL}: {diffs}")
        out["ocean_max_rel_diff"] = diffs
    return out


def parallel_test_sim(kind, device):
    """tests/test_parallel.py's configurations with the port's constructors (f64,
    32 candidate rows a floe, where the default budget overflows):
    ``wide`` is make_wide_sim (128 floes, an 8:1 periodic domain), ``square``
    make_square_sim (256 floes, a 2e5 m periodic box); ``example`` is the
    distributed example's field (examples/shear_flow.py's build) in f64."""
    from subzero_tpu_torch.constants import Constants
    from subzero_tpu_torch.core import (BoundaryKind, initialize_floe_field, make_atmos,
                                        make_domain, make_grid, make_model, make_ocean)
    from subzero_tpu_torch.settings import (CouplingSettings, FloeSettings,
                                            SubGridPointsGenerator)
    from subzero_tpu_torch.simulation import Simulation

    kw = dict(dtype=torch.float64, device=device)
    if kind == "example":
        sim, _ = _example(torch.float64, 0, device, pair_rows=32, writers=None)
        return sim
    if kind == "wide":
        grid = make_grid(0.0, 8e5, 0.0, 1e5, Nx=40, Ny=5)
        u, v, n, conc, seed = 0.2, 0.0, 128, 0.45, 3
    else:
        grid = make_grid(0.0, 2e5, 0.0, 2e5, Nx=10, Ny=10)
        u, v, n, conc, seed = 0.15, -0.1, 256, 0.5, 9
    domain = make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    fs = FloeSettings(min_floe_area=1e6,
                      subfloe_point_generator=SubGridPointsGenerator.from_grid(grid, 2))
    floes = initialize_floe_field(n, [conc], domain, 0.25, 0.0, fs,
                                  rng=np.random.default_rng(seed), **kw)
    sim = Simulation(
        model=make_model(grid, make_ocean(grid, u=u, v=v, temp=0.0, **kw),
                         make_atmos(grid, temp=-1.0, **kw), domain, floes),
        consts=Constants(E=1e6), dt=20, n_dt=0, floe_settings=fs,
        coupling_settings=CouplingSettings(two_way_coupling_on=True))
    sim.pair_cap = 32 * sim.model.floes.capacity
    return sim


def part_vs_single(spec):
    """tests/test_parallel.py's decomposed-against-single-device checks on
    the card, f64, 5 steps: 1-D over 4 slabs on make_wide_sim's field and
    2-D over 2 x 2 on make_square_sim's, matched by id against the
    single-device step with that test's tolerances.  On the example's own
    field (``example_field_1d``, reported and not checked) the JAX package's
    decomposition leaves xi 1.45e-4 from the single device at a floe whose
    xi is 1e-6 (tests/jax_decomp_reference.py --vs-single): the per-element
    rtol holds on that test's fields, not on every field."""
    import torch.distributed as dist

    from subzero_tpu_torch.parallel import (build_decomp_step, distribute, distribute_2d,
                                            gather, make_decomp, make_decomp_2d, multihost)
    from subzero_tpu_torch.simulation import build_step

    dev = multihost.rank_device(None)
    out = {}
    for name, kind, make, place in (
        ("1d_4_slabs", "wide", lambda fl, dom: make_decomp(fl, dom), distribute),
        ("2d_2x2", "square", lambda fl, dom: make_decomp_2d(fl, dom, n_dev=(2, 2)),
         distribute_2d),
        ("example_field_1d", "example", lambda fl, dom: make_decomp(fl, dom), distribute),
    ):
        base = parallel_test_sim(kind, dev)
        m = base.model
        step = build_step(base)
        f1, o1, d1 = m.floes, m.ocean, m.domain
        for k in range(5):
            f1, o1, d1, ov = step(f1, o1, d1, k)
            if bool(ov):
                raise AssertionError(f"{name}: the single-device step overflowed")
        sim = parallel_test_sim(kind, dev)
        dec = make(sim.model.floes, sim.model.domain)
        fd, od, dd = place(sim.model.floes, sim.model.domain, dec), m.ocean, m.domain
        dstep = build_decomp_step(sim, dec)
        overflow = []
        for k in range(5):
            fd, od, dd, ov = dstep(fd, od, dd, k)
            overflow.append(ov)
        if any(overflow):
            raise AssertionError(f"{name}: a decomposed step overflowed")
        g = gather(fd, dec)
        if dist.get_rank() != 0:
            continue
        a, b = _by_id(f1), _by_id(g)
        if not torch.equal(a.id, b.id):
            raise AssertionError(f"{name}: the pools hold other ids")
        err = {}
        for f, tol in VS_SINGLE_TOL.items():
            x, y = getattr(b, f).double(), getattr(a, f).double()
            bad = (x - y).abs() > tol["atol"] + tol["rtol"] * y.abs()
            err[f] = float(((x - y).abs() / (y.abs() + 1e-300)).max())
            if bool(bad.any()) and kind != "example":
                raise AssertionError(f"{name}: {f} beyond {tol}: {err[f]}")
        s_d, s_1 = od.si_frac.cpu().double(), o1.si_frac.cpu().double()
        if kind != "example" and bool(((s_d - s_1).abs() > VS_SINGLE_SI_FRAC["atol"]
                                       + VS_SINGLE_SI_FRAC["rtol"] * s_1.abs()).any()):
            raise AssertionError(f"{name}: si_frac beyond {VS_SINGLE_SI_FRAC}")
        err["si_frac"] = float(((s_d - s_1).abs() / (s_1.abs() + 1e-300)).max())
        out[name] = {"config": {"wide": "tests/test_parallel.py make_wide_sim",
                                "square": "tests/test_parallel.py make_square_sim",
                                "example": "examples/shear_flow.py's field, f64, "
                                           "unchecked"}[kind],
                     "max_rel_err": err, "local_cap": dec.local_cap,
                     "halo_cap": dec.halo_cap, "floes": int(g.count())}
    return out


def part_determinism(spec):
    """Two runs of 51 steps of the example's field with a fracture pass every
    25 steps (weak ice, so that pieces are made and slabs regrow): bitwise
    equal gathered pools; in the first run, after every host pass, each
    rank's hash of the pool it redistributes is gathered and all are equal
    (every rank runs the host passes alike, without a broadcast)."""
    import hashlib

    import torch.distributed as dist

    from subzero_tpu_torch.parallel import decomp, make_decomp, multihost
    from subzero_tpu_torch.settings import FractureSettings, HiblerYieldCurve

    dev = multihost.rank_device(None)
    fr = FractureSettings(fractures_on=True, criteria=HiblerYieldCurve(pstar=1e-10, c=20.0),
                          dt=25, npieces=2)
    hashes = []
    orig = decomp._dec_distribute

    def hashed(floes, domain, dec, extra=None):
        h = hashlib.sha256()
        for x in floes:
            h.update(x.detach().cpu().numpy().tobytes())
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, h.hexdigest())
        if len(set(every)) != 1:
            raise AssertionError(f"ranks hold different pools after a host pass: {every}")
        hashes.append(every[0][:16])
        return orig(floes, domain, dec, extra=extra)

    runs = []
    for k in range(2):
        sim, _ = _example(torch.float32, 50, dev, writers=None, fracture_settings=fr)
        dec = make_decomp(sim.model.floes, sim.model.domain)
        decomp._dec_distribute = hashed if k == 0 else orig
        try:
            runs.append(_timed_decomp(sim, dec)[0])
        finally:
            decomp._dec_distribute = orig
    a, b = runs
    for name in ("floes", "ocean"):
        for f, x, y in zip(getattr(a.model, name)._fields, getattr(a.model, name),
                           getattr(b.model, name)):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}.{f} differs between two runs")
    st = a.run_stats
    if st["host_pass_count"]["fracture"] != 2 or len(hashes) < 3:
        raise AssertionError(f"host passes {st['host_pass_count']}, hashes {len(hashes)}")
    return {"steps": st["steps"], "bitwise_equal": True,
            "host_pass_count": st["host_pass_count"],
            "pools_hashed": len(hashes), "distinct_pools_hashed": len(set(hashes)),
            "local_cap": [dec.local_cap, st["local_cap"]],
            "active": int(a.model.floes.count())}


def part_scale(spec):
    """20 steps of many_floes_8000's field (chip_smoke.build_sim(8000, 4e5,
    2e3), dense broad phase: owned_rows is dense-only) over 4 slabs: the
    capacities, this rank's B1 rows, its peak device memory, overflow."""
    from subzero_tpu_torch.parallel import make_decomp, multihost
    from subzero_tpu_torch.physics import collisions

    dev = multihost.rank_device(None)
    sim = build_sim(8000, 4e5, 2e3, device=dev, dtype=torch.float32)
    sim.n_dt = 19
    dec = make_decomp(sim.model.floes, sim.model.domain)
    rows = []
    orig = collisions.two_cross_dispatch

    def counted(*args):
        rows.append((int(args[4].shape[0]), args[8]))
        return orig(*args)

    torch.cuda.reset_peak_memory_stats(dev)
    collisions.two_cross_dispatch = counted
    try:
        sim, seconds, launches = _timed_decomp(sim, dec)
    finally:
        collisions.two_cross_dispatch = orig
    counts = _check_launches(sim, launches, "scale")
    check_finite(sim)
    return {"steps": sim.run_stats["steps"], "seconds": seconds,
            "ms_per_step": 1e3 * seconds / sim.run_stats["steps"],
            "capacities": {"local_cap": dec.local_cap, "halo_cap": dec.halo_cap,
                           "mig_cap": dec.mig_cap, "margin": dec.margin,
                           "ext_cap": dec.local_cap + 2 * dec.halo_cap},
            "b1_rows": rows[0][0], "b1_valid_rows_first_last": [
                int(rows[0][1].sum()), int(rows[-1][1].sum())],
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "n_overflow": sim.n_overflow, "kernel_launches": counts,
            "active": int(sim.model.floes.count())}


def part_nccl1(spec):
    """The example's field, f32, with D = 1 through nccl (world size 1: the
    collectives run, no halo), against the single-device step.  Step by
    step, 50 steps: each decomposed step, started from the single-device
    state, lands on the single-device step within 1e-6 of each field's
    largest magnitude (the integrator's fields: or of the forces they
    integrate, ``tendency_floor``); the pools differ in capacity (local_cap
    against the user's), so the one-hot sums may add in another order.  Then
    the free runs (``run_decomp`` and ``run``, 50 steps), whose differences
    are reported: a fuse pass on states that differ in the last bits gives
    fused floes that differ in more."""
    from subzero_tpu_torch.parallel import (build_decomp_step, distribute, make_decomp,
                                            multihost)
    from subzero_tpu_torch.simulation import build_step, run

    dev = multihost.rank_device(None)
    base, _ = _example(torch.float32, 49, dev, writers=None)
    m = base.model
    step = build_step(base)
    states = [(m.floes, m.ocean, m.domain)]
    for k in range(50):
        f, o, d, _ = step(*states[-1], k)
        states.append((f, o, d))
    dec = make_decomp(m.floes, m.domain)
    dstep = build_decomp_step(fork(base), dec)
    worst, bitwise_steps = {}, 0
    for k in range(50):
        f, o, d = states[k]
        fd, od, _, _ = dstep(distribute(f, d, dec), o, d, k)
        same = True
        # the decomposition marks a fuse partner by id, the single device by row
        want_f = states[k + 1][0]
        fw = want_f.fuse_with
        want_f = want_f._replace(fuse_with=torch.where(
            fw >= 0, want_f.id[fw.clamp(min=0).long()], -1).to(fw.dtype))
        want_f = _by_id(want_f)
        floor = tendency_floor(want_f, float(base.dt), CARD_CPU_TOL)
        for name, got, want in (("floes", _by_id(fd), want_f),
                                ("ocean", od, states[k + 1][1])):
            for fld, x, y in zip(want._fields, got, want):
                key = f"{name}.{fld}"
                if x.is_floating_point():
                    # each element within 1e-6 of the field's largest
                    # magnitude, or of the forces it integrates
                    scale = float(y.abs().max())
                    allowed = CARD_CPU_TOL * scale + (floor[fld] if name == "floes" and
                                                      fld in floor else 0.0)
                    ratio = float(((x - y).abs() / allowed).max()) if scale > 0 else float(
                        (x - y).abs().max())
                    worst[key] = max(worst.get(key, 0.0), ratio)
                    if not ratio <= 1.0:
                        raise AssertionError(f"nccl D = 1, step {k}: {key} at {ratio} of "
                                             "its tolerance")
                    same &= torch.equal(x, y)
                elif not torch.equal(x, y):
                    raise AssertionError(f"nccl D = 1, step {k}: {key} differs")
        bitwise_steps += same
    sim = fork(base)
    sim, seconds, launches = _timed_decomp(sim, dec)
    counts = _check_launches(sim, launches, "nccl D = 1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single = run(fork(base))
    got, want = _by_id(sim.model.floes), _by_id(single.model.floes)
    free = {}
    if torch.equal(got.id, want.id):
        free = {f: max_rel_diff(x, y) for f, x, y in zip(want._fields, got, want)
                if x.is_floating_point()}
    return {"step_by_step": {"steps": 50, "tolerance": CARD_CPU_TOL,
                             "worst_share_of_tolerance": worst,
                             "bitwise_equal_steps": bitwise_steps},
            "free_run": {"steps": sim.run_stats["steps"], "seconds": seconds,
                         "same_ids": bool(torch.equal(got.id, want.id)),
                         "max_rel_diff": free},
            "kernel_launches": counts, "local_cap": dec.local_cap,
            "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
            "comm": sim.run_stats["comm"]}


def tendency_floor(ref, dt, rel) -> dict:
    """Absolute floors (per floe) of the integrator's accelerations and of
    the velocities and strain they step, as tests/test_torch_slice.py's
    ``_tendency_atol`` derives them: p_dudt is (fx_oa + collision force) /
    mass and the two can cancel, so it is held to ``rel`` of the forces'
    largest magnitudes over the mass; u adds 1.5 dt p_dudt; likewise v, and
    xi with the torques over the moment; the strain is xi times the floe's
    geometry."""
    def floor(a, b, denom):
        d = torch.where(denom > 0, denom, torch.ones_like(denom))
        return rel * (float(a.abs().max()) + float(b.abs().max())) / d

    cf = ref.collision_force
    acc = {"p_dudt": floor(ref.fx_oa, cf[:, 0], ref.mass),
           "p_dvdt": floor(ref.fy_oa, cf[:, 1], ref.mass),
           "p_dxidt": floor(ref.trq_oa, ref.collision_trq, ref.moment)}
    out = dict(acc, u=1.5 * dt * acc["p_dudt"], v=1.5 * dt * acc["p_dvdt"],
               xi=1.5 * dt * acc["p_dxidt"])
    xi = ref.xi.abs()
    per_xi = ref.strain.abs().amax((1, 2)) / torch.where(xi > 0, xi, torch.ones_like(xi))
    out["strain"] = (out["xi"] * per_xi)[:, None, None]
    return out


def _by_id(floes):
    """The active rows of a pool, ordered by floe id."""
    act = torch.nonzero(floes.active).squeeze(1)
    order = act[torch.argsort(floes.id[act])]
    return type(floes)(*(x[order] for x in floes))


DECOMP_PARTS = {"example": part_example, "card_cpu": part_card_cpu,
                "vs_single": part_vs_single, "determinism": part_determinism,
                "scale": part_scale, "nccl1": part_nccl1}


DECOMP_TURNS = ("this tree", "parent", "parent", "this tree")


def decomp_example_in_turns(parent_dir, tmp) -> list:
    """The distributed example's four gloo ranks (part ``example``) of this
    tree and of the checkout at ``parent_dir`` (its own chip_smoke.py and
    package) in turns: this tree, the parent twice, this tree; ms a step by
    rank, and the single-device run of the same build, of each turn."""
    out = []
    for k, who in enumerate(DECOMP_TURNS):
        ranks = decomp_launch(DECOMP_RANKS, "gloo", ["example"],
                              os.path.join(tmp, f"turn{k + 1}"), DECOMP_TIMEOUT,
                              checkout=parent_dir if who == "parent" else None)
        ex = [r["example"] for r in ranks]
        out.append({"turn": k + 1, "code": who,
                    "ms_per_step_by_rank": [e["ms_per_step"] for e in ex],
                    "single_device_ms_per_step": ex[0]["single_device"]["ms_per_step"]})
    return out


def phase_decomp(dev, report):
    import torch.distributed as dist

    backends = {"nccl": dist.is_nccl_available(), "gloo": dist.is_gloo_available()}
    emit("decomp_backends", **backends,
         note="several ranks on one card run on gloo: NCCL refuses two ranks of one "
              "communicator on the same GPU")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = decomp_launch(DECOMP_RANKS, "gloo", ["example", "card_cpu", "vs_single",
                                                      "determinism", "scale"],
                              tmp, DECOMP_TIMEOUT)
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (nccl1,) = decomp_launch(1, "nccl", ["nccl1"], tmp, 240)
        nccl_s = time.perf_counter() - t0
        four = None
        if torch.cuda.device_count() >= DECOMP_RANKS:
            four = decomp_launch(DECOMP_RANKS, "nccl", ["example"], tmp, 300,
                                 one_card_a_rank=True)
        turns = (decomp_example_in_turns(report["parent_dir"], tmp)
                 if report.get("parent_dir") else None)
    ex = [r["example"] for r in ranks]
    r0 = ranks[0]
    per_rank = [e["kernel_launches"] for e in ex]
    report["launches_by_path"]["decomp step (per rank)"] = [c["step"] for c in per_rank]
    report["launches_by_path"]["decomp host-pass queries (per rank)"] = [
        c["host_pass_queries"] for c in per_rank]
    b2_path(report, "decomp step (per rank)", [c["slow_clip_step"] for c in per_rank])
    b2_path(report, "decomp host-pass queries (per rank)",
            [c["slow_clip_host_pass_queries"] for c in per_rank])
    emit("decomp", config="examples/distributed_shear_flow.py: 500 floes, f32, two-way "
         "coupling, 4 x-slabs, 500 steps, 4 gloo ranks sharing the card",
         rank_processes_seconds=gloo_s, nccl_process_seconds=nccl_s,
         devices=[r["device"] for r in ranks],
         example={"rank0": ex[0],
                  "ms_per_step_by_rank": [e["ms_per_step"] for e in ex],
                  "kernel_launches_by_rank": per_rank,
                  "comm_per_step_by_rank": [e["comm_per_step"] for e in ex]},
         card_cpu=r0["card_cpu"], vs_single=r0["vs_single"],
         determinism=r0["determinism"],
         scale={"by_rank": [{k: r["scale"][k] for k in
                             ("b1_rows", "b1_valid_rows_first_last", "peak_memory_gib",
                              "ms_per_step", "kernel_launches", "capacities")}
                            for r in ranks],
                "steps": r0["scale"]["steps"], "n_overflow": r0["scale"]["n_overflow"],
                "active": r0["scale"]["active"]},
         nccl_world_size_1=nccl1["nccl1"],
         four_cards=(None if four is None else [r["example"] for r in four]),
         example_in_turns_against_parent=turns)
    if four is None:
        print(f"decomp: the four-card NCCL run did not run: this machine has "
              f"{torch.cuda.device_count()} CUDA device(s) and it needs "
              f"{DECOMP_RANKS}, one a rank", flush=True)


# ---------------------------------------------------------------------------
# bench, f32 drift and the host-pass / end-to-end tools
# ---------------------------------------------------------------------------

# the JAX package's fields (BENCH_r05.json): active floes and valid candidate
# pairs at step 0; the port builds the same fields from the same seed
JAX_BENCH_COUNTS = {"shear_flow_500": (509, 1878), "many_floes_2000": (2000, 7124),
                    "many_floes_8000": (8016, 28165), "many_floes_16000": (15988, 56052),
                    "many_floes_32000": (31954, 112694)}
BITWISE_STEPS = 20
# one timed run after the warm-up (the bench takes the best of 4): this phase
# checks the configurations, `python -m subzero_tpu_torch.bench` times them
BENCH_REPS = 1


def segment_sum_card_vs_cpu(dev, N=32000) -> dict:
    """collisions._segment_sum, the contact sums, on the card against the
    CPU on the same rows: the 32k pool's K = 8.5 N rows, f32 and f64, about
    a tenth dropped (idx >= N).  Both add each floe's rows in their order,
    so they agree to the bit.  Returns the card's time a call."""
    from subzero_tpu_torch.physics.collisions import _segment_sum

    g = torch.Generator().manual_seed(SEED)
    K = 17 * N // 2
    out = {"K": K, "N": N}
    for dtype in (torch.float32, torch.float64):
        pay = torch.randn(K, 7, generator=g, dtype=dtype)
        idx = torch.randint(0, N + N // 10, (K,), generator=g)
        pay_d, idx_d = pay.to(dev), idx.to(dev)
        if not torch.equal(_segment_sum(pay_d, idx_d, N).cpu(), _segment_sum(pay, idx, N)):
            raise AssertionError(f"_segment_sum ({dtype}): the card and the CPU differ")
        out[str(dtype).split(".")[-1]] = {
            "bitwise_equal": True,
            "ms": median_ms(lambda: _segment_sum(pay_d, idx_d, N))}
    return out


def slow_path_device_ms(sim, n=5) -> dict:
    """The slow path (``collisions._slow_path``: the step's slow selection,
    then the slow clip's kernel, clip and parity retry) on the state's
    narrow-phase batch: its device time and kernels a call by torch.profiler
    over n calls, the slow clip kernels' own time, and the slow path's share
    of the device's time in one step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from subzero_tpu_torch.physics import collisions as C
    from subzero_tpu_torch.simulation import build_step

    m = sim.model
    nb = C.narrow_phase_batch(m.floes, m.domain, sim.pair_cap, sim.bins)
    tc = C.two_cross_dispatch(*nb.two_cross_args())

    def busy(fn, k):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        own = [e for e in evs if any(x in e.key for x in KERNEL_EVENTS["regions"])]
        return (sum(dev_us(e) for e in evs) / 1e3 / k, sum(e.count for e in evs) / k,
                sum(dev_us(e) for e in own) / 1e3 / k)

    slow = C._slow_path(nb, tc, sim.pair_cap, sim.clip_cap, retry=True)
    ms, kernels, b2_ms = busy(lambda: C._slow_path(nb, tc, sim.pair_cap,
                                                   sim.clip_cap, retry=True), n)
    step = build_step(sim)
    step_ms, step_kernels, _ = busy(lambda: step(m.floes, m.ocean, m.domain, 1), n)
    return {"slow_cap": int(slow.valid.shape[0]), "n_slow_step_0": int(slow.n_slow),
            "device_ms": ms, "device_kernels": kernels, "slow_clip_kernels_ms": b2_ms,
            "step_device_ms": step_ms, "step_device_kernels": step_kernels,
            "share_of_step": ms / step_ms}


def phase_bench(dev, report):
    """``subzero_tpu_torch.bench``'s configurations in this process, checked:
    the JAX field's counts, a finite end state with no floe lost, one kernel
    launch a step; two runs of many_floes_8000 bitwise equal; the kernel
    against its plain version at the 16k and 32k batches.  Prints the
    bench's JSON line from one timed run a configuration, without bench.py's
    phase split (``profile`` splits the step in turns;
    ``python -m subzero_tpu_torch.bench`` times as bench.py does)."""
    from subzero_tpu_torch import bench
    from subzero_tpu_torch.physics.collisions import narrow_phase_batch
    from subzero_tpu_torch.simulation import run_scan

    detail = {"device": {"name": torch.cuda.get_device_name(0),
                         "nvidia_smi": bench.nvidia_smi()}}
    setup, kernel, bitwise, slow_path = {}, {}, None, {}
    for name, cfg in bench.CONFIGS.items():
        t0 = time.perf_counter()
        sim = bench.build_sim(cfg["n"], cfg["L"], bench.DX, bins=cfg["bins"], device=dev)
        setup[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_launches()
        r = bench.measure(sim, cfg["n_steps"], reps=BENCH_REPS)
        launches, b2 = path_launches(), path_launches("regions")
        want = (1 + BENCH_REPS) * cfg["n_steps"]
        if (r["n_floes"], r["pairs_per_step"]) != JAX_BENCH_COUNTS[name]:
            raise AssertionError(f"{name}: floes and pairs {r['n_floes']}, "
                                 f"{r['pairs_per_step']}; the JAX field's "
                                 f"{JAX_BENCH_COUNTS[name]}")
        if not r["finite"] or r["n_floes_end"] != r["n_floes"]:
            raise AssertionError(f"{name}: finite {r['finite']}, floes "
                                 f"{r['n_floes']} -> {r['n_floes_end']}")
        if launches != want or b2 != b2_per_step() * want:
            raise AssertionError(f"{name}: kernels launched {launches} (B1) and {b2} "
                                 f"(B2) times in {want} steps")
        report["launches_by_path"][f"run_scan step (bench {name})"] = launches
        b2_path(report, f"run_scan step (bench {name})", b2)
        r["pairs_per_s"] = round(r["pairs_per_s"], 1)
        if name == "many_floes_8000":
            a, _ = run_scan(fork(sim), BITWISE_STEPS)
            b, _ = run_scan(fork(sim), BITWISE_STEPS)
            same_state(a, b, name)
            bitwise = {"config": name, "n_steps": BITWISE_STEPS, "bitwise_equal": True}
            del a, b
        if name in ("many_floes_8000", "many_floes_16000", "many_floes_32000"):
            slow_path[name] = slow_path_device_ms(sim)
        if name in ("many_floes_16000", "many_floes_32000"):
            nb = narrow_phase_batch(sim.model.floes, sim.model.domain, sim.pair_cap,
                                    sim.bins)
            kernel[name] = {"check": check_main_path_batch(nb, name, report),
                            "timing": time_kernel(nb.two_cross_args())}
            # the slow clip on the slow rows 20 steps in (none at step 0)
            m = run_scan(fork(sim), 20)[0].model
            nb = narrow_phase_batch(m.floes, m.domain, sim.pair_cap, sim.bins)
            kernel[name]["slow_clip_20_steps_in"] = regions_on_batch(
                nb, sim.pair_cap, sim.clip_cap, name, report)
            report.setdefault("bench_kernel", {})[name] = kernel[name]["timing"]
            del nb, m
        detail[name] = r
        del sim
        torch.cuda.empty_cache()
    line = bench.result_line(detail)
    print(json.dumps(line), flush=True)
    report["bench_detail"] = detail
    emit("bench", counts_equal_jax=True, host_setup_seconds=setup,
         determinism=bitwise, kernel=kernel, slow_path=slow_path,
         graph={k: {f: detail[k][f] for f in ("capture_s", "captures", "recaptures",
                                              "peak_mem_gib", "peak_reserved_gib",
                                              "capture_pool_gib")}
                for k in bench.CONFIGS},
         segment_sum=segment_sum_card_vs_cpu(dev))


# tests/test_f32_drift.py: percent drift after 5 000 f32 steps
F32_DRIFT_STEPS = 5000
F32_DRIFT_BOUNDS = {"head_on": {"ke": 0.01, "px": 0.01, "py": 0.01, "l": 0.2},
                    "three_floes": {"ke": 0.01, "px": 0.01, "py": 0.01, "l": 1.0}}


F32_DRIFT_TIMEOUT = 900  # seconds for a scenario's process, start-up included


def f32_drift_run(scenario: str, dev) -> dict:
    """One scenario of the gate: 5 000 f32 steps of conservation_run on
    ``dev``, the kernel's launches counted from 0 just before."""
    from subzero_tpu_torch.tools.scenarios import conservation_run

    reset_launches()
    t0 = time.perf_counter()
    drift, sim = conservation_run(torch.float32, scenario, F32_DRIFT_STEPS, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_finite(sim)
    return {"drift_percent": drift, "seconds": seconds,
            "ms_per_step": 1e3 * seconds / F32_DRIFT_STEPS,
            "kernel_launches": path_launches(),
            "slow_clip_launches": path_launches("regions")}


def phase_f32_drift(dev, report):
    """The JAX package's f32 conservation gate on the card, through the
    kernel: head_on and three_floes, 5 000 f32 steps each, one process a
    scenario, both at once (each step is host-bound); every process is
    killed at the first failure or at its time limit."""
    logs = {sc: tempfile.TemporaryFile(mode="w+") for sc in F32_DRIFT_BOUNDS}
    procs = {sc: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--f32-drift", sc],
        stdout=logs[sc], stderr=subprocess.STDOUT, text=True)
        for sc in F32_DRIFT_BOUNDS}
    out = {}
    try:
        for sc, proc in procs.items():
            proc.wait(timeout=F32_DRIFT_TIMEOUT)
            logs[sc].seek(0)
            text = logs[sc].read()
            if proc.returncode != 0:
                raise RuntimeError(f"f32_drift {sc} failed:\n{text}")
            out[sc] = json.loads(text.strip().splitlines()[-1])
    finally:
        for sc, proc in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logs[sc].close()
    for sc, bounds in F32_DRIFT_BOUNDS.items():
        r, drift = out[sc], out[sc]["drift_percent"]
        if (r["kernel_launches"], r["slow_clip_launches"]) != (
                F32_DRIFT_STEPS, b2_per_step() * F32_DRIFT_STEPS):
            raise AssertionError(f"{sc}: kernels launched {r['kernel_launches']} (B1) and "
                                 f"{r['slow_clip_launches']} (B2) times in "
                                 f"{F32_DRIFT_STEPS} steps")
        over = {k: drift[k] for k, b in bounds.items() if not abs(drift[k]) < b}
        if over:
            raise AssertionError(f"{sc}: f32 drift beyond the JAX bounds "
                                 f"{bounds} (percent): {over}")
        report["launches_by_path"][f"run_scan step (f32_drift {sc})"] = r["kernel_launches"]
        b2_path(report, f"run_scan step (f32_drift {sc})", r["slow_clip_launches"])
        r["bounds_percent"] = bounds
    emit("f32_drift", dtype="float32", n_steps=F32_DRIFT_STEPS, **out)


def phase_e2e_shear_flow(dev, report):
    """tools/e2e_shear_flow.py's run on the card: shear_flow, 5 000 steps of
    run with its floe writer every 50 steps (the file half kept in memory
    where there is no h5py), 16 candidate rows a floe; fails on any step
    over capacity, as the tool exits 1."""
    from subzero_tpu_torch.tools import e2e_shear_flow as e2e

    files = h5py_available()
    with tempfile.TemporaryDirectory() as tmp:
        sim = e2e.build(tmp, device=dev)
        sim.verbose = False
        kept = None if files else keep_in_memory(sim.writers)
        reset_launches()
        r = e2e.run_counted(sim)
        launches = path_launches()
    sim = r.pop("sim")
    check_finite(sim)
    passes = sum(sim.run_stats["host_pass_launches"]["two_cross"].values())
    report["launches_by_path"]["run step (e2e_shear_flow)"] = launches - passes
    floe_events = len(kept["floes"]) if kept else None
    emit("e2e_shear_flow", files=files, floe_writer_events=floe_events,
         kernel_launches={"step": launches - passes, "host_passes": passes},
         host_pass_seconds=sim.run_stats["host_pass_seconds"], **r)
    if r["n_overflow_steps"]:
        raise AssertionError(f"e2e_shear_flow: {r['n_overflow_steps']} steps over capacity")


def phase_lifecycle_walltime(dev, report):
    """tools/lifecycle_walltime.py on the card: each host pass on the
    8 016-floe pool against many_floes_8000's step at the pass's cadence."""
    from subzero_tpu_torch.tools import lifecycle_walltime

    emit("lifecycle_walltime", **lifecycle_walltime.walltime(device=dev))


PROBE_LINES = 10   # flagged steps printed per probed run
OVERFLOW_PROBE_STEPS = 2000   # the JAX tool's default


def probe_counted(fn):
    """``fn()`` with the kernel's launches counted from 0 (overflow notes
    muted); returns (its result, launches)."""

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
    return out, path_launches()


def phase_overflow_source(dev, report):
    """tools/probe_overflow_source.py through the port's tool, on the card:
    which capacity fires the overflow flag.  Its own configuration
    (shear_flow, 2 000 steps stepped with build_step, 16 candidate rows a
    floe, clip_cap 32); the life-cycle run (examples/many_floes.py as the
    lifecycle phase runs it, 601 steps of run, probed through run's
    callback) against the same run without the callback, which must count
    the same overflow steps, and on its final pool the terms of the host
    passes' overlap query; simple_strait's step 0 at its width.  Hit totals
    by term and the crowded floe of each."""
    from subzero_tpu_torch.examples import simple_strait
    from subzero_tpu_torch.simulation import run
    from subzero_tpu_torch.tools import probe_overflow_source as probe

    by_path = report["launches_by_path"]
    lines = []

    def out(line):
        if len(lines) < PROBE_LINES:
            lines.append(line)

    sim = probe.build(OVERFLOW_PROBE_STEPS, dev)
    shear, n = probe_counted(lambda: probe.probe_steps(sim, OVERFLOW_PROBE_STEPS, out=out))
    by_path["build_step + probe (overflow_source, shear_flow 16N)"] = n
    if n != 2 * shear["steps"]:
        raise AssertionError(f"shear_flow probe: {n} launches in {shear['steps']} steps")
    shear["printed"], lines = lines, []

    base = build_many_floes(1000, device=dev, dtype=torch.float32, n_dt=LIFECYCLE_N_DT)
    probed, n = probe_counted(lambda: probe.probe_run(fork(base), out=out))
    by_path["run step + probe (overflow_source, life cycle)"] = n
    plain, n_plain = probe_counted(lambda: run(fork(base)))
    by_path["run step (overflow_source, life cycle without the probe)"] = n_plain
    if probed["n_overflow"] != plain.n_overflow:
        raise AssertionError(f"life cycle: {probed['n_overflow']} overflow steps with the "
                             f"probe as callback, {plain.n_overflow} without")
    probed["printed"], lines = lines, []
    check_finite(plain)
    final_terms, n = probe_counted(lambda: probe.overlap_query_terms(
        plain, plain.model.floes, plain.model.domain))
    by_path["overlap query terms (overflow_source, life cycle final pool)"] = n

    strait = simple_strait.build(device=dev)
    strait.verbose = False
    step0, n = probe_counted(lambda: probe.probe_steps(strait, 1, out=out))
    by_path["build_step + probe (overflow_source, simple_strait step 0)"] = n
    step0["printed"] = lines
    emit("overflow_source", dtype="float32",
         shear_flow={"config": "examples/shear_flow.py, 16 candidate rows a floe, "
                               "clip_cap 32", **shear},
         life_cycle={"config": "examples/many_floes.py, 1000 floes in a pool of 2000, "
                               "601 steps of run", "probed": probed,
                     "n_overflow_without_probe": plain.n_overflow,
                     "final_pool_overlap_query_terms": final_terms},
         simple_strait_step_0={"config": "examples/simple_strait.py at its width",
                               **step0})


def tool_ranks(module, args, tag, timeout):
    """The port's ``tools.<module>`` as DECOMP_RANKS gloo rank processes
    sharing the card; returns each rank's JSON line (its last line)."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = launch_ranks([sys.executable, "-m", f"subzero_tpu_torch.tools.{module}",
                             *args, "--backend", "gloo"], DECOMP_RANKS, tag, tmp, timeout)
        out = []
        for log in logs:
            with open(log) as f:
                text = f.read()
            out.append(json.loads(text.strip().splitlines()[-1]))
        table = [ln for ln in open(logs[0]).read().splitlines() if ln.startswith("|")]
    for r in out[1:]:
        if {k: v for k, v in r.items() if k != "rank"} != \
                {k: v for k, v in out[0].items() if k != "rank"}:
            raise AssertionError(f"{module}: rank {r['rank']} printed other figures than rank 0")
    return out, table


NOT_SCALING = "4 gloo ranks on one card: not a scaling figure"


def phase_scaling(dev, report):
    """tools/measure_scaling.py through the port's tool at its defaults
    (8 000 floes, 15 steps) as 4 gloo ranks sharing the card: comm
    isolation against COMM_IDENTITY, bytes a step against
    comm_bytes_per_step, the NVLink projection from this card's own
    t_slab; and through nccl, one rank a card, where there are four."""
    torch.cuda.empty_cache()
    figs, table = tool_ranks("measure_scaling", [], "scaling", 600)
    res = figs[0]
    by_path = report["launches_by_path"]
    for r in res["rows"]:
        if r["identity_exchange_bytes_per_step"] != 0 or r["exchange_bytes_per_step"] <= 0:
            raise AssertionError(f"scaling: exchange bytes of {r['configuration']}: "
                                 f"{r['exchange_bytes_per_step']} (identity "
                                 f"{r['identity_exchange_bytes_per_step']})")
        if r["kernel_launches"] != r["steps"]:
            raise AssertionError(f"scaling: {r['kernel_launches']} launches in "
                                 f"{r['steps']} steps of {r['configuration']}")
        by_path[f"decomp step (scaling, {r['configuration']}, rank 0)"] = r["kernel_launches"]
    for nd, r in res["run_decomp_fracture"].items():
        by_path[f"run_decomp fracture-on (scaling, {nd} rank(s), rank 0)"] = r["kernel_launches"]
    emit("scaling", note=NOT_SCALING, table=table, **res)
    if torch.cuda.device_count() >= DECOMP_RANKS:
        with tempfile.TemporaryDirectory() as tmp:
            logs = launch_ranks([sys.executable, "-m", "subzero_tpu_torch.tools.measure_scaling"],
                                DECOMP_RANKS, "scaling_nccl", tmp, 600, one_card_a_rank=True)
            emit("scaling_nccl", **json.loads(open(logs[0]).read().strip().splitlines()[-1]))
    else:
        print(f"scaling: {NOT_SCALING}; the nccl run needs {DECOMP_RANKS} cards, one a "
              f"rank, and this machine has {torch.cuda.device_count()}", flush=True)


def phase_lifecycle_overhead(dev, report):
    """tools/lifecycle_overhead.py through the port's tool as 4 gloo ranks
    sharing the card: run_decomp of the JAX tool's field at 1 rank and at 4,
    the rows the host passes are handed, their count and mean time."""
    torch.cuda.empty_cache()
    figs, _ = tool_ranks("lifecycle_overhead", [], "lifecycle_overhead", 600)
    runs = figs[0]["runs"]
    for nd, r in runs.items():
        if r["kernel_launches"] != r["steps"] + r["host_pass_launches"]:
            raise AssertionError(f"lifecycle_overhead at {nd} rank(s): "
                                 f"{r['kernel_launches']} launches in {r['steps']} steps")
        report["launches_by_path"][f"run_decomp (lifecycle_overhead, {nd} rank(s), rank 0)"] = \
            r["kernel_launches"]
    emit("lifecycle_overhead", note=NOT_SCALING, backend=figs[0]["backend"],
         runs=runs, gathered_rows_by_rank=[f["runs"][str(DECOMP_RANKS)]["gathered_rows"]
                                           for f in figs])


# seeds of the size the benchmark's runs take: large, some past 2**31
MEMORY_SEEDS = (2147517027, 2147483922, 1363216564, 2147483959, 3000000017, 77)


def transient_gib(fn) -> float:
    """The most ``fn`` allocated on the card beyond what was allocated
    before it (its outputs dropped), GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_memory_by_seed(dev, report):
    """What field_16k.scan's device memory (device_mem_gib: the reserved
    peak over set-up and window) is made of, seed by seed: the benchmark's
    own build of the cell (benchmark.harness), the seed's bins (nbx, nby,
    M), pool and sub-floe points a floe (the largest floe's count), the
    transient peaks of an eager broad phase (the step's narrow-phase
    batch) and of an eager coupling at the start state, each program's
    capture pool, and the allocated and reserved peaks after the warm-up and
    after one pass of the cell's calls."""
    from benchmark import harness
    from benchmark.inputs import make_inputs
    from subzero_tpu_torch.physics import collisions
    from subzero_tpu_torch.physics import coupling as C

    gib = 2**30
    cell = harness.load_cell("field_16k.scan")
    port = harness.port_package()
    out = []
    for seed in MEMORY_SEEDS:
        harness.free()
        torch.cuda.reset_peak_memory_stats()
        sim = harness.build_program(cell, make_inputs(cell.cfg, seed), dev)
        m = sim.model
        row = {"seed": seed, "bins": list(sim.bins) if sim.bins else None,
               "pool": int(m.floes.capacity),
               "points_per_floe": int(m.floes.sub_x.shape[1]),
               "state_gib": torch.cuda.memory_allocated() / gib}
        row["broad_phase_transient_gib"] = transient_gib(
            lambda: collisions.narrow_phase_batch(m.floes, m.domain, sim.pair_cap,
                                                  sim.bins))
        row["coupling_transient_gib"] = transient_gib(
            lambda: C.timestep_coupling(m.floes, m.grid, m.domain, m.ocean, m.atmos,
                                        sim.consts, sim.coupling_settings,
                                        sim.floe_settings, sim.dt, sim.cell_cap))
        harness.free()
        torch.cuda.reset_peak_memory_stats()
        driver = harness.Driver(sim, cell, port.simulation)
        harness.warm_up(driver)
        torch.cuda.synchronize()
        row.update(
            capture_pool_gib={"/".join(map(str, p)): b / gib
                              for p, b in sim._graph.capture_pool_bytes.items()},
            warm_up_allocated_peak_gib=torch.cuda.max_memory_allocated() / gib,
            warm_up_reserved_peak_gib=torch.cuda.max_memory_reserved() / gib)
        for k in range(cell.calls_per_pass):
            driver.call(k)
        torch.cuda.synchronize()
        row.update(pass_allocated_peak_gib=torch.cuda.max_memory_allocated() / gib,
                   pass_reserved_peak_gib=torch.cuda.max_memory_reserved() / gib)
        out.append(row)
        emit("memory_by_seed_row", **row)
        sim._graph = None
        del sim, m, driver
    harness.free()
    emit("memory_by_seed", cell="field_16k.scan", rows=out)


def step_ms(sim, n_steps) -> float:
    from subzero_tpu_torch.simulation import run_scan

    replay_from(sim, 5)  # warm-up: captures the graphs that sim keeps
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

    # the op table from eager steps: a graph's replay runs the same kernels
    # but records no host op for the profiler to charge them to
    n = 20
    sim, _ = run_scan(cfg(), 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scan(sim, n, _eager=True)
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
                   "calls_per_step": e.count / n} for e in ops[:15]],
         top_kernels=[{"kernel": e.key[:80], "device_ms_per_step": dev_us(e) / 1e3 / n,
                       "calls_per_step": e.count / n}
                      for e in sorted(kernels, key=dev_us, reverse=True)[:15]])


def main(argv=None) -> int:
    faulthandler.enable()  # a crash in native code prints the Python stack
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="a checkout of an earlier commit: its kernels and "
                    "this tree's on the phases' batches in turns, and with "
                    "the bench phase its bench and this tree's in turns")
    ap.add_argument("--parent-worker", metavar="FILE", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--decomp-rank", metavar="FILE", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--f32-drift", metavar="SCENARIO", default=None,
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
    if opts.decomp_rank:
        return decomp_rank(opts.decomp_rank)
    if opts.f32_drift:
        print(json.dumps(f32_drift_run(opts.f32_drift, torch.device("cuda", 0))),
              flush=True)
        return 0
    from subzero_tpu_torch.bench import nvidia_smi

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)

    from concurrent.futures import ThreadPoolExecutor

    from subzero_tpu_torch import tracing
    from subzero_tpu_torch.geometry import regions, two_cross

    # one nvcc a kernel library, all at once (the slow clip's clocked
    # build only where the regions phase reads it; the layer marks' library
    # here too, so that no capture builds it)
    with ThreadPoolExecutor(4) as pool:
        marks_build = pool.submit(tracing.build, force=True)
        builds = [pool.submit(k.build, force=True) for k in (two_cross, regions)]
        clocked = (pool.submit(regions.build_clocked, force=True)
                   if {"regions", "bench"} & set(phases) else None)
        info, info_b2 = (b.result() for b in builds)
        info_clock = clocked.result() if clocked else None
        info_marks = marks_build.result()

    def ptxas_of(build):
        return [ln.strip() for ln in build["log"].splitlines()
                if "registers" in ln or "spill" in ln]
    # the native host clip (g++; host C++, not a GPU kernel): the life-cycle
    # passes use it, and the run fails if it does not build here
    from subzero_tpu_torch import native

    t0 = time.perf_counter()
    if os.environ.get("SUBZERO_NATIVE", "1") != "0" and not (
            native.build(force=True) and native.available()):
        raise RuntimeError("g++ build of subzero_tpu_torch/native/clip.cpp failed")
    emit("build", seconds=info["seconds"], library=info["path"], ptxas=ptxas_of(info),
         slow_clip={"seconds": info_b2["seconds"], "library": info_b2["path"],
                    "ptxas": ptxas_of(info_b2)},
         slow_clip_clocked=info_clock and {"seconds": info_clock["seconds"],
                                           "ptxas": ptxas_of(info_clock)},
         layer_marks={"seconds": info_marks["seconds"], "ptxas": ptxas_of(info_marks)},
         native_clip={"served_by": "native" if native.available() else "python",
                      "library": str(native.LIB_PATH),
                      "seconds": time.perf_counter() - t0})

    report = {"launches_by_path": {}, "runs_on_the_card": {}, "parent_dir": opts.parent}
    # every phase in the order of PHASES + EXTRA_PHASES; the rank processes
    # of decomp share the card, so the cache is emptied before them
    run_phase = {
        "kernel": phase_kernel, "slice": phase_slice,
        "card_cpu": lambda d, r: phase_card_cpu(d),
        "determinism": lambda d, r: phase_determinism(d),
        "many_floes_2000": phase_many_floes, "binned": phase_binned,
        "overlaps": phase_overlaps, "lifecycle": phase_lifecycle,
        "regions": phase_regions, "forces": phase_forces, "cell_clip": phase_cell_clip,
        "graph": phase_graph,
        "lifecycle_card_cpu": phase_lifecycle_card_cpu, "writers": phase_writers,
        "restart": phase_restart, "bench": phase_bench, "f32_drift": phase_f32_drift,
        "decomp": lambda d, r: (torch.cuda.empty_cache(), phase_decomp(d, r)),
        "profile": lambda d, r: phase_profile(d),
        "e2e_shear_flow": phase_e2e_shear_flow,
        "lifecycle_walltime": phase_lifecycle_walltime,
        "overflow_source": phase_overflow_source, "scaling": phase_scaling,
        "lifecycle_overhead": phase_lifecycle_overhead,
        "memory_by_seed": phase_memory_by_seed,
    }
    seconds = {}
    for name in PHASES + EXTRA_PHASES:
        if name in phases and name in run_phase:
            t0 = time.perf_counter()
            run_phase[name](dev, report)
            seconds[name] = time.perf_counter() - t0
    if opts.parent and "bench" in phases:
        t0 = time.perf_counter()
        emit("bench_vs_parent", checkout=opts.parent, **bench_in_turns(opts.parent, dev))
        seconds["bench_vs_parent"] = time.perf_counter() - t0
    if opts.parent and report.get("parent_batches"):
        t0 = time.perf_counter()
        emit("kernels_vs_parent", checkout=opts.parent,
             **kernels_vs_parent(opts.parent, report))
        seconds["kernels_vs_parent"] = time.perf_counter() - t0
    emit("seconds", by_phase=seconds, partial_traces_taken_again=PARTIAL_TRACES)

    from subzero_tpu_torch import step_graph

    # the kernel's numbers at the main path's batch (shear_flow_500 after 20
    # steps): ms is its own device time, call_ms the whole Python call;
    # launches is the slice phase's count
    t = report.get("timing", {})
    t2 = report.get("regions_timing", {})
    t4 = report.get("forces_timing", {})
    t6 = report.get("cell_clip_timing", {}).get("field_16k", {})
    print(json.dumps({"kernels": [{
        "name": "two_cross",
        "route": "cuda",
        "source": "subzero_tpu_torch/csrc/two_cross.cu",
        "replaces": "subzero_tpu/geometry/pallas_clip.py:52",
        "launches": report.get("launches"),
        # every path that launched it in this run, each counted from 0 (a
        # step graph's replay counts the launches it captured)
        "launches_by_path": report["launches_by_path"],
        # launched by the step graphs' warm-ups, before each capture
        "graph_warmup_launches": step_graph.warmup_launch_count(),
        # the kernel's runs on the card (torch.profiler) in one replay of
        # each captured program, equal to what the replay adds to the count
        # (graph phase)
        "runs_on_the_card_by_replay": report["runs_on_the_card"],
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
        # the wide instantiation (rings of 40 vertices, the kernel phase's
        # star rings, 6 144 rows): its own device time, plain, bound
        "wide": {k: report.get("timing_wide", {}).get(k)
                 for k in ("B", "V", "device_ms", "plain_ms", "bound_ms", "bound_by")},
    }, {
        # the slow clip at shear_flow_500's slow batch after 20 steps (the
        # regions phase): ms is its kernel's own device time, clip and retry
        # in one launch; launches is the slice phase's count (one a step)
        "name": "intersect_regions",
        "route": "cuda",
        "source": "subzero_tpu_torch/csrc/intersect_regions.cu",
        "replaces": "subzero_tpu/geometry/clip.py:188 (jnp, fused by XLA; "
                    "run by subzero_tpu/physics/collisions.py:1336-1403)",
        "launches": report.get("b2_launches"),
        "launches_by_path": report.get("b2_launches_by_path", {}),
        "graph_warmup_launches": step_graph.warmup_launch_count("regions"),
        "runs_on_the_card_by_replay": report.get("b2_runs_on_the_card", {}),
        "max_abs_err": report.get("regions_max_abs_err"),
        "ms": t2.get("device_ms"),
        "plain_ms": t2.get("plain_ms"),
        "bound_ms": t2.get("bound_ms"),
        "bound_by": t2.get("bound_by"),
        "library_ms": None,  # no one PyTorch call computes this function
        **{k: t2.get(k) for k in ("device_ms_n_slow_0", "bound_ms_n_slow_0",
                                  "queued_ms", "empty_device_ms", "call_ms",
                                  "live_rows")},
        # every slow batch of this run (regions and bench phases; the
        # lattice's retries and the wide rings' CAP 48 among them)
        "by_batch": report.get("regions_by_batch", {}),
    }, {
        # the force law at shear_flow_500's contact lists after 20 steps (the
        # forces phase): ms is its kernel's own device time, one launch a step
        "name": "forces",
        "route": "cuda",
        "source": "subzero_tpu_torch/csrc/forces.cu",
        "replaces": "the elementwise force law of subzero_tpu/physics/collisions.py "
                    "(_region_forces and the fuse / remove marking; jnp, fused by XLA)",
        "graph_warmup_launches": step_graph.warmup_launch_count("forces"),
        "ms": t4.get("device_ms"),
        "plain_ms": t4.get("plain_ms"),
        "bound_ms": t4.get("bound_ms"),
        "bound_by": t4.get("bound_by"),
        "library_ms": None,  # no one PyTorch call computes this function
        **{k: t4.get(k) for k in ("queued_ms", "empty_device_ms", "plain_device_ops",
                                  "items", "bytes")},
    }, {
        # the coupling's cell clip at field_16k's coupling windows after 20
        # steps (the cell_clip phase): ms is its kernel's own device time,
        # one launch on each coupled step; by_field holds shear_flow_500's too
        "name": "cell_clip",
        "route": "cuda",
        "source": "subzero_tpu_torch/csrc/cell_clip.cu",
        "replaces": "subzero_tpu/physics/coupling.py:_clip_area_to_rects (jnp, fused "
                    "by XLA)",
        "launches_by_path": report.get("b6_launches_by_path", {}),
        "graph_warmup_launches": step_graph.warmup_launch_count("cell_clip"),
        "runs_on_the_card_by_replay": report.get("b6_runs_on_the_card", {}),
        "ms": t6.get("device_ms"),
        "plain_ms": t6.get("plain_ms"),
        "bound_ms": t6.get("bound_ms"),
        "bound_by": t6.get("bound_by"),
        "library_ms": None,  # no one PyTorch call computes this function
        **{k: t6.get(k) for k in ("queued_ms", "plain_device_ops", "kept_cells",
                                  "bytes", "operations")},
        "by_field": report.get("cell_clip_timing", {}),
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
