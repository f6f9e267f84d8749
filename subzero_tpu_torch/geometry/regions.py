"""The slow clip's CUDA kernel (B2): build, bind, launch.

``csrc/intersect_regions.cu`` (per-row arithmetic in
``csrc/intersect_regions.cuh``) is the general multi-region clip of the
step's slow rows, the port's counterpart of the JAX package's jnp
``subzero_tpu/geometry/clip.py:intersect_regions`` as
``subzero_tpu/physics/collisions.py`` runs it, tier ladder and parity retry
included (its ``lax.cond``s): the kernel reads the number of slow rows on
the device, rows past it do no work, and a row whose parity comes out odd is
retried at once by its own warp; the last row to finish (a ticket in the
call's own buffer, zeroed by the launch) puts the first result back on any
odd row past the first 16 in row order (the JAX rule).
It takes the ring pools (rings of up to MAX_VERTS vertices), the candidate
list and the slow selection, gathers each row's rings itself (a warp a row,
its scratch in dynamic shared memory laid out for rings of up to 32 vertices
and 32 crossing slots, or for anything up to MAX_VERTS and MAX_CAP) and
writes one packed output.  It is compiled at first use with
``nvcc`` into ``subzero_tpu_torch/_build/libregions.so`` (rebuilt when a
source is newer; the flags of ``two_cross.py``), loaded with ``ctypes`` and
launched on PyTorch's current stream without synchronising: one launch a
call, clip and retry (after an 8-byte memset of the ticket when it retries).

The plain PyTorch version is ``slow_regions_plain`` (the clip of every row
through ``clip.intersect_regions`` and the retry's merge);
``intersect_regions_dispatch`` sends CUDA tensors to the kernel and CPU
tensors to the plain version.  ``held_against_plain`` holds a result of the
kernel (or of its host shim) against the plain version: the one comparison
that the tests and ``chip_smoke.py`` make.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from . import two_cross
from .clip import ClipRegions, first_true, intersect_regions

# the force law's kernel (B4, physics/forces.py) and the coupling's cell
# clip (B6, physics/cell_clip.py) are built into this library, so that
# every build of the slow clip builds them too
SOURCES = (two_cross.CSRC_DIR / "intersect_regions.cu",
           two_cross.CSRC_DIR / "intersect_regions.cuh",
           two_cross.CSRC_DIR / "two_cross.cuh",
           two_cross.CSRC_DIR / "forces.cu",
           two_cross.CSRC_DIR / "forces.cuh",
           two_cross.CSRC_DIR / "cell_clip.cu",
           two_cross.CSRC_DIR / "cell_clip.cuh")
MAX_CAP = 64     # crossings a row keeps: two a lane
MAX_VERTS = two_cross.MAX_VERTS  # the widest ring, as the narrow phase's
# the retry's perturbation: the first one flipped and scaled
# (subzero_tpu/physics/collisions.py:1386)
RETRY_SCALE = -41.0
# launches of one call with a retry: the clip retries its odd rows itself
LAUNCHES_WITH_RETRY = 1

# the phases of a row's chain that the clocked build stamps
# (intersect_regions.cu, SZ_REGIONS_CLOCK), then the retry's whole chain
CLOCK_PHASES = ("gather", "crossing_sweep", "prefix_sums", "ranks_and_next",
                "arcs", "pointer_doubling", "region_sums", "containment",
                "store", "retry")

_lib = None
_clock_lib = None


_counter = two_cross.LaunchCounter()
launch_count = _counter.launch_count
reset_launch_count = _counter.reset_launch_count
captured_count = _counter.captured_count
add_replayed = _counter.add_replayed


def build(force: bool = False) -> dict:
    """Compile the kernel library if it is missing or older than a source."""
    return two_cross.build_library("regions", SOURCES, force)


def _load():
    global _lib
    if _lib is None:
        info = build()
        lib = ctypes.CDLL(info["path"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, real in (("sz_regions_f32", ctypes.c_float),
                           ("sz_regions_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            # pverts pnv N V qverts qnv NQ W qi qj shift perturb PC ssel R
            # n_slow cap retry_scale retry_rows out scratch stream
            fn.argtypes = [p, p, i, i, p, p, i, i, p, p, p, p, ll, p, i, p, i,
                           real, i, p, p, p]
            fn.restype = ctypes.c_int
        _lib = two_cross.bind_common(lib)
    return _lib


def build_clocked(force: bool = False) -> dict:
    """Compile the library with per-phase clock stamps (-DSZ_REGIONS_CLOCK)
    into ``_build/libregions_clock.so``: a measuring build, which the main
    path never loads."""
    return two_cross.build_library("regions_clock", SOURCES, force,
                                   defines=("-DSZ_REGIONS_CLOCK",))


def clocked_cycles(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, ssel,
                   n_slow, cap: int, retry_rows: int) -> torch.Tensor:
    """One launch of the clocked build on ``regions_cuda``'s arguments: the
    SM clock cycles of each row's phases (CLOCK_PHASES) as lane 0 of its
    warp stamped them, [R, len(CLOCK_PHASES)] int64 on the card; zeros for
    a row that was not clipped (or not retried).  Not counted as a launch."""
    global _clock_lib
    _check_inputs(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, ssel,
                  n_slow, cap, retry_rows)
    if _clock_lib is None:
        lib = ctypes.CDLL(build_clocked()["path"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, real in (("sz_regions_clocked_f32", ctypes.c_float),
                           ("sz_regions_clocked_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, i, i, p, p, i, i, p, p, p, p, ll, p, i, p, i,
                           real, i, p, p, p, p]
            fn.restype = ctypes.c_int
        _clock_lib = two_cross.bind_common(lib)
    lib, R, dtype, dev = _clock_lib, ssel.shape[0], p_verts.dtype, p_verts.device
    clk = torch.zeros((R, len(CLOCK_PHASES)), dtype=torch.int64, device=dev)
    buf = alloc_output(R, cap, dtype, dev)
    fn = lib.sz_regions_clocked_f64 if dtype == torch.float64 else lib.sz_regions_clocked_f32
    with two_cross._on_device(dev):
        rc = fn(
            p_verts.data_ptr(), p_n.data_ptr(), p_verts.shape[0], p_verts.shape[1],
            q_verts.data_ptr(), q_n.data_ptr(), q_verts.shape[0], q_verts.shape[1],
            qi.data_ptr(), qj.data_ptr(), shift.data_ptr(), perturb.data_ptr(),
            qi.shape[0], ssel.data_ptr(), R, n_slow.data_ptr(), cap,
            RETRY_SCALE, retry_rows, buf.data_ptr(),
            buf.data_ptr() + scratch_offset(R, cap, dtype), clk.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    two_cross._raise_if(lib, rc, "clocked slow clip kernel")
    return clk


def _check_inputs(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, ssel,
                  n_slow, cap, retry_rows):
    """Raise on what the kernel does not take, its limits first.  Reads only
    the tensors' metadata: nothing synchronises."""
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"the slow clip's kernel keeps at most {MAX_CAP} "
                         f"crossings a row (CAP <= {MAX_CAP}, MAX_CAP); got CAP = {cap}")
    for name, x in (("p_verts", p_verts), ("q_verts", q_verts)):
        if x.dim() == 3 and x.shape[1] > MAX_VERTS:
            raise ValueError(f"the slow clip's kernel takes rings of at most "
                             f"{MAX_VERTS} vertices (MAX_VERTS); {name} is "
                             f"{x.shape[1]} wide")
    if not 0 <= retry_rows <= ssel.shape[0]:
        raise ValueError(f"retry_rows {retry_rows} outside [0, {ssel.shape[0]}]")
    dtype, dev = p_verts.dtype, p_verts.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}")
    PC, R = qi.shape[0], ssel.shape[0]
    i32, i64 = torch.int32, torch.int64
    two_cross.check_tensors("regions_cuda", dev, (
        ("p_verts", p_verts, dtype, None),
        ("p_n", p_n, i32, p_verts.shape[:1]),
        ("q_verts", q_verts, dtype, None),
        ("q_n", q_n, i32, q_verts.shape[:1]),
        ("qi", qi, i64, (PC,)),
        ("qj", qj, i64, (PC,)),
        ("shift", shift, dtype, (PC, 2)),
        ("perturb", perturb, dtype, (PC,)),
        ("ssel", ssel, i64, (R,)),
        ("n_slow", n_slow, i64, ()),
    ))


def output_bytes(R: int, cap: int, dtype) -> int:
    """Bytes of the packed output of R rows (intersect_regions.cuh:out_views):
    R (1 + 10 CAP) floats, 3 R CAP int32, R CAP + 2 R bytes."""
    return R * (1 + 10 * cap) * dtype.itemsize + 12 * R * cap + R * cap + 2 * R


def scratch_offset(R: int, cap: int, dtype) -> int:
    """Where the retry's scratch starts in ``alloc_output``'s buffer: past
    the packed output, 16-byte aligned."""
    return (output_bytes(R, cap, dtype) + 15) // 16 * 16


def scratch_bytes(R: int, cap: int, dtype) -> int:
    """Bytes of the retry's scratch (intersect_regions.cuh:ticket_offset):
    R rows in the packed output's layout, R bytes of flags, then the
    launch's 8-byte ticket, 8-byte aligned."""
    return (output_bytes(R, cap, dtype) + R + 7) // 8 * 8 + 8


def alloc_output(R: int, cap: int, dtype, device) -> torch.Tensor:
    """The one buffer a launch writes: the packed output (``result_of``),
    then the retry's scratch (``scratch_bytes``), whose ticket the launch
    zeroes before the kernel runs: the buffer needs no initial value, and
    launches into other buffers share nothing."""
    n = scratch_offset(R, cap, dtype) + scratch_bytes(R, cap, dtype)
    return torch.empty((n,), dtype=torch.uint8, device=device)


def result_of(buf, R: int, cap: int, dtype):
    """(ClipRegions [R rows], parity_bad [R]) whose fields are views of a
    launch's buffer, in the layout of intersect_regions.cuh:out_views."""
    off = 0

    def take(shape, dt):
        nonlocal off
        n = dt.itemsize
        for d in shape:
            n *= d
        view = buf[off:off + n].view(dt).view(shape)
        off += n
        return view

    f, i32, b = dtype, torch.int32, torch.bool
    total, area = take((R,), f), take((R, cap), f)
    cent, cha, chb, pnorm = (take((R, cap, 2), f) for _ in range(4))
    plen = take((R, cap), f)
    ncross, pcnt, qcnt = (take((R, cap), i32) for _ in range(3))
    valid, overflow, parity_bad = take((R, cap), b), take((R,), b), take((R,), b)
    return ClipRegions(
        total_area=total, area=area, centroid=cent, n_cross=ncross,
        chord_a=cha, chord_b=chb, p_norm=pnorm, p_len=plen, p_cnt=pcnt,
        q_cnt=qcnt, valid=valid, overflow=overflow,
    ), parity_bad


def launch_into(buf, p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, ssel,
                n_slow, cap, retry_rows) -> None:
    """The clip, and the retry where ``retry_rows`` > 0, on checked inputs
    into a buffer from ``alloc_output``: one launch, counted (under a CUDA
    graph's capture, counted as captured)."""
    R, dtype, dev = ssel.shape[0], p_verts.dtype, p_verts.device
    if R == 0:
        return
    lib = _load()
    fn = lib.sz_regions_f64 if dtype == torch.float64 else lib.sz_regions_f32
    with two_cross._on_device(dev):
        rc = fn(
            p_verts.data_ptr(), p_n.data_ptr(), p_verts.shape[0], p_verts.shape[1],
            q_verts.data_ptr(), q_n.data_ptr(), q_verts.shape[0], q_verts.shape[1],
            qi.data_ptr(), qj.data_ptr(), shift.data_ptr(), perturb.data_ptr(),
            qi.shape[0], ssel.data_ptr(), R, n_slow.data_ptr(), cap,
            RETRY_SCALE, retry_rows, buf.data_ptr(),
            buf.data_ptr() + scratch_offset(R, cap, dtype),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    two_cross._raise_if(lib, rc, "slow clip kernel")
    _counter.count()


def regions_cuda(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, ssel,
                 n_slow, cap: int, retry_rows: int):
    """The kernel on CUDA tensors: ring pools p_verts [N, V, 2] with p_n [N]
    int32 and q_verts [NQ, W, 2] with q_n [NQ] int32 (V, W <= MAX_VERTS;
    f32 or f64), the candidate list's qi, qj [PC] int64, shift [PC, 2] and
    perturb [PC], the slow selection ssel [R] int64 (a row of the list, PC
    where unused) and n_slow, the number of slow rows, a 0-d int64 tensor on
    the card.  Row r is clipped with CAP = ``cap`` (<= MAX_CAP) crossing
    slots if r < n_slow, else it is zeros; then the first ``retry_rows``
    rows whose parity came out odd are clipped again with the perturbation
    scaled by RETRY_SCALE, and the retry replaces a row's result where it
    resolves.  One launch.
    Returns (ClipRegions, parity_bad [R]: the rows that were odd before the
    retry), views of one allocation."""
    _check_inputs(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, ssel,
                  n_slow, cap, retry_rows)
    dtype, R = p_verts.dtype, ssel.shape[0]
    buf = alloc_output(R, cap, dtype, p_verts.device)
    launch_into(buf, p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, ssel,
                n_slow, cap, retry_rows)
    return result_of(buf, R, cap, dtype)


def slow_regions_plain(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb,
                       ssel, n_slow, cap: int, retry_rows: int):
    """Plain PyTorch version of ``regions_cuda``, with its signature: every
    row of ``ssel`` through ``clip.intersect_regions``, the rows past
    n_slow zeroed, then the retry of the first ``retry_rows`` odd rows and
    its merge where it resolves.  Returns (ClipRegions, parity_bad)."""
    R, PC = ssel.shape[0], qi.shape[0]
    dev = p_verts.device
    live = (torch.arange(R, device=dev) < n_slow) & (ssel < PC)
    ssafe = torch.clamp(ssel, min=0, max=PC - 1)
    i, j, sh = qi[ssafe], qj[ssafe], shift[ssafe]

    def clip_rows(rows, pscale):
        return intersect_regions(
            p_verts[i[rows]], p_n[i[rows]], q_verts[j[rows]] + sh[rows][:, None, :],
            q_n[j[rows]], CAP=cap, perturb=perturb[ssafe[rows]] * pscale,
        )

    def on_live(x):
        keep = live.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=dev))

    regs = ClipRegions(*(on_live(x) for x in clip_rows(slice(None), 1.0)))
    bad = live & regs.overflow
    if retry_rows > 0:
        bsel = first_true(bad, retry_rows, R)
        bsafe = torch.clamp(bsel, max=R - 1)
        regs2 = clip_rows(bsafe, RETRY_SCALE)
        idx = torch.where((bsel < R) & ~regs2.overflow, bsafe, R)

        def put(a, b):
            ext = torch.cat([a, a[:1]], dim=0)  # row R: dropped
            ext[idx] = b
            return ext[:R]

        regs = ClipRegions(*(put(a, b) for a, b in zip(regs, regs2)))
    return regs, bad


# The kernel held against its plain version (``held_against_plain``): each
# floating field's power of length; the centroid as the first moment
# area x centroid (MX / 6S, whose own error grows as 1 / S)
FIELD_POWER = {"total_area": 2, "area": 2, "centroid": 3, "chord_a": 1,
               "chord_b": 1, "p_norm": 1, "p_len": 1}
# the sums held against the plain version in float64 as well: the
# crossing points (and the chords, normals and lengths made of them) of two
# near-parallel edges are ill-conditioned, so float32 and float64 part
# there by far more than the rounding of the sums
SUMS = ("total_area", "area", "centroid")
# the limits, in eps L^p of each row, about twice the largest difference
# read on the CPU test inputs and the card's batches: against the plain
# version at the result's own dtype, each field (the chords are computed
# elementwise in one order; p_len adds up to CAP segment lengths, so its
# sums run to several L), and in float64 (SUMS)
LIMIT_SAME = {"total_area": 4.0, "area": 4.0, "centroid": 4.0, "chord_a": 1.0,
              "chord_b": 1.0, "p_norm": 4.0, "p_len": 32.0}
LIMIT_F64 = 4.0
# Those limits were read on rings of up to READ_VERTS vertices.  The fields
# made of the rings' doubled prefix sums (2n + 1 terms for a ring of n
# vertices, intersect_regions.cuh:pre_len) and of the regions' sums
# (PREFIX_FIELDS) round with the number of terms, and the plain version on
# the card adds them in another order than the kernel's serial chain: on a
# row whose wider ring has n > READ_VERTS vertices their limits are
# multiplied by (2n + 1) / (2 READ_VERTS + 1), the growth of a sum's
# rounding bound with its terms.  (At 128 vertices, f64, total_area parted
# from the plain version on the card by 4.8 eps L^2; PERF.md.)
READ_VERTS = 40
PREFIX_FIELDS = ("total_area", "area", "centroid", "p_len")


def held_against_plain(got, gbad, p_verts, p_n, q_verts, q_n, qi, qj, shift,
                       perturb, ssel, n_slow, cap: int, retry_rows: int) -> dict:
    """Hold the slow clip's result ``(got, gbad)`` on these inputs (from
    ``regions_cuda`` or the host shim) against the plain version on the
    inputs' device, each difference in eps L^p of its row: eps the inputs'
    dtype's, L the row's largest absolute coordinate (of P and of Q moved
    by its shift; the shoelace terms round at eps L^2 in absolute
    coordinates) and p the field's FIELD_POWER.

    Against the plain version at the inputs' dtype, which decides alike:
    parity flags, counts and overflow flags equal; each region's validity
    equal except at the gate S > 0 where its area is within the area's
    LIMIT_SAME on both sides; every floating field within its LIMIT_SAME.
    Against the plain version in float64 on the inputs cast up (whose sums
    do not round in float32), on the rows that float64 decides alike (the
    same counts and flags): the areas and first moments (SUMS) within
    LIMIT_F64.  On a row with a ring wider than READ_VERTS, the limits of
    PREFIX_FIELDS grow with the terms of its prefix sums (``terms``).

    Returns, for each reference, each field's largest difference in eps L^p
    (``max_in_eps_L``) and as it is (``max_abs``), the largest growth of the
    limits (``limits_grown_by``), with the rows that
    float64 decides otherwise and the sliver flips; raises AssertionError
    naming the field that is off."""
    args = (p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb)
    same, sbad = slow_regions_plain(*args, ssel, n_slow, cap, retry_rows)
    wide = [x.double() if x.is_floating_point() else x for x in args]
    ref64, bad64 = slow_regions_plain(*wide, ssel, n_slow, cap, retry_rows)
    if not torch.equal(gbad, sbad):
        raise AssertionError("slow clip parity_bad: kernel and plain differ")
    R, PC = ssel.shape[0], qi.shape[0]
    row = torch.clamp(ssel, max=PC - 1)
    pv, qv = p_verts[qi[row]], q_verts[qj[row]] + shift[row][:, None, :]
    pv = pv * (torch.arange(pv.shape[1], device=pv.device)
               < p_n[qi[row]][:, None])[..., None]
    qv = qv * (torch.arange(qv.shape[1], device=qv.device)
               < q_n[qj[row]][:, None])[..., None]
    live = (torch.arange(R, device=ssel.device) < n_slow) & (ssel < PC)
    L = torch.where(live, torch.maximum(pv.abs().amax((1, 2)), qv.abs().amax((1, 2))),
                    0).double()
    eps = torch.finfo(p_verts.dtype).eps
    # the limits' growth past READ_VERTS vertices (1 up to it)
    n = torch.maximum(p_n[qi[row]], q_n[qj[row]]).double()
    terms = torch.clamp((2 * n + 1) / (2 * READ_VERTS + 1), min=1.0)

    def unit(f, x):  # eps L^p of each entry of field f, shaped as x
        return (eps * L ** FIELD_POWER[f]).reshape((R,) + (1,) * (x.dim() - 1))

    def growth(f, x):  # the limit's growth for field f, shaped as unit(f, x)
        g = terms if f in PREFIX_FIELDS else torch.ones_like(terms)
        return g.reshape((R,) + (1,) * (x.dim() - 1))

    for f in ("n_cross", "p_cnt", "q_cnt", "overflow"):
        if not torch.equal(getattr(got, f), getattr(same, f)):
            raise AssertionError(f"slow clip {f}: kernel and plain differ")
    sliver = (torch.maximum(got.area, same.area).double()
              <= LIMIT_SAME["area"] * unit("area", got.area) * growth("area", got.area))
    flip = got.valid != same.valid
    if bool((flip & ~sliver).any()):
        raise AssertionError("slow clip valid: kernel and plain differ on a region "
                             "larger than its row's limit")
    alike = (bad64 == sbad) & (ref64.overflow == same.overflow)
    for f in ("n_cross", "p_cnt", "q_cnt", "valid"):
        alike &= (getattr(ref64, f) == getattr(same, f)).reshape(R, -1).all(1)

    def moments(r):
        return r._replace(centroid=r.area[..., None] * r.centroid)

    g = moments(got)
    out = {"max_in_eps_L": {}, "max_abs": {}}
    for ref, limits, rows, name in (
            (moments(same), LIMIT_SAME, torch.ones_like(live), "same_dtype"),
            (moments(ref64), dict.fromkeys(SUMS, LIMIT_F64), alike, "float64")):
        worst, max_abs = {}, {}
        for f, limit in limits.items():
            a, b = getattr(g, f).double(), getattr(ref, f).double()
            u = unit(f, a)
            keep = rows.reshape(u.shape)
            d = torch.where(keep, (a - b).abs(), 0)
            if bool((d[(u == 0).expand_as(d)] != 0).any()):
                raise AssertionError(f"slow clip {f}: a row past n_slow is not zeros")
            rel = torch.where(u > 0, d / torch.where(u > 0, u, 1), 0)
            max_abs[f] = float(d.max()) if d.numel() else 0.0
            worst[f] = float(rel.max()) if rel.numel() else 0.0
            over = rel > limit * growth(f, a)
            if bool(over.any()):
                raise AssertionError(
                    f"slow clip {f}: kernel and plain ({name}) differ by "
                    f"{float(rel[over].max())} eps L^{FIELD_POWER[f]} (limit "
                    f"{limit}, times {float(terms.max()):.3g} past {READ_VERTS} vertices)")
        out["max_in_eps_L"][name], out["max_abs"][name] = worst, max_abs
    return dict(out, rows_decided_otherwise_in_f64=int((live & ~alike).sum()),
                sliver_validity_flips=int(flip.sum()),
                limits_grown_by=float(terms[live].max()) if bool(live.any()) else 1.0)


def intersect_regions_dispatch(p_verts, p_n, q_verts, q_n, qi, qj, shift,
                               perturb, ssel, n_slow, cap: int, retry_rows: int):
    """The slow clip on the tensors' device: CUDA tensors go to the kernel,
    which raises on what it cannot take (no fallback); CPU tensors go to
    ``slow_regions_plain``."""
    args = (p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, ssel, n_slow,
            cap, retry_rows)
    if p_verts.is_cuda:
        return regions_cuda(*args)
    return slow_regions_plain(*args)


def build_host_shim(out_dir=None):
    """g++ build of ``csrc/intersect_regions_host.cpp``, the kernel's
    per-row arithmetic (intersect_regions.cuh) combined serially in the
    kernel's order, with the kernel's interface and no stream, into a
    ctypes library (in ``out_dir``, default ``_build/``).  The CPU tests
    and ``chip_smoke.py`` hold the kernel to it; raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ is not installed")
    out_dir = Path(out_dir or two_cross.BUILD_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libregions_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(so), str(two_cross.CSRC_DIR / "intersect_regions_host.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, real in (("sz_regions_host_f32", ctypes.c_float),
                       ("sz_regions_host_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, i, i, p, p, i, i, p, p, p, p, ll, p, i, p, i, real, i, p]
        fn.restype = None
    return lib


def run_host_shim(lib, p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb,
                  ssel, n_slow, cap: int, retry_rows: int):
    """The host shim of ``build_host_shim`` on CPU tensors, with
    ``regions_cuda``'s arguments -> (ClipRegions, parity_bad), views of one
    packed buffer as the CUDA wrapper's are."""
    R, dtype = ssel.shape[0], p_verts.dtype
    buf = alloc_output(R, cap, dtype, "cpu")
    fn = lib.sz_regions_host_f64 if dtype == torch.float64 else lib.sz_regions_host_f32
    a = [x.contiguous() for x in (p_verts, p_n.to(torch.int32), q_verts,
                                  q_n.to(torch.int32), qi, qj, shift, perturb,
                                  ssel, n_slow.reshape(()).long())]
    fn(a[0].data_ptr(), a[1].data_ptr(), a[0].shape[0], a[0].shape[1],
       a[2].data_ptr(), a[3].data_ptr(), a[2].shape[0], a[2].shape[1],
       a[4].data_ptr(), a[5].data_ptr(), a[6].data_ptr(), a[7].data_ptr(),
       qi.shape[0], a[8].data_ptr(), R, a[9].data_ptr(), cap, RETRY_SCALE,
       retry_rows, buf.data_ptr())
    return result_of(buf, R, cap, dtype)


def empty_launch() -> None:
    """Launch an empty kernel on the current stream through the same
    ctypes route: the floor under any launch's time.  Not counted."""
    two_cross.empty_launch(_load())
