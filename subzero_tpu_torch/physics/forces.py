"""The force law's CUDA kernel (B4): bind, launch, count.

``csrc/forces.cu`` (per-item arithmetic in ``csrc/forces.cuh``) replaces the
elementwise chain of ``collisions._force_law_plain`` on the card: the
overlap totals and the fuse / remove marking of the candidate rows, and the
Hopkins contact forces of both contact lists (``collisions._region_forces``
on the narrow phase's one-region rows and on the slow clip's regions), in
one launch.  A thread takes a candidate row or a region of a slow row; every
input is read in place (the floe pool, the Q pool's table, the candidate
list, the narrow phase's packed rows and the slow clip's regions).  The
kernel is built into the slow clip's library (``regions.build``:
``_build/libregions.so``, the flags of ``two_cross.py``), loaded with
``ctypes`` and launched on PyTorch's current stream without synchronising.
``collisions._force_law`` sends CUDA tensors here and CPU tensors to the
plain version; ``run_host_shim`` runs the same arithmetic on the CPU (g++).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from ..geometry import regions, two_cross

# floats of a row of the narrow phase's packed output (forces.cuh:TcSlot)
TC_FLOATS = two_cross.OUT_FLOATS
Q_COLS = 9  # columns of the Q pool's table (collisions._q_table, forces.cuh:QCol)

_lib = None


class ContactSides(NamedTuple):
    """The sides of a contact list that the contact sums and the interaction
    rows read (a ``collisions._PairSides`` has them too)."""

    cent_i: torch.Tensor     # [K, 2]
    cent_j: torch.Tensor     # [K, 2] Q's centroid, unshifted
    is_floe_j: torch.Tensor  # [K]


class ForceLaw(NamedTuple):
    """What the force law gives the contact sums: both lists' forces, force
    points and overlap records, the candidate rows' marks (None where the
    caller does not mark: ``pair_interactions``) and the slow rows' sides."""

    f_force: torch.Tensor     # [PC, 1, 2]
    f_fp: torch.Tensor        # [PC, 1, 2]
    f_rec: torch.Tensor       # [PC, 1]
    s_force: torch.Tensor     # [S, R, 2]
    s_fp: torch.Tensor        # [S, R, 2]
    s_rec: torch.Tensor       # [S, R]
    is_ff: torch.Tensor | None       # [PC]
    fuse: torch.Tensor | None        # [PC]
    dom_remove: torch.Tensor | None  # [PC]
    s_sides: ContactSides


_counter = two_cross.LaunchCounter()
launch_count = _counter.launch_count
reset_launch_count = _counter.reset_launch_count
captured_count = _counter.captured_count
add_replayed = _counter.add_replayed


# forces.cuh:Args, field by field: pointers, then the law's scalars, then ints
_POINTERS = (
    "area", "height", "nverts", "centroid", "u", "v", "xi", "q_table", "vals",
    "qi", "qj", "shift", "valid", "tc", "tc_cnt", "tc_ok",
    "ssel", "si", "sj", "sshift",
    "s_total", "s_area", "s_centroid", "s_n_cross", "s_chord_a", "s_chord_b",
    "s_p_norm", "s_p_len", "s_p_cnt", "s_q_cnt", "s_valid",
    "f_force", "f_rec", "is_ff", "fuse", "dom_remove",
    "s_force", "s_rec", "s_cent_i", "s_cent_j", "s_is_floe",
)
_REALS = ("E", "G", "mu", "neg_mu", "dt", "ff_max", "fd_max")
_INTS = ("N", "PC", "S", "R", "marking")


def _args_type(real):
    return type(f"Args_{real.__name__}", (ctypes.Structure,), {"_fields_": (
        [(n, ctypes.c_void_p) for n in _POINTERS] + [(n, real) for n in _REALS]
        + [(n, ctypes.c_int) for n in _INTS])})


_ARGS = {torch.float32: _args_type(ctypes.c_float),
         torch.float64: _args_type(ctypes.c_double)}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(regions.build()["path"])
        for name, dtype in (("sz_forces_f32", torch.float32),
                            ("sz_forces_f64", torch.float64)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_ARGS[dtype]), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = two_cross.bind_common(lib)
    return _lib


def tc_rows(tc) -> torch.Tensor:
    """The narrow phase's rows as one [PC, TC_FLOATS] block: the kernel's
    packed output itself where ``tc``'s fields are its views
    (``two_cross.result_of``), else a packed copy."""
    c = tc.contain
    PC, isz = c.shape[0], c.element_size()
    base = c.data_ptr()
    views = ((tc.area, 1), (tc.centroid, 2), (tc.chord_a, 4), (tc.chord_b, 6),
             (tc.p_norm, 8))
    if c.stride() == (TC_FLOATS,) and all(
            x.data_ptr() == base + col * isz and x.stride()[0] == TC_FLOATS
            and (x.dim() == 1 or x.stride()[1] == 1) for x, col in views):
        return c.as_strided((PC, TC_FLOATS), (TC_FLOATS, 1))
    return torch.cat([c[:, None], tc.area[:, None], tc.centroid, tc.chord_a,
                      tc.chord_b, tc.p_norm], dim=1).contiguous()


def _output_views(buf, PC: int, S: int, R: int, dtype, marking: bool):
    """The launch's outputs as views of one buffer: the floats (candidate
    forces and records, slow forces, records and centroids), then the
    flags."""
    isz = torch.finfo(dtype).bits // 8
    nf = 3 * PC + 3 * S * R + 4 * S
    fl = buf[:nf * isz].view(dtype)
    fb = buf[nf * isz:].view(torch.bool)
    off = 0

    def take(src, shape):
        nonlocal off
        n = 1
        for d in shape:
            n *= d
        view = src[off:off + n].view(shape)
        off += n
        return view

    f_force, f_rec = take(fl, (PC, 1, 2)), take(fl, (PC, 1))
    s_force, s_rec = take(fl, (S, R, 2)), take(fl, (S, R))
    s_ci, s_cj = take(fl, (S, 2)), take(fl, (S, 2))
    off = 0
    is_ff, fuse, dom = (take(fb, (PC,)) for _ in range(3))
    s_is_floe = take(fb, (S,))
    return (f_force, f_rec, s_force, s_rec, s_ci, s_cj,
            *((is_ff, fuse, dom) if marking else (None, None, None)), s_is_floe)


def _output_bytes(PC: int, S: int, R: int, dtype) -> int:
    isz = torch.finfo(dtype).bits // 8
    return (3 * PC + 3 * S * R + 4 * S) * isz + 3 * PC + S


def prepare(consts, dt, cs, vals, floes, q_table, qi, qj, shift, valid, tc,
            ssel, si, sj, sshift, sregions, marking: bool, check: bool = True):
    """The kernel's arguments (forces.cuh:Args) on these inputs, an output
    buffer of their device and the ForceLaw whose fields are views of it.
    ``consts``, ``dt`` and ``cs`` (CollisionSettings) are the law's
    scalars; ``floes`` the pool; ``tc`` the narrow phase's result on the
    candidate list ``qi, qj, shift, valid``; ``ssel`` the slow selection,
    ``si, sj, sshift`` its rows' sides and ``sregions`` the slow clip's
    regions (``cs`` may be None where ``marking`` is False).  Every input
    is made contiguous (a no-op where it is); ``check``: raise unless each
    is on the pool's device, of the dtype and shape the kernel takes.
    Returns (args, buf, ForceLaw, the inputs as the kernel reads them)."""
    dtype, dev = floes.area.dtype, floes.area.device
    if dtype not in _ARGS:
        raise TypeError(f"unsupported dtype {dtype}")
    N, PC, S = floes.area.shape[0], qi.shape[0], ssel.shape[0]
    R = sregions.area.shape[1]
    tcf = tc_rows(tc)
    T, i32, i64, b = dtype, torch.int32, torch.int64, torch.bool
    inputs = {
        "area": (floes.area, T, (N,)), "height": (floes.height, T, (N,)),
        "nverts": (floes.nverts, i32, (N,)), "centroid": (floes.centroid, T, (N, 2)),
        "u": (floes.u, T, (N,)), "v": (floes.v, T, (N,)), "xi": (floes.xi, T, (N,)),
        "q_table": (q_table, T, (q_table.shape[0], Q_COLS)),
        "vals": (vals, T, (4,)),
        "qi": (qi, i64, (PC,)), "qj": (qj, i64, (PC,)), "shift": (shift, T, (PC, 2)),
        "valid": (valid, b, (PC,)), "tc": (tcf, T, (PC, TC_FLOATS)),
        "tc_cnt": (tc.cnt, i32, (PC,)), "tc_ok": (tc.ok, b, (PC,)),
        "ssel": (ssel, i64, (S,)), "si": (si, i64, (S,)), "sj": (sj, i64, (S,)),
        "sshift": (sshift, T, (S, 2)),
        "s_total": (sregions.total_area, T, (S,)), "s_area": (sregions.area, T, (S, R)),
        "s_centroid": (sregions.centroid, T, (S, R, 2)),
        "s_n_cross": (sregions.n_cross, i32, (S, R)),
        "s_chord_a": (sregions.chord_a, T, (S, R, 2)),
        "s_chord_b": (sregions.chord_b, T, (S, R, 2)),
        "s_p_norm": (sregions.p_norm, T, (S, R, 2)), "s_p_len": (sregions.p_len, T, (S, R)),
        "s_p_cnt": (sregions.p_cnt, i32, (S, R)), "s_q_cnt": (sregions.q_cnt, i32, (S, R)),
        "s_valid": (sregions.valid, b, (S, R)),
    }
    inputs = {name: (x.contiguous(), want, shape)
              for name, (x, want, shape) in inputs.items()}
    if check:
        two_cross.check_tensors("force law", dev, [
            (name, x, want, torch.Size(shape))
            for name, (x, want, shape) in inputs.items()])
    buf = torch.empty((_output_bytes(PC, S, R, dtype),), dtype=torch.uint8, device=dev)
    (f_force, f_rec, s_force, s_rec, s_ci, s_cj, is_ff, fuse, dom,
     s_is_floe) = _output_views(buf, PC, S, R, dtype, marking)
    outputs = {"f_force": f_force, "f_rec": f_rec, "s_force": s_force,
               "s_rec": s_rec, "s_cent_i": s_ci, "s_cent_j": s_cj,
               "s_is_floe": s_is_floe}
    if marking:
        outputs.update(is_ff=is_ff, fuse=fuse, dom_remove=dom)
    ptrs = {name: x.data_ptr() for name, (x, _, _) in inputs.items()}
    ptrs.update({name: x.data_ptr() for name, x in outputs.items()})
    args = _ARGS[dtype](
        **ptrs,
        E=consts.E, G=consts.E / (2.0 * (1.0 + consts.nu)), mu=consts.mu,
        neg_mu=-consts.mu, dt=float(dt),
        ff_max=cs.floe_floe_max_overlap if marking else 0.0,
        fd_max=cs.floe_domain_max_overlap if marking else 0.0,
        N=N, PC=PC, S=S, R=R, marking=int(marking))
    law = ForceLaw(
        f_force=f_force, f_fp=tc.centroid[:, None, :], f_rec=f_rec,
        s_force=s_force, s_fp=sregions.centroid, s_rec=s_rec,
        is_ff=is_ff, fuse=fuse, dom_remove=dom,
        s_sides=ContactSides(s_ci, s_cj, s_is_floe))
    return args, buf, law, [x for x, _, _ in inputs.values()]


def launch(args, dtype) -> None:
    """One launch of the kernel with ``prepare``'s arguments on the current
    stream, counted (under a CUDA graph's capture, counted as captured)."""
    lib = _load()
    fn = lib.sz_forces_f64 if dtype == torch.float64 else lib.sz_forces_f32
    dev = torch.device("cuda", torch.cuda.current_device())
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    two_cross._raise_if(lib, rc, "force law kernel")
    _counter.count()


def force_law_cuda(consts, dt, cs, vals, floes, q_table, qi, qj, shift, valid,
                   tc, ssel, si, sj, sshift, sregions, marking: bool) -> ForceLaw:
    """The force law on CUDA tensors (``prepare``'s arguments), one launch;
    raises on what the kernel does not take (no fallback).  Same result as
    ``collisions._force_law_plain``, to the bit in the same dtype."""
    with two_cross._on_device(floes.area.device):
        args, _buf, law, _alive = prepare(consts, dt, cs, vals, floes, q_table,
                                          qi, qj, shift, valid, tc, ssel, si, sj,
                                          sshift, sregions, marking)
        launch(args, floes.area.dtype)
    return law


def build_host_shim(out_dir=None):
    """g++ build of ``csrc/forces_host.cpp``, the kernel's arithmetic
    (forces.cuh) run item by item, into a ctypes library (in ``out_dir``,
    default ``_build/``).  Raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ is not installed")
    out_dir = Path(out_dir or two_cross.BUILD_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libforces_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(so), str(two_cross.CSRC_DIR / "forces_host.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(so))
    for name, dtype in (("sz_forces_host_f32", torch.float32),
                        ("sz_forces_host_f64", torch.float64)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_ARGS[dtype]), ctypes.c_int]
        fn.restype = None
    return lib


def run_host_shim(lib, consts, dt, cs, vals, floes, q_table, qi, qj, shift,
                  valid, tc, ssel, si, sj, sshift, sregions, marking: bool,
                  card_div: bool = False) -> ForceLaw:
    """The host shim of ``build_host_shim`` on CPU tensors, with
    ``force_law_cuda``'s arguments -> ForceLaw.
    ``card_div``: divide by a Python scalar as PyTorch does on CUDA (times
    the reciprocal) rather than as on the CPU."""
    args, _buf, law, _alive = prepare(consts, dt, cs, vals, floes, q_table, qi, qj,
                                      shift, valid, tc, ssel, si, sj, sshift,
                                      sregions, marking, check=False)
    fn = (lib.sz_forces_host_f64 if floes.area.dtype == torch.float64
          else lib.sz_forces_host_f32)
    fn(ctypes.byref(args), int(card_div))
    return law
