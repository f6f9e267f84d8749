"""The two-crossing narrow-phase CUDA kernel: build, bind, launch.

``csrc/two_cross.cu`` (per-term arithmetic in ``csrc/two_cross.cuh``)
replaces the reference's Pallas TPU kernel
``subzero_tpu/geometry/pallas_clip.py:_kernel``.  It takes the floe pool, the
Q pool and the candidate pair list, gathers each pair's two rings itself (a
warp per pair) and writes one packed output.  It is compiled at first use
with ``nvcc`` into a shared library with a plain C interface under
``subzero_tpu_torch/_build/`` (rebuilt when a source is newer), loaded with
``ctypes``, and launched on PyTorch's current stream without synchronising.
The plain PyTorch version is ``geometry/clip.py:two_cross_pairs``;
``clip.two_cross_dispatch`` sends CUDA tensors here and CPU tensors there.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .clip import TwoCrossResult, sliver_tol

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libtwo_cross.so"
SOURCES = (CSRC_DIR / "two_cross.cu", CSRC_DIR / "two_cross.cuh")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: every operation rounds as PyTorch's elementwise
    # ops do, so the kernel agrees with two_cross_pass to the last bits
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
MAX_VERTS = 32  # widest ring the kernel takes: one vertex a lane
OUT_FLOATS = 10  # contain, area, centroid, chord_a, chord_b, p_norm of a row

_lib = None
_launches = 0
_captured = 0


def launch_count() -> int:
    """Number of kernel launches since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def captured_count() -> int:
    """Number of launches recorded into CUDA graphs (not run then: a graph
    launches them at each replay).  Never reset."""
    return _captured


def add_replayed(n: int) -> None:
    """Count ``n`` launches made by the replay of a CUDA graph that
    captured them (step_graph.py)."""
    global _launches
    _launches += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def build(force: bool = False) -> dict:
    """Compile the kernel library if it is missing or older than a source.
    Returns {"path", "built", "seconds", "log"}; raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stale = force or not LIB_PATH.exists() or any(
        s.stat().st_mtime > LIB_PATH.stat().st_mtime for s in SOURCES
    )
    log_path = BUILD_DIR / "two_cross.build.log"
    if not stale:
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(LIB_PATH), "built": False, "seconds": 0.0, "log": log}
    tmp = BUILD_DIR / f"libtwo_cross.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    log_path.write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, LIB_PATH)
    return {"path": str(LIB_PATH), "built": True, "seconds": seconds, "log": log}


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, real in (("sz_two_cross_f32", ctypes.c_float),
                           ("sz_two_cross_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            # pverts pnv N V qverts qnv NQ W qi qj shift perturb valid PC
            # sliver out cnt ok stream
            fn.argtypes = [p, p, i, i, p, p, i, i, p, p, p, p, p, i, real,
                           p, p, p, p]
            fn.restype = ctypes.c_int
        lib.sz_empty_launch.argtypes = [p]
        lib.sz_empty_launch.restype = ctypes.c_int
        lib.sz_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sz_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _on_device(dev):
    """Make ``dev`` the current CUDA device for a launch, at no cost when it
    already is."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _raise_if(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sz_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _check_inputs(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, valid):
    """Raise on what the kernel does not take.  Reads only the tensors'
    metadata: no value leaves the device, nothing synchronises."""
    dtype, dev = p_verts.dtype, p_verts.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}")
    PC = qi.shape[0]
    i32, i64 = torch.int32, torch.int64
    for name, x, dt, shape in (
        ("p_verts", p_verts, dtype, None),
        ("p_n", p_n, i32, p_verts.shape[:1]),
        ("q_verts", q_verts, dtype, None),
        ("q_n", q_n, i32, q_verts.shape[:1]),
        ("qi", qi, i64, (PC,)),
        ("qj", qj, i64, (PC,)),
        ("shift", shift, dtype, (PC, 2)),
        ("perturb", perturb, dtype, (PC,)),
        ("valid", valid, torch.bool, (PC,)),
    ):
        if not x.is_cuda:
            raise ValueError(f"two_cross_cuda takes CUDA tensors; {name} is on {x.device}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if shape is None:  # a ring pool; the lanes load whole vertices
            if x.dim() != 3 or x.shape[2] != 2:
                raise ValueError(f"{name} must be a ring pool [n, V, 2]")
            if x.shape[1] > MAX_VERTS:
                raise ValueError(f"ring width {x.shape[1]} > {MAX_VERTS}")
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        elif x.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, p_verts on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return PC


def _itemsize(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def alloc_output(PC: int, dtype, device) -> torch.Tensor:
    """The one buffer a launch writes: PC rows of OUT_FLOATS values of
    ``dtype``, then PC int32 counts, then PC ok bytes."""
    return torch.empty((PC * (OUT_FLOATS * _itemsize(dtype) + 5),),
                       dtype=torch.uint8, device=device)


def result_of(buf, PC: int, dtype) -> TwoCrossResult:
    """The TwoCrossResult whose fields are views of a launch's buffer."""
    nf = PC * OUT_FLOATS * _itemsize(dtype)
    fl = buf[:nf].view(dtype).view(PC, OUT_FLOATS)
    return TwoCrossResult(
        cnt=buf[nf:nf + 4 * PC].view(torch.int32), contain=fl[:, 0],
        ok=buf[nf + 4 * PC:].view(torch.bool), area=fl[:, 1],
        centroid=fl[:, 2:4], chord_a=fl[:, 4:6], chord_b=fl[:, 6:8],
        p_norm=fl[:, 8:10],
    )


def launch_into(buf, p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb,
                valid) -> None:
    """One launch of the kernel on checked inputs into a buffer from
    ``alloc_output`` (what ``two_cross_cuda`` does after its checks; timing
    loops call it to leave the host's share out).  Under a CUDA graph's
    capture the launch is recorded, not run, and counted as captured."""
    global _launches, _captured
    PC, dtype, dev = qi.shape[0], p_verts.dtype, p_verts.device
    if PC == 0:
        return
    lib = _load()
    fn = lib.sz_two_cross_f64 if dtype == torch.float64 else lib.sz_two_cross_f32
    out = buf.data_ptr()  # the layout of alloc_output
    cnt = out + PC * OUT_FLOATS * _itemsize(dtype)
    with _on_device(dev):
        rc = fn(
            p_verts.data_ptr(), p_n.data_ptr(), p_verts.shape[0], p_verts.shape[1],
            q_verts.data_ptr(), q_n.data_ptr(), q_verts.shape[0], q_verts.shape[1],
            qi.data_ptr(), qj.data_ptr(), shift.data_ptr(), perturb.data_ptr(),
            valid.data_ptr(), PC, sliver_tol(dtype), out, cnt, cnt + 4 * PC,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_if(lib, rc, "two_cross kernel")
    if torch.cuda.is_current_stream_capturing():
        _captured += 1
    else:
        _launches += 1


def two_cross_cuda(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb,
                   valid) -> TwoCrossResult:
    """The kernel on CUDA tensors: ring pools p_verts [N, V, 2] with p_n [N]
    int32 and q_verts [NQ, W, 2] with q_n [NQ] int32 (V, W <= 32; f32 or
    f64), and the pair list qi, qj [PC] int64, shift [PC, 2], perturb [PC],
    valid [PC] bool.  Same result as ``clip.two_cross_pairs``: a row that is
    not valid is zeros and not ok (so is a row whose index lies outside its
    pool, which the plain version refuses).  The result's fields are views
    of one allocation."""
    PC = _check_inputs(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, valid)
    dtype = p_verts.dtype
    buf = alloc_output(PC, dtype, p_verts.device)
    launch_into(buf, p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb, valid)
    return result_of(buf, PC, dtype)


def empty_launch() -> None:
    """Launch an empty kernel on the current stream through the same
    ctypes route: the floor under any launch's time.  Not counted."""
    lib = _load()
    _raise_if(lib, lib.sz_empty_launch(torch.cuda.current_stream().cuda_stream),
              "empty kernel")
