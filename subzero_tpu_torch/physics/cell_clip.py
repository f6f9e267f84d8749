"""The coupling's cell clip as a CUDA kernel (B6): bind, launch, count.

``csrc/cell_clip.cu`` (per-cell arithmetic in ``csrc/cell_clip.cuh``)
replaces the plain body of ``coupling._clip_area_to_rects`` on the card: the
ice area of each floe in each cell of its coupling window, in one launch, a
warp a floe and a lane a cell that the window's mask keeps, with none of the
plain version's [N, V, cells] intermediates.  The window's rects and mask
are separable, so they come in as per-axis vectors: the x bounds and mask
[N, A] of the window's columns, the y bounds and mask [N, B] of its rows.
The kernel also adds the cells it clipped to a counter on the device (the
marks' ``window_cells``).  It is built into the slow clip's library
(``regions.build``: ``_build/libregions.so``, the flags of
``two_cross.py``), loaded with ``ctypes`` and launched on PyTorch's current
stream without synchronising.  ``coupling._cell_areas`` sends CUDA tensors
here and CPU tensors to the plain version; ``run_host_shim`` runs the same
arithmetic on the CPU (g++).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from ..geometry import regions, two_cross

_lib = None


_counter = two_cross.LaunchCounter()
launch_count = _counter.launch_count
reset_launch_count = _counter.reset_launch_count
captured_count = _counter.captured_count
add_replayed = _counter.add_replayed


# cell_clip.cuh:Args, field by field
_POINTERS = ("verts", "nverts", "xmin", "xmax", "ymin", "ymax", "okx", "oky", "out",
             "count")
_INTS = ("N", "V", "A", "B")
_ARGS = {dtype: type(f"Args_{str(dtype)[6:]}", (ctypes.Structure,), {"_fields_": (
    [(n, ctypes.c_void_p) for n in _POINTERS] + [(n, ctypes.c_int) for n in _INTS])})
    for dtype in (torch.float32, torch.float64)}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(regions.build()["path"])
        for name, dtype in (("sz_cell_clip_f32", torch.float32),
                            ("sz_cell_clip_f64", torch.float64)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_ARGS[dtype]), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = two_cross.bind_common(lib)
    return _lib


def prepare(verts, nverts, xmin, xmax, ymin, ymax, okx, oky, count=None,
            check: bool = True):
    """The kernel's arguments (cell_clip.cuh:Args) and its output, an
    [N, A, B] tensor of the rings' dtype on their device.  ``verts`` [N, V, 2]
    and ``nverts`` [N] (int32) are the rings; ``xmin``, ``xmax``, ``okx``
    [N, A] and ``ymin``, ``ymax``, ``oky`` [N, B] the window's rects and
    mask by axis; ``count`` a 0-d int64 tensor that the launch adds the
    cells it clipped to, or None.  Every input is made contiguous (a no-op
    where it is); ``check``: raise unless each is on the rings' device, of
    the dtype and shape the kernel takes.  Returns (args, out, the inputs as
    the kernel reads them)."""
    dtype, dev = verts.dtype, verts.device
    if dtype not in _ARGS:
        raise TypeError(f"unsupported dtype {dtype}")
    N, V = verts.shape[0], verts.shape[1]
    A, B = xmin.shape[-1], ymin.shape[-1]
    T, b = dtype, torch.bool
    inputs = {"verts": (verts, T, None), "nverts": (nverts, torch.int32, (N,)),
              "xmin": (xmin, T, (N, A)), "xmax": (xmax, T, (N, A)),
              "ymin": (ymin, T, (N, B)), "ymax": (ymax, T, (N, B)),
              "okx": (okx, b, (N, A)), "oky": (oky, b, (N, B))}
    if count is not None:
        inputs["count"] = (count, torch.int64, ())
    inputs = {name: (x.contiguous(), want, shape)
              for name, (x, want, shape) in inputs.items()}
    if check:
        two_cross.check_tensors("cell clip", dev, [
            (name, x, want, None if shape is None else torch.Size(shape))
            for name, (x, want, shape) in inputs.items()])
    out = torch.empty((N, A, B), dtype=dtype, device=dev)
    ptrs = {name: x.data_ptr() for name, (x, _, _) in inputs.items()}
    args = _ARGS[dtype](**ptrs, out=out.data_ptr(), N=N, V=V, A=A, B=B)
    return args, out, [x for x, _, _ in inputs.values()]


def launch(args, dtype) -> None:
    """One launch of the kernel with ``prepare``'s arguments on the current
    stream, counted (under a CUDA graph's capture, counted as captured)."""
    lib = _load()
    fn = lib.sz_cell_clip_f64 if dtype == torch.float64 else lib.sz_cell_clip_f32
    dev = torch.device("cuda", torch.cuda.current_device())
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    two_cross._raise_if(lib, rc, "cell clip kernel")
    _counter.count()


def cell_areas_cuda(verts, nverts, xmin, xmax, ymin, ymax, okx, oky, count=None):
    """The areas on CUDA tensors (``prepare``'s arguments), one launch;
    raises on what the kernel does not take (no fallback).  Same result as
    ``coupling._cell_areas``' plain version, to the bit in the same dtype."""
    with two_cross._on_device(verts.device):
        args, out, _alive = prepare(verts, nverts, xmin, xmax, ymin, ymax, okx, oky,
                                    count)
        launch(args, verts.dtype)
    return out


def build_host_shim(out_dir=None):
    """g++ build of ``csrc/cell_clip_host.cpp``, the kernel's arithmetic
    (cell_clip.cuh) run cell by cell, into a ctypes library (in ``out_dir``,
    default ``_build/``).  Raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ is not installed")
    out_dir = Path(out_dir or two_cross.BUILD_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libcell_clip_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(so), str(two_cross.CSRC_DIR / "cell_clip_host.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(so))
    for name, dtype in (("sz_cell_clip_host_f32", torch.float32),
                        ("sz_cell_clip_host_f64", torch.float64)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_ARGS[dtype])]
        fn.restype = None
    return lib


def run_host_shim(lib, verts, nverts, xmin, xmax, ymin, ymax, okx, oky, count=None):
    """The host shim of ``build_host_shim`` on CPU tensors, with
    ``cell_areas_cuda``'s arguments -> the [N, A, B] areas."""
    args, out, _alive = prepare(verts, nverts, xmin, xmax, ymin, ymax, okx, oky, count,
                                check=False)
    fn = (lib.sz_cell_clip_host_f64 if verts.dtype == torch.float64
          else lib.sz_cell_clip_host_f32)
    fn(ctypes.byref(args))
    return out
