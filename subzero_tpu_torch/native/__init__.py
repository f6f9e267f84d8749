"""Native (C++) host geometry kernels, loaded via ctypes.

The package's own copy of ``subzero_tpu/native``.  ``clip.cpp`` implements
the same crossing-graph Weiler-Atherton booleans as geometry/host_clip.py
(same branch structure, epsilons, and perturbation retry schedule, both in
IEEE double), compiled on demand with g++ into
``subzero_tpu_torch/_build/libclip.so`` (rebuilt when the source is newer).
``geometry/host_clip.py`` routes through this library when available; set
``SUBZERO_NATIVE=0`` to force the pure-Python path.  This is host C++, not a
GPU kernel.

tests/test_torch_overlaps.py asserts ring-for-ring equivalence between the
two implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "clip.cpp"
LIB_PATH = PKG_DIR / "_build" / "libclip.so"

_LIB = None
_TRIED = False


def _build(src: str, so: str) -> bool:
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run(
            [
                "g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                "-fno-fast-math", src, "-o", tmp,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)
        return True
    except Exception:
        return False


def build(force: bool = False) -> bool:
    """Compile the library if it is missing or older than its source (or
    when ``force``).  Returns whether a usable library file is there."""
    src, so = str(SOURCE), str(LIB_PATH)
    stale = force or not os.path.exists(so) or (
        os.path.getmtime(so) < os.path.getmtime(src))
    return _build(src, so) if stale else True


def get_lib():
    """The loaded shared library, building it if necessary; None if the
    native path is disabled or unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SUBZERO_NATIVE", "1") == "0":
        return None
    if not build():
        return None
    so = str(LIB_PATH)
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int)
    lib.sz_poly_boolean.restype = ctypes.c_int
    lib.sz_poly_boolean.argtypes = [
        ctypes.c_int, c_dp, ctypes.c_int, c_dp, ctypes.c_int,
        c_dp, c_ip, ctypes.c_int, ctypes.c_int,
    ]
    lib.sz_pairwise_intersect_area.restype = None
    lib.sz_pairwise_intersect_area.argtypes = [
        c_dp, c_ip, ctypes.c_int, c_ip, c_ip, ctypes.c_int, c_dp,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the native library serves (built and loaded, not disabled)."""
    return get_lib() is not None


_OPS = {"and": 0, "or": 1, "diff": 2}


def poly_boolean(op: str, S, C):
    """Native polygon boolean; returns a list of [n, 2] rings, or None when
    the native library is unavailable (caller falls back to Python).
    Raises RuntimeError on an unresolvable degeneracy (like the Python
    implementation after its 8 retries)."""
    lib = get_lib()
    if lib is None:
        return None
    S = np.ascontiguousarray(S, dtype=np.float64)
    C = np.ascontiguousarray(C, dtype=np.float64)
    max_rings = 64
    max_pts = max(4 * (len(S) + len(C)) + 64, 256)
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int)
    for _ in range(4):  # grow buffers on overflow
        out_pts = np.empty((max_pts, 2), np.float64)
        ring_lens = np.empty((max_rings,), np.int32)
        rc = lib.sz_poly_boolean(
            _OPS[op],
            S.ctypes.data_as(c_dp), len(S),
            C.ctypes.data_as(c_dp), len(C),
            out_pts.ctypes.data_as(c_dp),
            ring_lens.ctypes.data_as(c_ip),
            max_rings, max_pts,
        )
        if rc == -2:
            max_rings *= 4
            max_pts *= 4
            continue
        if rc < 0:
            raise RuntimeError(
                f"polygon boolean '{op}' failed after 8 perturbations"
            )
        rings = []
        off = 0
        for r in range(rc):
            n = int(ring_lens[r])
            rings.append(out_pts[off : off + n].copy())
            off += n
        return rings
    raise RuntimeError("polygon boolean output exceeded buffer growth limit")


def pairwise_intersect_area(verts, nverts, ia, ib):
    """Total intersection areas for index pairs into a padded vertex pool.
    Returns float array [n_pairs] (-1 marks an unresolvable degeneracy), or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    nverts = np.ascontiguousarray(nverts, dtype=np.int32)
    ia = np.ascontiguousarray(ia, dtype=np.int32)
    ib = np.ascontiguousarray(ib, dtype=np.int32)
    out = np.empty((len(ia),), np.float64)
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int)
    lib.sz_pairwise_intersect_area(
        verts.ctypes.data_as(c_dp),
        nverts.ctypes.data_as(c_ip),
        verts.shape[1],
        ia.ctypes.data_as(c_ip),
        ib.ctypes.data_as(c_ip),
        len(ia),
        out.ctypes.data_as(c_dp),
    )
    return out
