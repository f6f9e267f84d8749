"""Readers for reference-format (JLD2/HDF5) fixture files (port of
``subzero_tpu/tools/fixtures.py``).

JLD2 files are HDF5 underneath; nested Julia `Vector{Vector{Vector{T}}}`
coordinates become chains of object references, which these helpers
flatten back into numpy rings.
"""

from __future__ import annotations

import os

import numpy as np

# the Julia reference (Subzero.jl) checkout whose examples/floe_shapes.jld2
# the complex-shapes fixtures read; where it lies is the caller's to say
REFERENCE_DIR_ENV = "SUBZERO_REFERENCE_DIR"


def reference_floe_shapes() -> str:
    """Path of the reference's examples/floe_shapes.jld2, under the
    directory named by $SUBZERO_REFERENCE_DIR."""
    root = os.environ.get(REFERENCE_DIR_ENV)
    if not root:
        raise FileNotFoundError(
            "floe_shapes.jld2 lies in the Subzero.jl reference checkout: set "
            f"{REFERENCE_DIR_ENV} to its directory or pass the file's path"
        )
    return os.path.join(root, "examples", "floe_shapes.jld2")


def _deref(f, ref):
    o = f[ref][()]
    if isinstance(o, np.ndarray) and o.dtype == object:
        return [_deref(f, r) for r in o.ravel()]
    return np.asarray(o)


def load_floe_shapes(path: str | None = None, max_verts: int | None = None):
    """Load floe outline rings from a JLD2 `floe_vertices` fixture (by
    default the reference's examples/floe_shapes.jld2).

    Returns a list of [n, 2] float arrays (exterior rings only, matching the
    reference's hole-stripping). ``max_verts`` optionally decimates rings to
    fit a vertex capacity.
    """
    import h5py

    if path is None:
        path = reference_floe_shapes()
    out = []
    with h5py.File(path, "r") as f:
        refs = f["floe_vertices"][()]
        for ref in np.ravel(refs):
            shape = _deref(f, ref)
            ring = np.asarray(shape[0])
            ring = np.squeeze(ring)
            if ring.ndim != 2 or ring.shape[-1] != 2:
                continue
            if len(ring) > 1 and np.allclose(ring[0], ring[-1]):
                ring = ring[:-1]
            if max_verts is not None and len(ring) > max_verts:
                ring = _decimate(ring, max_verts)
            if len(ring) >= 3:
                out.append(ring)
    return out


def _decimate(ring, max_v):
    ring = [np.asarray(p) for p in ring]
    while len(ring) > max_v:
        n = len(ring)
        best, bestd = 0, np.inf
        for k in range(n):
            p0, p1, p2 = ring[k - 1], ring[k], ring[(k + 1) % n]
            seg = p2 - p0
            L = max(np.linalg.norm(seg), 1e-12)
            d = abs(seg[0] * (p1 - p0)[1] - seg[1] * (p1 - p0)[0]) / L
            if d < bestd:
                best, bestd = k, d
        ring.pop(best)
    return np.asarray(ring)
