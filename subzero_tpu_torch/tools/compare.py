"""Field-by-field comparison of two output files (regression harness).

Port of ``subzero_tpu/tools/compare.py``; mirrors the reference's
src/tools/compare_files.jl:15-131.
"""

from __future__ import annotations

import numpy as np


def compare_floe_files(path_a: str, path_b: str, rtol=1e-6, atol=1e-9, verbose=True):
    """Diff two floe output files; returns dict of per-(step, field) max
    absolute differences for fields that do not match."""
    import h5py

    diffs = {}
    with h5py.File(path_a, "r") as fa, h5py.File(path_b, "r") as fb:
        steps = sorted(set(fa.keys()) & set(fb.keys()), key=lambda s: int(s))
        only_a = set(fa.keys()) - set(fb.keys())
        only_b = set(fb.keys()) - set(fa.keys())
        if only_a or only_b:
            diffs["__steps__"] = (sorted(only_a), sorted(only_b))
        for s in steps:
            for k in fa[s].keys():
                if k not in fb[s]:
                    diffs[(s, k)] = "missing in b"
                    continue
                a = fa[s][k][()]
                b = fb[s][k][()]
                if a.shape != b.shape:
                    diffs[(s, k)] = f"shape {a.shape} vs {b.shape}"
                elif not np.allclose(a, b, rtol=rtol, atol=atol):
                    diffs[(s, k)] = float(np.max(np.abs(a - b)))
    if verbose:
        if not diffs:
            print("files match")
        else:
            for k, v in diffs.items():
                print(f"MISMATCH {k}: {v}")
    return diffs
