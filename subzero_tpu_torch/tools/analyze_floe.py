"""Per-floe time-series extraction and plotting from a floes.h5 output
(port of ``subzero_tpu/tools/analyze_floe.py``; numpy, h5py and matplotlib
only, so it reads a file written by either package).

Working replacement for the reference's dead src/tools/analyze_floe.jl
(hardcoded paths, undefined variables): follow ONE floe (by persistent id) through a FloeOutputWriter
file and pull any written field as a time series, optionally rendering the
standard diagnostic panel (u, centroid_x, collision_force_x, fx_oa,
total force) the reference script was hand-plotting.
"""

from __future__ import annotations

import numpy as np

__all__ = ["floe_timeseries", "plot_floe_analysis"]


def floe_timeseries(path: str, floe_id: int, fields):
    """Extract ``fields`` for the floe with persistent id ``floe_id``.

    Returns (tsteps, {field: array}); steps where the id is absent (not
    yet created, fused away, fractured) are skipped.  Vector-valued fields
    keep their trailing axes.
    """
    import h5py

    out = {k: [] for k in fields}
    ts = []
    with h5py.File(path, "r") as f:
        for key in sorted(f.keys(), key=int):
            g = f[key]
            if "id" not in g:
                continue
            ids = np.asarray(g["id"])
            hit = np.flatnonzero(ids == floe_id)
            if hit.size == 0:
                continue
            i = int(hit[0])
            ts.append(int(key))
            for k in fields:
                out[k].append(np.asarray(g[k])[i])
    return np.asarray(ts), {k: np.asarray(v) for k, v in out.items()}


def plot_floe_analysis(path: str, floe_id: int, out_dir: str):
    """Render the analyze_floe.jl diagnostic panel for one floe: velocity,
    x-centroid, x collision force, x ocean-atmosphere force, and total
    x-force per unit mass.  One PNG per quantity in ``out_dir``."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    ts, d = floe_timeseries(
        path, floe_id,
        ("u", "centroid", "collision_force", "fx_oa", "mass"),
    )
    if ts.size == 0:
        raise ValueError(f"floe id {floe_id} never appears in {path}")
    panels = {
        "u": d["u"],
        "centroid_x": d["centroid"][:, 0],
        "collision_x": d["collision_force"][:, 0],
        "fxOA": d["fx_oa"],
        "total_force_per_mass": (
            (d["collision_force"][:, 0] + d["fx_oa"]) / d["mass"]
        ),
    }
    written = []
    for name, y in panels.items():
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.plot(ts, y)
        ax.set_xlabel("timestep")
        ax.set_ylabel(name)
        ax.set_title(f"floe {floe_id}")
        fig.tight_layout()
        p = os.path.join(out_dir, f"{name}.png")
        fig.savefig(p, dpi=100)
        plt.close(fig)
        written.append(p)
    return written
