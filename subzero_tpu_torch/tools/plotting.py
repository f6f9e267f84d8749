"""Visualization: floe-field animations from floe output files (port of
``subzero_tpu/tools/plotting.py``; h5py and matplotlib are imported when a
plot is made).

Matplotlib equivalent of the reference's Makie extension
(ext/SubzeroMakieExt.jl:24-88 ``plot_sim``) and the ``prettytime`` helper
(plotting.jl:49-73).
"""

from __future__ import annotations

import json


def prettytime(seconds: float) -> str:
    """plotting.jl:49-73: human-readable simulation time."""
    minutes = seconds / 60
    hours = minutes / 60
    days = hours / 24
    if seconds < 60:
        return f"{seconds:.2f} seconds"
    if minutes < 60:
        return f"{minutes:.2f} minutes"
    if hours < 24:
        return f"{hours:.2f} hours"
    return f"{days:.2f} days"


def plot_sim(
    floes_path: str,
    initial_state_path: str,
    dt: float,
    output_path: str = "sim.mp4",
    fps: int = 10,
):
    """Render an animation of the floe field over time."""
    import h5py
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation
    from matplotlib.patches import Polygon as MplPoly
    from matplotlib.collections import PatchCollection

    with h5py.File(initial_state_path, "r") as f:
        meta = json.loads(f.attrs["sim_json"])
    g = meta["grid"]

    with h5py.File(floes_path, "r") as f:
        steps = sorted(int(k) for k in f.keys())
        frames = []
        for t in steps:
            verts = f[f"{t}/verts"][()]
            nverts = f[f"{t}/nverts"][()]
            frames.append(
                [verts[i, : nverts[i]] for i in range(len(nverts))]
            )

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.set_xlim(g["x0"], g["xf"])
    ax.set_ylim(g["y0"], g["yf"])
    ax.set_aspect("equal")
    title = ax.set_title("")

    coll = PatchCollection([], facecolor="lightsteelblue", edgecolor="k", lw=0.5)
    ax.add_collection(coll)

    def update(k):
        patches = [MplPoly(r, closed=True) for r in frames[k]]
        coll.set_paths(patches)
        title.set_text(prettytime(steps[k] * dt))
        return coll, title

    anim = FuncAnimation(fig, update, frames=len(frames), blit=False)
    try:
        anim.save(output_path, fps=fps)
    except Exception:
        # ffmpeg may be unavailable; fall back to a grid of PNG frames
        out = output_path.rsplit(".", 1)[0]
        for k in range(0, len(frames), max(1, len(frames) // 9)):
            update(k)
            fig.savefig(f"{out}_{steps[k]:06d}.png", dpi=100)
    plt.close(fig)
    return output_path
