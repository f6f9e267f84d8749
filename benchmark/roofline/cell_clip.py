"""B6, the coupling's cell clip (``subzero_tpu_torch/csrc/cell_clip.cu``):
one warp a floe of the pool, one launch on each coupled step.  Every floe
reads its vertex count and its window's rect bounds and masks by axis
([N, A] columns, [N, B] rows) and writes its A x B areas; a floe with a
kept cell also reads its ring, and the launch adds its count of kept cells
to one counter.  Counted as the launch's floes need them, each input byte
read once and each output byte written once.  Operations: ``OPS_PER_EDGE``
for each kept cell and each real edge of its floe's ring
(``cell_clip.cuh``: ``edge_term`` and the accumulator's add) and
``OPS_PER_CELL`` to close each kept cell's sum.

The kept cells are the reference's own: its window mask
(``coupling._floe_cell_areas``' ``pair_ok``) on the state, so the count is
the same whatever implements the clip."""

from __future__ import annotations

import numpy as np

EVENT = "cell_clip_kernel"
# edge_term: dx, dy; the two zero tests; four (subtract, divide) and four
# clamps of two; the sort network's 10; six clamped points of (multiply,
# add, max, min) in x and in y; five cross products of 3 and their 4 adds;
# then the accumulator's add
OPS_PER_EDGE = 2 + 2 + 8 + 8 + 10 + 6 * 8 + 5 * 3 + 4 + 1
# the accumulators' 3 adds, the half, the absolute value and the test
OPS_PER_CELL = 6


def counts(N: int, A: int, B: int, elt: int, nverts, kept) -> dict:
    """Bytes and operations of one launch over a pool of ``N`` floes with
    windows of A x B cells in floats of width ``elt``, whose floe n has
    ``nverts[n]`` vertices and ``kept[n]`` kept cells."""
    nverts = np.asarray(nverts, np.int64)
    kept = np.asarray(kept, np.int64)
    live = kept > 0
    per_floe = 4 + (A + B) + 2 * (A + B) * elt + A * B * elt
    rings = int(np.sum(2 * elt * nverts[live]))
    ops = int(np.sum(kept * (OPS_PER_EDGE * nverts + OPS_PER_CELL)))
    return {"bytes": N * per_floe + rings + 8, "operations": ops, "rows": N,
            "live_rows": int(live.sum()), "cells": int(kept.sum())}


def launch_inputs(model, sim) -> dict:
    """What the step hands B6 in the state ``model``: the reference's
    window mask at the Simulation's ``cell_cap``, by floe."""
    import torch

    from ..reference.physics import coupling

    f, g = model.floes, model.grid
    cap = sim.cell_cap
    cx0 = torch.floor((f.centroid[:, 0] - g.x0) / g.dx + 0.5).long()
    cy0 = torch.floor((f.centroid[:, 1] - g.y0) / g.dy + 0.5).long()
    offs = torch.arange(cap, device=f.verts.device) - cap // 2
    pair_ok = coupling._floe_cell_areas(f, g, model.domain, cap, cx0, cy0, offs)[4]
    return {"N": int(f.verts.shape[0]), "A": cap, "B": cap, "elt": f.verts.element_size(),
            "nverts": f.nverts.cpu().numpy(), "kept": pair_ok.sum((1, 2)).cpu().numpy()}


def bound(inputs: dict, peaks: dict) -> dict:
    """The least time the card could take for the launch, and what bounds
    it: its bytes over the memory rate or its operations over the f32
    rate, the larger."""
    c = counts(**inputs)
    by_bytes = c["bytes"] / peaks["bytes_per_s"]
    by_ops = c["operations"] / peaks["f32_ops_per_s"]
    return dict(c, bound_s=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")
