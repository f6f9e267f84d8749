"""B1, the narrow phase (``subzero_tpu_torch/csrc/two_cross.cu``): one warp
a candidate row.  Every row reads its own entries (the pair's two indices,
its validity flag, its perturbation and its periodic shift) and writes one
output row (10 floats, a crossing count and a flag); a live row also reads
the two rings' vertex counts and vertices.  Counted as the launch's rows
need them, each input byte read once (a floe's ring once, however many of
its rows are live) and each output byte written once.  Operations: a
crossing test for each of a live row's edge pairs and a shoelace term for
each of its vertices (``two_cross.cuh``)."""

from __future__ import annotations

import numpy as np

EVENT = "two_cross_"       # two_cross_kernel and two_cross_wide_kernel
OPS_PER_EDGE_PAIR = 30     # one crossing test (two_cross.cuh:edge_crossing)
OPS_PER_VERTEX = 3         # one shoelace term
OUT_FLOATS = 10            # contain, area, centroid, chord_a, chord_b, p_norm


def counts(rows: int, elt: int, live_i, live_j, p_n, q_n) -> dict:
    """Bytes and operations of one launch over ``rows`` candidate rows of
    float width ``elt``, whose live rows pair P floe ``live_i[k]`` with Q
    slot ``live_j[k]``; ``p_n`` / ``q_n``: the pools' vertex counts."""
    live_i = np.asarray(live_i, np.int64)
    live_j = np.asarray(live_j, np.int64)
    p_n = np.asarray(p_n, np.int64)
    q_n = np.asarray(q_n, np.int64)
    per_row_in = 8 + 8 + 1 + elt + 2 * elt      # qi, qj, valid, perturb, shift
    per_row_out = OUT_FLOATS * elt + 4 + 1      # out, cnt, ok
    pi, qj = np.unique(live_i), np.unique(live_j)
    rings = int(np.sum(4 + 2 * elt * p_n[pi]) + np.sum(4 + 2 * elt * q_n[qj]))
    pn, qn = p_n[live_i], q_n[live_j]
    ops = int(OPS_PER_EDGE_PAIR * np.sum(pn * qn) + OPS_PER_VERTEX * np.sum(pn + qn))
    return {"bytes": rows * (per_row_in + per_row_out) + rings, "operations": ops,
            "rows": rows, "live_rows": len(live_i)}


def launch_inputs(model, sim) -> dict:
    """The batch the step hands B1 in the state ``model``: the reference's
    broad phase and pair list (``narrow_phase_batch``) at the Simulation's
    capacities."""
    from ..reference.physics import collisions

    nb = collisions.narrow_phase_batch(model.floes, model.domain, sim.pair_cap, sim.bins)
    valid = nb.pairs.valid.cpu().numpy().astype(bool)
    return {"rows": int(nb.pairs.qi.shape[0]), "elt": nb.p_verts.element_size(),
            "live_i": nb.pairs.qi.cpu().numpy()[valid],
            "live_j": nb.pairs.qj.cpu().numpy()[valid],
            "p_n": nb.p_n.cpu().numpy(), "q_n": nb.q_n.cpu().numpy()}


def bound(inputs: dict, peaks: dict) -> dict:
    """The least time the card could take for the launch, and what bounds
    it: its bytes over the memory rate or its operations over the f32
    rate, the larger."""
    c = counts(**inputs)
    by_bytes = c["bytes"] / peaks["bytes_per_s"]
    by_ops = c["operations"] / peaks["f32_ops_per_s"]
    return dict(c, bound_s=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")
