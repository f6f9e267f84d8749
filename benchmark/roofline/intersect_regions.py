"""B2, the slow clip (``subzero_tpu_torch/csrc/intersect_regions.cu``): one
warp a row of the step's slow selection, ``slow_cap`` rows a launch.  Every
row reads its selection entry and writes its output row (a total, ``cap``
regions of 10 floats and 3 int32 and a flag each, and its overflow and
parity flags); a live row (one of the first ``n_slow``) also reads its
pair's indices, perturbation and periodic shift and the two rings' vertex
counts and vertices, and a row whose crossing parity came out odd and is
retried (the first ``RETRY_CAP`` of them) writes its first result into the
launch's scratch as well.  Counted as the launch's rows need them, each
input byte read once (a floe's ring once, however many of its rows are
live) and each output byte written once.  Operations: a crossing test for
each of a live row's edge pairs and the ring sums of each of its vertices
(``intersect_regions.cuh``: ``seg_terms`` over the ring walked twice, the
four prefix adds and the shoelace term), twice on a retried row.

The rows are the reference's own: its broad phase, narrow phase and slow
selection (``collisions._slow_path``) on the state, so the count is the
same whatever implements B2."""

from __future__ import annotations

import numpy as np

from .two_cross import OPS_PER_EDGE_PAIR

EVENT = "regions_kernel"
OPS_PER_VERTEX = 2 * (14 + 4) + 4   # seg_terms and 4 prefix adds, twice; shoelace


def row_bytes(cap: int, elt: int) -> int:
    """One output row (intersect_regions.cuh:out_views): 1 + 10 cap floats,
    3 cap int32, cap + 2 bytes."""
    return (1 + 10 * cap) * elt + 12 * cap + cap + 2


def counts(rows: int, cap: int, elt: int, live_i, live_j, p_n, q_n, retried) -> dict:
    """Bytes and operations of one launch over ``rows`` selection rows with
    ``cap`` regions a row in floats of width ``elt``, whose live rows pair
    P floe ``live_i[k]`` with Q slot ``live_j[k]`` (``retried[k]``: row k
    is clipped again); ``p_n`` / ``q_n``: the pools' vertex counts."""
    live_i = np.asarray(live_i, np.int64)
    live_j = np.asarray(live_j, np.int64)
    retried = np.asarray(retried, bool)
    p_n = np.asarray(p_n, np.int64)
    q_n = np.asarray(q_n, np.int64)
    per_live_in = 8 + 8 + elt + 2 * elt         # qi, qj, perturb, shift
    pi, qj = np.unique(live_i), np.unique(live_j)
    rings = int(np.sum(4 + 2 * elt * p_n[pi]) + np.sum(4 + 2 * elt * q_n[qj]))
    out = rows * row_bytes(cap, elt) + int(retried.sum()) * row_bytes(cap, elt)
    pn, qn = p_n[live_i], q_n[live_j]
    once = OPS_PER_EDGE_PAIR * pn * qn + OPS_PER_VERTEX * (pn + qn)
    ops = int(np.sum(once * (1 + retried)))
    return {"bytes": 8 + rows * 8 + len(live_i) * per_live_in + rings + out,
            "operations": ops, "rows": rows, "live_rows": len(live_i)}


def launch_inputs(model, sim) -> dict:
    """The rows the step hands B2 in the state ``model``: the reference's
    candidate list at the Simulation's capacities, its narrow phase, and its
    slow selection with the parity retry."""
    from ..reference.geometry.clip import two_cross_pairs
    from ..reference.physics import collisions

    nb = collisions.narrow_phase_batch(model.floes, model.domain, sim.pair_cap, sim.bins)
    tc = two_cross_pairs(*nb.two_cross_args())
    slow = collisions._slow_path(nb, tc, sim.pair_cap, sim.clip_cap, retry=True)
    rows = int(slow.sel.shape[0])
    live = int(min(int(slow.n_slow), rows))
    bad = slow.parity_bad.cpu().numpy()[:live]
    retried = bad & (np.cumsum(bad) <= collisions.RETRY_CAP)
    return {"rows": rows, "cap": sim.clip_cap, "elt": nb.p_verts.element_size(),
            "live_i": slow.i.cpu().numpy()[:live], "live_j": slow.j.cpu().numpy()[:live],
            "p_n": nb.p_n.cpu().numpy(), "q_n": nb.q_n.cpu().numpy(), "retried": retried}


def bound(inputs: dict, peaks: dict) -> dict:
    """The least time the card could take for the launch, and what bounds
    it: its bytes over the memory rate or its operations over the f32
    rate, the larger."""
    c = counts(**inputs)
    by_bytes = c["bytes"] / peaks["bytes_per_s"]
    by_ops = c["operations"] / peaks["f32_ops_per_s"]
    return dict(c, bound_s=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")
