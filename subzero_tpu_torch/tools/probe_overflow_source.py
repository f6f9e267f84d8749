"""Which collision capacity fires a step's overflow flag? (port of
``tools/probe_overflow_source.py``)

A step's overflow flag is the OR of four terms of ``timestep_collisions``:
the candidate rows running out (``pairs_overflow``), the compacted list
(``compact_overflow``; the compaction branch is not ported, so never), more
multi-crossing pairs than the slow path holds (``n_slow > slow_cap``), and a
crossing parity the retry could not repair (``clip_overflow``).  The probe
computes ``timestep_collisions(..., with_debug=True)`` on the pre-step state
of every step, prints the counters of every step where a term fired, and
totals the hits by term.  On a step whose candidate rows ran out it also
names the crowded floe: its row's candidates against ``row_cap`` plus the
``D_SPILL`` a floe may spill into the second-chance list.

``probe_steps`` steps a Simulation with ``build_step`` (the JAX tool's
loop); ``probe_run`` drives ``run`` and probes through its callback, so
that the host life-cycle passes happen where they happen.

    python -m subzero_tpu_torch.tools.probe_overflow_source [N_STEPS] [--device cpu]

runs the JAX tool's configuration: ``examples.shear_flow.build(n_dt=N_STEPS)``
(2 000 by default) with 16 candidate rows a floe and ``clip_cap`` 32, on the
card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time

import torch

TERMS = ("pairs_overflow", "compact_overflow", "clip_overflow", "slow")


def counters(sim, floes, domain) -> dict:
    """``timestep_collisions(..., with_debug=True)``'s counters on this
    state, at the Simulation's capacities, as Python numbers (one read)."""
    from ..physics.collisions import timestep_collisions

    _, dbg = timestep_collisions(
        floes, domain, sim.consts, float(sim.dt), sim.collision_settings,
        sim.pair_cap, sim.clip_cap, sim.bins, with_debug=True,
    )
    vals = torch.stack([v.to(torch.int64) for v in dbg.values()]).tolist()
    return {k: (bool(v) if dbg[k].dtype == torch.bool else v)
            for k, v in zip(dbg, vals)}


def hits(d: dict) -> dict:
    """The terms of the overflow flag that fired in one step's counters."""
    return {"pairs_overflow": int(d["pairs_overflow"]),
            "compact_overflow": int(d["compact_overflow"]),
            "clip_overflow": int(d["clip_overflow"]),
            "slow": int(d["n_slow"] > d["slow_cap"])}


def crowded_floe(sim, floes, domain) -> dict:
    """The floe with the most broad-phase candidates: its row's count (from
    the broad phase run with room for every candidate of every row) against
    the ``row_cap`` of ``sim.pair_cap`` plus ``D_SPILL``, and the total the
    rows spill against the second-chance list's capacity."""
    from ..physics.collisions import D_SPILL, _extra_cap, find_candidate_pairs

    N = floes.capacity
    NQ = N + 4 + domain.topography.count
    if sim.bins is None:
        C = NQ
    else:
        nbx, nby, M = sim.bins
        C = 9 * M + 4 + domain.topography.count
    full = find_candidate_pairs(floes, domain, N * C, sim.bins)
    n = torch.bincount(full.qi[full.valid], minlength=N)
    row_cap = max(min(sim.pair_cap // max(N, 1), C), 8)
    spill = torch.clamp(n - row_cap, min=0)
    i = int(torch.argmax(n))
    return {"row": i, "id": int(floes.id[i]), "candidates": int(n[i]),
            "row_cap": row_cap, "d_spill": D_SPILL,
            "rows_over_row_cap_plus_spill": int((n > row_cap + D_SPILL).sum()),
            "spilled": int(torch.clamp(spill, max=D_SPILL).sum()),
            "extra_cap": _extra_cap(N),
            "rmax": float(floes.rmax[i]), "area": float(floes.area[i]),
            "candidates_of_all_rows": int(n.sum())}


def overlap_query_terms(sim, floes, domain) -> dict:
    """The terms of ``pair_overlaps``' overflow flag on this state (the
    host passes' query, with no parity retry): the candidate rows
    (``pairs_overflow``), the slow path's rows against its capacity, and
    the rows whose crossing parity came out odd (``n_parity_bad``); and
    the crowded floe when the candidate rows ran out."""
    from ..physics import collisions as C

    nb = C.narrow_phase_batch(floes, domain, sim.pair_cap, sim.bins)
    tc = C.two_cross_dispatch(*nb.two_cross_args())
    slow = C._slow_path(floes, nb, tc, sim.pair_cap, sim.clip_cap, retry=False)
    out = {"pairs_overflow": bool(nb.pairs.overflow),
           "n_candidates": int(nb.pairs.valid.sum()),
           "n_slow": int(slow.n_slow), "slow_cap": int(slow.valid.shape[0]),
           "n_parity_bad": int(slow.parity_bad.sum())}
    if out["pairs_overflow"]:
        out["crowded_floe"] = crowded_floe(sim, floes, domain)
    return out


class Probe:
    """Counts the terms that fired over the states it is shown; prints each
    flagged step's counters through ``out`` (None: silent)."""

    def __init__(self, sim, out=print):
        self.sim, self.out = sim, out
        self.hits = dict.fromkeys(TERMS, 0)
        self.flagged = []       # steps where a term fired
        self.crowded = None     # the first pairs_overflow step's crowded floe

    def __call__(self, tstep, floes, domain) -> dict:
        d = counters(self.sim, floes, domain)
        h = hits(d)
        if any(h.values()):
            self.flagged.append(tstep)
            for k, v in h.items():
                self.hits[k] += v
            if h["pairs_overflow"] and self.crowded is None:
                self.crowded = {"step": tstep,
                                **crowded_floe(self.sim, floes, domain)}
            if self.out is not None:
                self.out(f"step {tstep}: {d}")
        return d

    def report(self) -> dict:
        return {"hits": dict(self.hits), "flagged_steps": len(self.flagged),
                "first_flagged": self.flagged[:10], "crowded_floe": self.crowded}


def probe_steps(sim, n_steps: int, start_tstep: int = 0, out=print) -> dict:
    """Step ``sim`` ``n_steps`` times with ``build_step`` (no host passes),
    probing the pre-step state of each step.  Returns the hits by term, the
    flagged steps and the step's own overflow count (``n_overflow``); the
    model is advanced."""
    from ..simulation import build_step

    step = build_step(sim)
    probe = Probe(sim, out)
    floes, ocean, domain = sim.model.floes, sim.model.ocean, sim.model.domain
    n_over = 0
    for k in range(start_tstep, start_tstep + n_steps):
        probe(k, floes, domain)
        floes, ocean, domain, ov = step(floes, ocean, domain, k)
        n_over += bool(ov)
    sim.model = sim.model.replace(floes=floes, ocean=ocean, domain=domain)
    return {"steps": n_steps, "n_overflow": n_over, **probe.report()}


def probe_run(sim, out=print) -> dict:
    """``run(sim)`` with the probe as its callback (called before every
    step, on the state the step collides).  ``n_overflow`` is run's own
    count, which also counts the host passes' overlap queries that ran
    out of capacity."""
    from ..simulation import run

    probe = Probe(sim, out)
    sim = run(sim, callback=lambda t, floes, ocean, domain: probe(t, floes, domain))
    return {"steps": sim.run_stats["steps"], "n_overflow": sim.n_overflow,
            **probe.report()}


def build(n_steps: int, device=None):
    """The JAX tool's configuration: shear_flow with 16 candidate rows a
    floe and ``clip_cap`` 32."""
    from ..examples import shear_flow

    sim = shear_flow.build(n_dt=n_steps, device=device)
    sim.verbose = False
    sim.pair_cap = 16 * sim.model.floes.capacity
    sim.clip_cap = 32
    return sim


def main(n_steps: int = 2000, device=None) -> dict:
    from ..device import resolve_device

    dev = resolve_device(device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev,
          flush=True)
    sim = build(n_steps, dev)
    t0 = time.time()
    rep = probe_steps(sim, n_steps, out=lambda s: print(s, flush=True))
    print(f"{n_steps} steps in {time.time() - t0:.1f}s; overflow hits: "
          f"{rep['hits']}", flush=True)
    return rep


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_steps", nargs="?", type=int, default=2000)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    a = ap.parse_args()
    main(a.n_steps, a.device)
