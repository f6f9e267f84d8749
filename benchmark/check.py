"""How ``correct`` is decided: the program's answers against the plain
reference (``benchmark.reference``), which imports nothing of the program.

Two stages, each with numbers of its own:

  * the start: the reference builds the initial field from the same
    inputs (polygons, fields, seeds) and works out again what the program
    derived from them (areas, moments, sub-floe points, the modulus, the
    capacities); ``init_gap`` and ``init_mismatch`` hold the program's
    initial state to it;
  * the steps: a simulation is chaotic, so the reference cannot follow the
    program from step 0 to the window's end.  It follows the program call
    by call from the program's own state: for each compared call (drawn
    from the seed, and the calls holding the cell's host passes) it runs
    the same entry over the same steps from the program's state before
    the call, with the same generator state, and the ``step_*`` numbers
    hold the program's state after the call to it.

A floe's gap is, over the floe state's floating fields, the largest
difference between the program's value and the reference's (on its live
vertices and sub-floe points), each as a share of the field's largest
magnitude over the reference's live floes.  ``step_gap`` is the largest
over the live floes and the ocean's fields (each field whole, as a share of
its largest magnitude), ``step_floe_p50`` (``p90``, ``p99``) the median
(90th, 99th percentile) of the live floes' gaps, ``step_ocean_gap`` the
ocean's alone; each the largest over the compared calls.  Where B2, the
slow clip, has live rows, its kernel and the reference's plain version part
in the last bits on ill-conditioned rows, and a floe's rotation can turn
over within a call: the widest gap swings there, and the median floe's
gap is the number that separates the program from a broken one (PERF.md).  A mismatch counts the integer and flag fields (the
live set, ids, vertex and point counts, fuse marks) that differ, and a
generator state or largest id that differs after a ``run`` call.  A cell
compares the numbers its file gives limits for.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import harness

# integer / flag fields compared exactly on every slot
EXACT = ("nverts", "nsub", "active", "remove", "fuse_with", "id", "parent_id")
QUANTILES = {"step_floe_p50": 0.5, "step_floe_p90": 0.9, "step_floe_p99": 0.99}
# every number a cell's file may give a limit for
NUMBERS = ("init_gap", "init_mismatch", "step_gap", *QUANTILES, "step_ocean_gap",
           "step_mismatch")


def _gap(a, b) -> float:
    """Largest |a - b| as a share of the largest |b| (all of both)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    if a.numel() == 0:
        return 0.0
    d = float(torch.max(torch.abs(a - b)))
    if math.isnan(d):
        return math.inf
    s = float(torch.max(torch.abs(b)))
    if s == 0.0:
        return 0.0 if d == 0.0 else 1.0
    return d / s


def _row_mask(name: str, rf, n: int, width: int):
    """[N, width]: the live floes' entries of a field flattened per floe
    (their vertices and sub-floe points only, both coordinates)."""
    live = rf.active[:, None]
    if name == "verts":
        slots = rf.verts.shape[1]
        m = live & (torch.arange(slots, device=live.device)[None, :] < rf.nverts[:, None])
        return m.repeat_interleave(width // slots, dim=1)
    if name in ("sub_x", "sub_y"):
        return live & (torch.arange(width, device=live.device)[None, :] < rf.nsub[:, None])
    return live.expand(n, width)


def state_gap(got, ref) -> dict:
    """The gaps and mismatches between two models' floes and oceans (see
    the module's docstring); ``got`` may be of either package."""
    gf, rf = got.floes, ref.floes
    live = rf.active
    n = live.shape[0]
    floe_gap = torch.zeros(n, dtype=torch.float64, device=live.device)
    where = torch.zeros(n, dtype=torch.long, device=live.device)
    miss, missed, names = 0, [], []
    for name in rf._fields:
        a, b = getattr(gf, name).to(getattr(rf, name).device), getattr(rf, name)
        if name in EXACT:
            k = int(torch.sum(a.reshape(n, -1) != b.reshape(n, -1)))
            if k:
                miss += k
                missed.append(name)
            continue
        if not b.is_floating_point():
            raise TypeError(f"field {name} is neither exact nor floating")
        a2 = a.to(torch.float64).reshape(n, -1)
        b2 = b.to(torch.float64).reshape(n, -1)
        m = _row_mask(name, rf, n, a2.shape[1])
        d = torch.where(m, (a2 - b2).abs(), 0.0).amax(1)
        d = torch.where(torch.isnan(d), math.inf, d)
        s = float(torch.where(m, b2.abs(), 0.0).max()) if a2.numel() else 0.0
        g = d / s if s > 0 else torch.where(d > 0, 1.0, 0.0).to(torch.float64)
        names.append(name)
        worse = g > floe_gap
        floe_gap = torch.where(worse, g, floe_gap)
        where = torch.where(worse, len(names) - 1, where)
    floe_gap, where = floe_gap[live], where[live]
    ocean, ocean_field = 0.0, None
    for name in ref.ocean._fields:
        b = getattr(ref.ocean, name)
        g = _gap(getattr(got.ocean, name).to(b.device), b)
        if g > ocean:
            ocean, ocean_field = g, f"ocean.{name}"
    worst, field = ocean, ocean_field
    if floe_gap.numel():
        i = int(torch.argmax(floe_gap))
        if float(floe_gap[i]) > worst:
            worst, field = float(floe_gap[i]), f"floes.{names[int(where[i])]}"
    out = {"gap": worst, "field": field, "ocean_gap": ocean, "ocean_field": ocean_field,
           "mismatch": miss, "mismatch_fields": missed}
    for k, q in QUANTILES.items():
        out[k] = float(torch.quantile(floe_gap, q)) if floe_gap.numel() else 0.0
    return out


def as_reference_model(model, ref_model):
    """The program's model in the reference's types (the same fields in
    the same order), on the reference's grid and atmosphere."""
    from .reference import core as rc

    d = model.domain
    domain = rc.Domain(kinds=tuple(d.kinds), vals=d.vals, velocities=d.velocities,
                       topography=rc.TopographyField(*d.topography))
    return ref_model.replace(floes=rc.FloeState(*model.floes),
                             ocean=rc.OceanState(*model.ocean), domain=domain)


def round_model(model, dtype):
    """A model with every floating tensor of floes, ocean, atmosphere and
    domain rounded to ``dtype`` and back (the bfloat16 control's input)."""
    def c(t):
        return t.to(dtype).to(t.dtype) if t.is_floating_point() else t

    d = model.domain
    domain = type(d)(kinds=d.kinds, vals=c(d.vals), velocities=c(d.velocities),
                     topography=type(d.topography)(*(c(t) for t in d.topography)))
    return model.replace(floes=type(model.floes)(*(c(t) for t in model.floes)),
                         ocean=type(model.ocean)(*(c(t) for t in model.ocean)),
                         atmos=type(model.atmos)(*(c(t) for t in model.atmos)),
                         domain=domain)


def reference_call(ref_sim, cell: harness.Cell, snap: harness.Snapshot, round_to=None):
    """The compared call, run by the reference from the program's state
    before it.  Returns (model after, generator state, largest id)."""
    from .reference import simulation as rs

    model = as_reference_model(snap.before, ref_sim.model)
    if round_to is not None:
        model = round_model(model, round_to)
    ref_sim.model = model
    t = snap.call_no * cell.call_steps
    if cell.entry == "run_scan":
        rs.run_scan(ref_sim, cell.call_steps, start_tstep=t)
        return ref_sim.model, None, None
    ref_sim.n_dt = cell.call_steps - 1
    ref_sim.rng_state = snap.rng_before
    rs.run(ref_sim, start_tstep=t)
    return ref_sim.model, ref_sim.run_stats["rng_state"], ref_sim.run_stats["max_floe_id"]


def capacities(sim) -> dict:
    """What a Simulation derived from its field besides the state."""
    return {"E": sim.consts.E, "pair_cap": sim.pair_cap, "cell_cap": sim.cell_cap,
            "clip_cap": sim.clip_cap, "bins": sim.bins}


def start_numbers(model, caps: dict, ref_model, ref_caps: dict) -> dict:
    """The start: an initial state, modulus and capacities held to the
    reference's, built from the same inputs."""
    s = state_gap(model, ref_model)
    gap, where = s["gap"], s["field"]
    e_gap = abs(caps["E"] - ref_caps["E"]) / abs(ref_caps["E"])
    if e_gap > gap:
        gap, where = e_gap, "consts.E"
    bad = [c for c in ("pair_cap", "cell_cap", "clip_cap", "bins") if caps[c] != ref_caps[c]]
    return {"init_gap": gap, "init_gap_field": where,
            "init_mismatch": s["mismatch"] + len(bad),
            "init_mismatch_fields": s["mismatch_fields"] + bad}


def step_numbers(ref_sim, cell: harness.Cell, snaps: list, round_to=None,
                 against: Optional[dict] = None) -> dict:
    """The steps: each compared call's program answer held to the
    reference's from the same state.  With ``round_to`` the reference's
    input is rounded to that dtype (the bfloat16 control); with ``against``
    (call -> reference answer) the reference's own answers (a control's)
    are held to those in the program's place."""
    out = {"step_gap": 0.0, "step_gap_field": None, "step_ocean_gap": 0.0,
           "step_mismatch": 0, "step_mismatch_fields": [], "per_call": {}, "answers": {}}
    out.update(dict.fromkeys(QUANTILES, 0.0))
    for snap in snaps:
        model, rng, maxid = reference_call(ref_sim, cell, snap, round_to)
        out["answers"][snap.call_no] = (model, rng, maxid)
        if against is None:
            got, want = (snap.after, snap.rng_after, snap.max_floe_id), (model, rng, maxid)
        else:
            got, want = (model, rng, maxid), against[snap.call_no]
        s = state_gap(got[0], want[0])
        m, mf = s["mismatch"], list(s["mismatch_fields"])
        if cell.entry == "run":
            if got[1] != want[1]:
                m, mf = m + 1, mf + ["rng_state"]
            if got[2] != want[2]:
                m, mf = m + 1, mf + ["max_floe_id"]
        call = {"step_gap": s["gap"], "field": s["field"], "step_ocean_gap": s["ocean_gap"],
                "step_mismatch": m}
        call.update({k: s[k] for k in QUANTILES})
        out["per_call"][snap.call_no] = call
        if s["gap"] > out["step_gap"]:
            out["step_gap"], out["step_gap_field"] = s["gap"], f"call {snap.call_no}: {s['field']}"
        for k in ("step_ocean_gap", *QUANTILES):
            out[k] = max(out[k], call[k])
        out["step_mismatch"] += m
        out["step_mismatch_fields"] += [f"call {snap.call_no}: {x}" for x in mf]
    out["calls_compared"] = len(snaps)
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, the compared numbers beside their limits, failed calls):
    every number the cell gives a limit for is at or under it, and at
    least one call was compared."""
    shown = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in shown.values()) and numbers["calls_compared"] > 0
    failed = sum(1 for c in numbers["per_call"].values()
                 if any(k in c and c[k] > v for k, v in limits.items()))
    return ok, shown, failed
