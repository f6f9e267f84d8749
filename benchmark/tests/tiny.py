"""Tiny cells for the CPU tests: the shear_flow and many_floes
configurations and their cells with the box, the floe count and the pass
cut down (widths kept: grid spacing ratios, dt, call length), and the
life-cycle cadences shortened so that every host pass runs in a short
pass.  The limits of ``correct`` are the real cells'."""

from __future__ import annotations

import copy

from benchmark import build, harness


def scan_cell(entry: str = "run_scan") -> harness.Cell:
    cfg = copy.deepcopy(build.load_json("configs", "shear_flow"))
    cfg["domain"]["x"] = [0.0, 2e4]
    cfg["domain"]["y"] = [0.0, 2e4]
    cfg["ocean"]["u"] = {"ends": 0.0, "peak": 0.5, "rise": 6}
    cfg["floes"]["count"] = 20
    cfg["cell_cap"] = None     # the port's rule, from the tiny field's floes
    cfg["n_dt"] = 40
    cfg["smooth_dt"] = 4
    spec = copy.deepcopy(build.load_json(
        "cells", "shear_flow.scan" if entry == "run_scan" else "shear_flow.run"))
    spec["warmup_steps"] = [0] if entry == "run_scan" else [0, 10]
    spec["check"] = dict(spec["check"], calls=4, at_steps=[])
    return harness.Cell(f"tiny_shear_flow.{entry}", spec, cfg)


def life_cycle_cell() -> harness.Cell:
    cfg = copy.deepcopy(build.load_json("configs", "many_floes"))
    cfg["domain"]["x"] = [-2e4, 2e4]
    cfg["domain"]["y"] = [-2e4, 2e4]
    cfg["grid"] = {"dx": 4000.0, "dy": 4000.0}
    cfg["floes"]["count"] = 30
    cfg["floes"]["pool"] = 60
    cfg["cell_cap"] = None
    cfg["n_dt"] = 40
    cfg["fracture"]["dt"] = 5
    cfg["ridge_raft"]["dt"] = 10
    cfg["weld"] = {"dts": [20], "nxs": [2], "nys": [2]}
    cfg["smooth_dt"] = 4
    spec = copy.deepcopy(build.load_json("cells", "many_floes.run"))
    spec["warmup_steps"] = [0, 10, 20]
    spec["check"] = dict(spec["check"], calls=2, at_steps=[10, 20])
    return harness.Cell("tiny_many_floes.run", spec, cfg)
