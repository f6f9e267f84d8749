"""The readings that the limits of ``correct`` are set from (PERF.md), on
the chip at a cell's own size; the benchmark's own runs never run it.

    python -m benchmark.calibrate --workload shear_flow.scan --seeds 1,2,3 --controls tf32,bf16

For each seed, in one process: the cell's set-up, then the program through
the first pass's calls up to the last compared one (the calls the window
compares, driven as the window drives them), then the reference, and:

  * the program's numbers (``check``): the lower readings;
  * each control's: the reference put in the program's place at a lower
    precision than the configuration's float32, its answers held to the
    float32 reference's as the program's are.  ``tf32``: float32 with
    TF32 matmuls (the coupling's one-hot products); ``bf16``: every
    floating tensor of the state rounded to bfloat16 where each step and
    each host pass stores it (the state kept in bfloat16), the arithmetic
    in float32 (the host passes' numpy has no bfloat16).

and each of ``faults``' faults planted in the reference's answers.  Prints
one JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import warnings

import torch

from . import check, harness
from .inputs import make_inputs
from .faults import FAULTS


@contextlib.contextmanager
def tf32_matmuls():
    from .reference import simulation as rs

    saved = (rs.ALLOW_TF32, torch.backends.cuda.matmul.allow_tf32)
    rs.ALLOW_TF32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        rs.ALLOW_TF32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def bf16_state():
    from .reference import simulation as rs

    rs.STORE_DTYPE = torch.bfloat16
    try:
        yield
    finally:
        rs.STORE_DTYPE = None


def drive_samples(cell: harness.Cell, seed: int, device: str):
    """Set-up and the first pass's calls up to the last compared one.
    Returns (inputs, the program's initial model, its capacities, the
    compared calls' snapshots)."""
    port = harness.port_package()
    inp = make_inputs(cell.cfg, seed)
    sim = harness.build_program(cell, inp, device)
    driver = harness.Driver(sim, cell, port.simulation)
    harness.warm_up(driver)
    samples = harness.sample_calls(cell, seed)
    hooks = harness.Hooks(driver, samples)
    driver.restore()
    for k in range(max(samples) + 1):
        hooks.before(0, k)
        driver.call(k)
        hooks.after(0, k)
    caps, initial, snaps = check.capacities(sim), driver.initial, hooks.snapshots()
    sim._graph = None
    return inp, initial, caps, snaps


def readings(cell: harness.Cell, seed: int, controls, device: str) -> dict:
    inp, initial, caps, snaps = drive_samples(cell, seed, device)
    harness.free()
    ref = harness.build_reference(cell, inp, device)
    ref0, ref_caps = ref.model, check.capacities(ref)
    prog = check.start_numbers(initial, caps, ref0, ref_caps)
    steps = check.step_numbers(ref, cell, snaps)
    prog.update(steps)
    out = {"seed": seed, "program": _plain(prog), "controls": {}}
    for c in controls:
        try:
            out["controls"][c] = _plain(control_numbers(c, cell, inp, device, snaps, steps,
                                                        ref0, ref_caps))
        except Exception as e:  # a control that crashes has failed, and reads nothing
            out["controls"][c] = {"crashed": repr(e)}
    out["faults"] = fault_numbers(cell, snaps, steps["answers"], ref0)
    return out


def control_numbers(c, cell, inp, device, snaps, steps, ref0, ref_caps) -> dict:
    """The control ``c``'s numbers: the reference at that precision, put in
    the program's place and held to the float32 reference's answers."""
    if c == "tf32":
        with tf32_matmuls():
            cref = harness.build_reference(cell, inp, device)
            st = check.start_numbers(cref.model, check.capacities(cref), ref0, ref_caps)
            st.update(check.step_numbers(cref, cell, snaps, against=steps["answers"]))
        return st
    if c == "bf16":
        with bf16_state():
            cref = harness.build_reference(cell, inp, device)
            st = check.start_numbers(check.round_model(cref.model, torch.bfloat16),
                                     check.capacities(cref), ref0, ref_caps)
            st.update(check.step_numbers(cref, cell, snaps, round_to=torch.bfloat16,
                                         against=steps["answers"]))
        return st
    raise ValueError(f"unknown control {c!r}")


def fault_numbers(cell: harness.Cell, snaps, answers: dict, ref_model) -> dict:
    """Each fault of ``faults`` planted in the reference's answer (put in
    the program's place), held to the reference's answer."""
    out = {}
    for name, fault in FAULTS.items():
        worst = {}
        for snap in snaps:
            want = answers[snap.call_no][0]
            got = fault(check.as_reference_model(snap.before, ref_model), want)
            s = check.state_gap(got, want)
            s["step_gap"], s["step_ocean_gap"], s["step_mismatch"] = s["gap"], s["ocean_gap"], s["mismatch"]
            for k in ("step_gap", "step_ocean_gap", "step_mismatch", *check.QUANTILES):
                worst[k] = max(worst.get(k, 0.0), s[k])
        out[name] = worst
    return out


def _plain(numbers: dict) -> dict:
    return {k: v for k, v in numbers.items() if k != "answers"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="tf32,bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    warnings.filterwarnings("ignore", module="subzero_tpu_torch")
    cell = harness.load_cell(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    for s in args.seeds.split(","):
        with contextlib.redirect_stdout(sys.stderr):
            r = readings(cell, int(s), controls, args.device)
        print(json.dumps(r, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
