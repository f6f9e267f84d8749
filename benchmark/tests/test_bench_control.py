"""The control, the reference put in the program's place at a lower
precision than the configuration's float32, comes out not correct under
the cell's limits (``benchmark.calibrate``; on the chip at the cells' own
size, PERF.md): bfloat16 on the CPU, and TF32 matmuls on the card."""

import pytest
import torch

from benchmark import calibrate
from benchmark.tests import tiny


def _control_fails(cell, control, device):
    r = calibrate.readings(cell, 2**31 + 11, [control], device)
    limits = cell.spec["check"]["limits"]
    prog, ctl = r["program"], r["controls"][control]
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert "crashed" in ctl or any(ctl[k] > limits[k] for k in limits), ctl


@pytest.mark.parametrize("make", [lambda: tiny.scan_cell("run_scan"), tiny.life_cycle_cell],
                         ids=["shear_flow.run_scan", "many_floes.run"])
def test_bf16_control_is_not_correct(make):
    _control_fails(make(), "bf16", "cpu")


@pytest.mark.cuda
def test_tf32_control_is_not_correct_on_the_card(cuda_device):
    _control_fails(tiny.scan_cell("run_scan"), "tf32", cuda_device)
    assert not torch.backends.cuda.matmul.allow_tf32
