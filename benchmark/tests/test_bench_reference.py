"""The reference agrees with the program's CPU path at a tiny size, and
neither the harness nor the reference loads what it must not."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from benchmark import run
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("make", [lambda: tiny.scan_cell("run_scan"),
                                  lambda: tiny.scan_cell("run"), tiny.life_cycle_cell],
                         ids=["shear_flow.run_scan", "shear_flow.run", "many_floes.run"])
def test_reference_agrees_with_the_programs_cpu_path(make):
    cell = make()
    r, numbers, ok, shown, failed = run.run_cell(cell, 2**31 + 5, 1.0, False, "cpu",
                                                 clock=lambda: 0.0)
    assert numbers["calls_compared"] >= 1
    assert numbers["init_mismatch"] == 0 and numbers["step_mismatch"] == 0
    assert numbers["init_gap"] <= cell.spec["check"]["limits"]["init_gap"]
    assert numbers["step_gap"] <= cell.spec["check"]["limits"]["step_gap"]
    assert ok and failed == 0
    assert r.window.steps == len(r.window.records) * cell.call_steps


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code) + textwrap.dedent("""
        import sys
        print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
        """)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("""
        from benchmark.reference import core, simulation, settings, constants
        from benchmark.reference.physics import collisions, lifecycle_host
        """)
    assert not loaded & {"subzero_tpu_torch", "subzero_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax_nor_the_jax_package():
    loaded = _loaded_after("""
        import torch
        torch.set_num_threads(1)
        from benchmark import run
        from benchmark.tests import tiny
        run.run_cell(tiny.life_cycle_cell(), 3, 0.5, False, "cpu", clock=lambda: 0.0)
        """)
    assert "subzero_tpu_torch" in loaded
    assert not loaded & {"subzero_tpu", "jax", "jaxlib", "flax"}


def test_reference_host_clip_gives_the_programs_rings():
    """The reference's pure Python booleans against the program's host clip
    (its native build, then its Python ladder): the same rings to the bit,
    and the same failures, on star-shaped pairs of 4-19 vertices at the
    fields' coordinates, one pair in seven sharing a vertex."""
    import numpy as np

    from benchmark.reference.geometry import host_clip as ref_clip
    from subzero_tpu_torch.geometry import host_clip as prog_clip

    rng = np.random.default_rng(11)

    def ring(cx, cy):
        nv = int(rng.integers(4, 20))
        th = np.sort(rng.random(nv)) * 2 * np.pi
        r = 3000.0 * (0.7 + 0.3 * rng.random(nv))
        return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)

    def boolean(clip, S, C, op):
        try:
            return clip._with_retries(S, C, op)
        except RuntimeError:
            return None

    failed = 0
    for k in range(300):
        S = ring(5e4, 5e4)
        C = ring(*(5e4 + rng.uniform(-5e3, 5e3, 2)))
        if k % 7 == 0:
            C[0] = S[0]
        for op in ("and", "or", "diff"):
            got, want = boolean(ref_clip, S, C, op), boolean(prog_clip, S, C, op)
            if want is None:
                assert got is None, (k, op)
                failed += 1
                continue
            assert got is not None and len(got) == len(want), (k, op)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"pair {k}, {op}")
    assert failed < 100
