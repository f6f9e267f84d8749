"""f32 against f64 conservation drift table (port of
``tools/f32_drift_table.py``).

Runs conservation scenarios at both widths through the full step (on the
card the narrow phase is the CUDA kernel) and prints the percent drift over
5 000 steps of KE, linear momentum and angular momentum, the diagnostics
accumulated in f64 either way.  complex_shapes reads the reference's floe
shapes (``tools.fixtures``, ``$SUBZERO_REFERENCE_DIR``).

    python -m subzero_tpu_torch.tools.f32_drift_table [SCENARIO ...]

With no scenario named it runs all four of ``scenarios.SCENARIOS``.
"""

from __future__ import annotations

import sys

import torch

from .scenarios import SCENARIOS, conservation_run

KEYS = ("ke", "px", "py", "l")
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def drift_table(scenarios=SCENARIOS, n_steps=5000, device=None) -> dict:
    """{scenario: {"f64": drift, "f32": drift}} with each drift a dict of
    percent changes by quantity, on ``device`` (None: the card)."""
    return {sc: {name: conservation_run(dtype, sc, n_steps, device=device)[0]
                 for name, dtype in DTYPES.items()}
            for sc in scenarios}


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(SCENARIOS)
    unknown = sorted(set(names) - set(SCENARIOS))
    if unknown:
        raise SystemExit(f"unknown scenarios {unknown}; known: {SCENARIOS}")
    print(f"{'scenario':18s} {'dtype':8s} " + " ".join(f"{k:>12s}" for k in KEYS),
          flush=True)
    for sc in names:
        for name, drift in drift_table([sc])[sc].items():
            print(f"{sc:18s} {name:8s} " + " ".join(f"{drift[k]:12.5f}" for k in KEYS),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
