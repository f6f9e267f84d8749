"""Shared helpers for the example scripts."""

import numpy as np


def modulus_from_floes(floes):
    """The examples' Young's modulus convention:
    E = 1.5e3 * (mean(sqrt(area)) + min(sqrt(area)))
    (e.g. the reference's examples/uniform_flow.jl:38)."""
    area = floes.area[floes.active].cpu().numpy()
    return float(1.5e3 * (np.mean(np.sqrt(area)) + np.min(np.sqrt(area))))
