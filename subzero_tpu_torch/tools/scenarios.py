"""Dtype-parameterized conservation scenarios (port of
``subzero_tpu/tools/scenarios.py``).

The reference pins its conservation property suite to Float64
(test/test_conservation.jl:93-205); the production path runs float32 (and
the narrow-phase CUDA kernel on the card).  This module builds the same mini
collision simulations for EITHER dtype so the f32 error budget can be
measured against the f64 numbers.

Diagnostics are always accumulated in float64 (the measurement must not add
f32 noise of its own); only the simulated physics runs at ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from .conservation import drift_percent, floe_energy_momentum


def _f64_diagnostics(floes, ocean):
    return floe_energy_momentum(floes.to(dtype=torch.float64))


def conservation_run(dtype, scenario, n_steps=5000, device=None):
    """Run one named conservation scenario at ``dtype`` on ``device`` (None:
    the card).

    Returns (drift_percent dict, sim).  Scenarios mirror
    test_conservation.jl: 'head_on', 'offset_rotation', 'three_floes',
    'complex_shapes' (friction off, coupling off, open walls, dt=1).
    """
    from ..constants import Constants
    from ..core import (
        BoundaryKind,
        make_atmos,
        make_domain,
        make_grid,
        make_model,
        make_ocean,
    )
    from ..core.floes import build_floes
    from ..device import resolve_device
    from ..settings import CouplingSettings, FloeSettings, SubGridPointsGenerator
    from ..simulation import Simulation, run_scan

    device = resolve_device(device)
    grid = make_grid(-2e4, 1e5, 0.0, 1e5, dx=1e4, dy=1e4)
    O = BoundaryKind.OPEN
    fset = FloeSettings(
        min_floe_area=0.0, subfloe_point_generator=SubGridPointsGenerator(1e9)
    )
    floe1 = [[2e4, 2e4], [2e4, 5e4], [5e4, 5e4], [5e4, 2e4]]
    floe2 = [[6e4, 2e4], [6e4, 5e4], [9e4, 5e4], [9e4, 2e4]]
    floe3 = [[5.5e4, 2e4], [5.25e4, 4e4], [5.75e4, 4e4]]

    if scenario == "head_on":
        coords = [floe1, floe2]
        us, vs, xis = [0.15, -0.1], [0.02, 0.02], [1e-7, 0.0]
    elif scenario == "offset_rotation":
        coords = [floe1, [[x, y + 1e4] for x, y in floe2]]
        us, vs, xis = [0.15, -0.1], [0.02, 0.02], [0.0, 0.0]
    elif scenario == "three_floes":
        coords = [floe1, [[x - 1.5e3, y] for x, y in floe2], floe3]
        us, vs, xis = [0.15, -0.1, 0.0], [0.02, 0.015, 0.01], [1e-7, 0.0, 0.0]
    elif scenario == "complex_shapes":
        from .fixtures import load_floe_shapes

        shapes = load_floe_shapes(max_verts=30)
        a = shapes[1] - shapes[1].mean(0)
        b = shapes[3] - shapes[3].mean(0)
        ra = np.abs(a).max()
        rb = np.abs(b).max()
        coords = [a + np.array([4e4, 4e4]),
                  b + np.array([4e4 + ra + rb + 2e3, 4e4])]
        us, vs, xis = [0.15, -0.1], [0.02, 0.015], [1e-7, 0.0]
    else:
        raise ValueError(f"unknown scenario {scenario!r}")

    kw = dict(dtype=dtype, device=device)
    domain = make_domain(grid, O, O, O, O, **kw)
    fl = build_floes(coords, 0.25, 0.0, fset, np.random.default_rng(1), **kw)
    fl = fl._replace(
        u=torch.as_tensor(us, **kw),
        v=torch.as_tensor(vs, **kw),
        xi=torch.as_tensor(xis, **kw),
    )
    ocean = make_ocean(grid, 0.0, 0.0, 0.0, **kw)
    atmos = make_atmos(grid, 0.0, 0.0, 0.0, **kw)
    model = make_model(grid, ocean, atmos, domain, fl)
    area = fl.area[fl.active].cpu().numpy()
    modulus = 1.5e3 * (np.mean(np.sqrt(area)) + np.min(np.sqrt(area)))
    sim = Simulation(
        model=model,
        consts=Constants(E=float(modulus), mu=0.0),
        dt=1,
        n_dt=n_steps,
        floe_settings=fset,
        coupling_settings=CouplingSettings(coupling_on=False),
    )
    sim, series = run_scan(sim, n_steps, collect=_f64_diagnostics)
    drift = drift_percent(series)
    return {k: float(v) for k, v in drift.items()}, sim


SCENARIOS = ("head_on", "offset_rotation", "three_floes", "complex_shapes")
