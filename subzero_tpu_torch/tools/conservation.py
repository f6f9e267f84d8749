"""Energy / momentum conservation diagnostics (port of
``subzero_tpu/tools/conservation.py``).

Mirrors the reference's conservation checker (src/tools/conservation_em.jl:
16-151): kinetic energy, linear momentum, and angular momentum (spin +
orbital) of the floe field, for use as a time series over a simulation.
"""

from __future__ import annotations

import math

import torch


def floe_energy_momentum(floes):
    """Returns dict of totals over active floes (0-d tensors):
    kinetic energy, linear momentum (x, y), angular momentum (spin+orbital).
    """
    m = torch.where(floes.active, floes.mass, 0.0)
    moment = torch.where(floes.active, floes.moment, 0.0)
    u, v, xi = floes.u, floes.v, floes.xi
    x = floes.centroid[:, 0]
    y = floes.centroid[:, 1]
    ke = 0.5 * torch.sum(m * (u * u + v * v)) + 0.5 * torch.sum(moment * xi * xi)
    px = torch.sum(m * u)
    py = torch.sum(m * v)
    l_spin = torch.sum(moment * xi)
    l_orb = torch.sum(m * (x * v - y * u))
    return {
        "ke": ke,
        "px": px,
        "py": py,
        "l": l_spin + l_orb,
    }


def drift_percent(series):
    """Percent change from first to last value for each tracked quantity.

    series: dict of 1-D tensors (time series). Matches the reference's
    conservation_simulation summary (test_conservation.jl:50-56); returns
    NaN where the initial value is zero.
    """
    out = {}
    for k, vals in series.items():
        first = vals[0]
        last = vals[-1]
        out[k] = torch.where(
            first != 0, (last - first) / first * 100.0, math.nan
        )
    return out
