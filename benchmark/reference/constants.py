"""Physical constants for the simulation.

The port's own copy of the JAX package's ``subzero_tpu/constants.py``: the
``Constants`` struct of Subzero.jl (src/simulation_components/
simulation.jl:5-18), so that default-configured simulations are directly
comparable.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Constants:
    rho_o: float = 1027.0       # ocean density [kg/m^3]
    rho_a: float = 1.2          # air density [kg/m^3]
    Cd_io: float = 3e-3         # ice-ocean drag coefficient
    Cd_ia: float = 1e-3         # ice-atmosphere drag coefficient
    Cd_ao: float = 1.25e-3      # atmosphere-ocean drag coefficient
    f: float = 1.4e-4           # Coriolis frequency [1/s]
    turn_angle: float = 15.0 * math.pi / 180.0  # ocean turning angle [rad]
    L: float = 2.93e5           # latent heat of freezing [J/kg]
    k: float = 2.14             # thermal conductivity of surface ice [W/(m K)]
    nu: float = 0.3             # Poisson's ratio
    mu: float = 0.2             # coefficient of friction
    E: float = 6e6              # Young's modulus [Pa]

    def replace(self, **kw) -> "Constants":
        return dataclasses.replace(self, **kw)
