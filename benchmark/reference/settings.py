"""Process-settings dataclasses.

The port's own copy of the JAX package's ``subzero_tpu/settings.py`` (the
port imports nothing of that package): the typed settings structs of
Subzero.jl (src/physical_processes/process_settings.jl) with their default
values, so that configurations translate one-to-one.  All settings are
frozen and hashable.  tests/test_torch_independence.py holds every class to
the JAX package's, field by field.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MonteCarloPointsGenerator:
    """Random sub-floe points (coupling.jl:27-52). npoints drawn in the floe
    bounding box; regenerated up to ntries times until the covered-area error
    is below err."""

    npoints: int = 1000
    ntries: int = 10
    err: float = 0.1

    def __post_init__(self):
        if self.npoints < 1:
            raise ValueError("npoints must be positive")
        if self.ntries < 1:
            raise ValueError("ntries must be positive")
        if not (0 <= self.err <= 1):
            raise ValueError("err must be between 0 and 1")


@dataclasses.dataclass(frozen=True)
class SubGridPointsGenerator:
    """Deterministic edge+interior lattice points (coupling.jl:86-98).

    ``max_points`` (extension over the reference): cap on the per-floe
    point count.  The coupling pipeline is padded to the LARGEST floe's
    point count, so one oversized floe makes every floe pay its quadrature
    cost (at the 16k-floe bench the max is 233 points vs a ~21-point mean -
    ~10x wasted interpolation/deposition work, ~50 ms of a ~64 ms coupling
    invocation).  A floe exceeding the cap keeps a deterministic
    every-k-th subsample of its natural point set (proportional over the
    ordered edge-then-interior list, so the edge/interior balance of the
    reference's points-mean estimator is preserved - regenerating on a
    coarser lattice instead shifts that balance and biases torque by ~20%,
    while thinning measured <=3.5% on a pathological 12:1-thinned floe and
    is unbiased in expectation).  ``max_points=None`` disables the cap
    (exact reference point sets at any floe size)."""

    dg: float = 0.0
    max_points: int | None = None

    def __post_init__(self):
        if self.dg <= 0:
            raise ValueError("dg must be positive")

    @staticmethod
    def from_grid(
        grid, npoint_per_cell: int, max_points: int | None = 128
    ) -> "SubGridPointsGenerator":
        # coupling.jl:138-144
        return SubGridPointsGenerator(
            min(grid.dx, grid.dy) / npoint_per_cell / (2.0 ** 0.5),
            max_points,
        )


@dataclasses.dataclass(frozen=True)
class DecayAreaScaledCalculator:
    """Stress EMA accumulator (stress_calculators.jl:81-132)."""

    lam: float = 0.2
    alpha: float = 0.0


@dataclasses.dataclass(frozen=True)
class FloeSettings:
    """process_settings.jl:20-100."""

    rho_i: float = 920.0
    min_floe_area: float = 1e6
    min_floe_height: float = 0.1
    max_floe_height: float = 10.0
    min_aspect_ratio: float = 0.05
    maximum_xi: float = 1e-5
    subfloe_point_generator: object = MonteCarloPointsGenerator()
    stress_calculator: object = DecayAreaScaledCalculator()

    def __post_init__(self):
        def reset(field, cond, default):
            if cond:
                warnings.warn(f"{field} invalid; resetting to {default}")
                object.__setattr__(self, field, default)

        reset("rho_i", self.rho_i < 0, 920.0)
        reset("min_floe_area", self.min_floe_area < 0, 1e6)
        reset("min_floe_height", self.min_floe_height < 0, 0.1)
        reset("max_floe_height", self.max_floe_height < 0, 10.0)
        reset("min_aspect_ratio", not (0 < self.min_aspect_ratio < 1), 0.05)
        reset("maximum_xi", self.maximum_xi <= 0, 1e-5)


@dataclasses.dataclass(frozen=True)
class CouplingSettings:
    """process_settings.jl:134-167."""

    coupling_on: bool = True
    dt: int = 10
    dd: int = 1
    two_way_coupling_on: bool = False
    # Eulerian (grid-cell) OA forcing instead of sub-floe quadrature points
    # (the working version of the reference's dormant eulerian_OA_code.jl);
    # one-way only - two-way deposition is a point-path feature
    eulerian: bool = False

    def __post_init__(self):
        if self.coupling_on and self.dt < 0:
            warnings.warn("coupling dt must be positive; resetting to 10")
            object.__setattr__(self, "dt", 10)
        if self.dd < 0:
            warnings.warn("coupling dd must be non-negative; resetting to 1")
            object.__setattr__(self, "dd", 1)
        if self.eulerian and self.two_way_coupling_on:
            # eulerian mode is one-way only (the reference's
            # eulerian_OA_code.jl never wired two-way either); say so rather
            # than skip two-way silently.
            warnings.warn(
                "eulerian coupling is one-way only; disabling "
                "two_way_coupling_on"
            )
            object.__setattr__(self, "two_way_coupling_on", False)


@dataclasses.dataclass(frozen=True)
class CollisionSettings:
    """process_settings.jl:184-229."""

    collisions_on: bool = True
    floe_floe_max_overlap: float = 0.55
    floe_domain_max_overlap: float = 0.75

    def __post_init__(self):
        if not (0 <= self.floe_floe_max_overlap <= 1):
            warnings.warn("floe_floe_max_overlap out of [0,1]; clamping")
            object.__setattr__(
                self,
                "floe_floe_max_overlap",
                min(max(self.floe_floe_max_overlap, 0.0), 1.0),
            )
        if not (0 <= self.floe_domain_max_overlap <= 1):
            warnings.warn("floe_domain_max_overlap out of [0,1]; clamping")
            object.__setattr__(
                self,
                "floe_domain_max_overlap",
                min(max(self.floe_domain_max_overlap, 0.0), 1.0),
            )


@dataclasses.dataclass(frozen=True)
class NoFracture:
    pass


@dataclasses.dataclass(frozen=True)
class HiblerYieldCurve:
    """Elliptical yield curve (fractures.jl:54-94). The polygon itself is
    computed from the floe field's mean height at setup / update time."""

    pstar: float = 2.25e5
    c: float = 20.0


@dataclasses.dataclass(frozen=True)
class MohrsCone:
    """Mohr's cone yield criterion (fractures.jl:104-214), defined directly
    by its vertices in principal-stress space."""

    q: float = 5.2
    sigma_c: float = 2.5e5
    sigma_11: float = -3.375e4


@dataclasses.dataclass(frozen=True)
class FractureSettings:
    """process_settings.jl:254-303."""

    fractures_on: bool = False
    criteria: object = NoFracture()
    dt: int = 0
    deform_on: bool = False
    npieces: int = 3

    def __post_init__(self):
        if self.fractures_on:
            if self.dt <= 0:
                warnings.warn("fracture dt must be positive; turning fractures off")
                object.__setattr__(self, "fractures_on", False)
            if isinstance(self.criteria, NoFracture):
                warnings.warn("cannot fracture with NoFracture; turning off")
                object.__setattr__(self, "fractures_on", False)
            if self.npieces <= 1:
                warnings.warn("fracture npieces must be > 1; turning fractures off")
                object.__setattr__(self, "fractures_on", False)


@dataclasses.dataclass(frozen=True)
class SimplificationSettings:
    """process_settings.jl:314-349."""

    smooth_vertices_on: bool = True
    max_vertices: int = 30
    tol: float = 100.0
    dt_smooth: int = 20


@dataclasses.dataclass(frozen=True)
class RidgeRaftSettings:
    """process_settings.jl:386-396."""

    ridge_raft_on: bool = False
    dt: int = 0
    ridge_probability: float = 0.95
    raft_probability: float = 0.95
    min_overlap_frac: float = 0.01
    min_ridge_height: float = 0.2
    max_floe_ridge_height: float = 5.0
    max_domain_ridge_height: float = 1.25
    max_floe_raft_height: float = 0.25
    max_domain_raft_height: float = 0.25
    domain_gain_probability: float = 1.0


@dataclasses.dataclass(frozen=True)
class WeldSettings:
    """process_settings.jl:527-533. Multi-scale schedule: at timesteps that
    are multiples of dts[i], floes are binned into an Nxs[i] x Nys[i]
    super-grid and probabilistically welded within bins."""

    weld_on: bool = False
    dts: Tuple[int, ...] = ()
    nxs: Tuple[int, ...] = ()
    nys: Tuple[int, ...] = ()
    min_weld_area: float = 1e6
    max_weld_area: float = 2e9
    welding_coeff: float = 150.0

    def __post_init__(self):
        if self.weld_on and (
            len(self.dts) == 0
            or len(self.dts) != len(self.nxs)
            or len(self.dts) != len(self.nys)
            or any(d <= 0 for d in self.dts)
            or any(n < 1 for n in self.nxs)
            or any(n < 1 for n in self.nys)
        ):
            warnings.warn("invalid welding schedule; turning welding off")
            object.__setattr__(self, "weld_on", False)
        # sort schedules by dt descending, as the reference does
        if len(self.dts) > 0:
            order = sorted(range(len(self.dts)), key=lambda i: -self.dts[i])
            object.__setattr__(self, "dts", tuple(self.dts[i] for i in order))
            object.__setattr__(self, "nxs", tuple(self.nxs[i] for i in order))
            object.__setattr__(self, "nys", tuple(self.nys[i] for i in order))
