"""The port's settings classes are its own copies of the JAX package's.

``subzero_tpu_torch.settings`` imports nothing of ``subzero_tpu``; each of its
dataclasses has the JAX package's fields, in order, with the same types and
defaults, and its validation and constructors behave the same on the same
arguments (compared field by field: the classes themselves are distinct, so
``==`` across the packages is always False).
"""

import dataclasses
import warnings

import pytest

import subzero_tpu.settings as jset
import subzero_tpu_torch.settings as tset
from subzero_tpu.core import make_grid

from torch_port_helpers import assert_same_dataclass, port_settings

# one case per class; the three fracture criteria are one case
CASES = {
    "MonteCarloPointsGenerator": ["MonteCarloPointsGenerator"],
    "SubGridPointsGenerator": ["SubGridPointsGenerator"],
    "DecayAreaScaledCalculator": ["DecayAreaScaledCalculator"],
    "FloeSettings": ["FloeSettings"],
    "CouplingSettings": ["CouplingSettings"],
    "CollisionSettings": ["CollisionSettings"],
    "fracture_criteria": ["NoFracture", "HiblerYieldCurve", "MohrsCone"],
    "FractureSettings": ["FractureSettings"],
    "SimplificationSettings": ["SimplificationSettings"],
    "RidgeRaftSettings": ["RidgeRaftSettings"],
    "WeldSettings": ["WeldSettings"],
}


def test_every_settings_class_is_covered():
    def classes(mod):
        return {n for n, c in vars(mod).items()
                if dataclasses.is_dataclass(c) and c.__module__ == mod.__name__}

    assert classes(tset) == classes(jset)
    covered = {n for names in CASES.values() for n in names}
    assert covered | {"DamageStressCalculator"} == classes(jset)


@pytest.mark.parametrize("case", list(CASES))
def test_settings_class_has_the_jax_package_fields_and_defaults(case):
    for name in CASES[case]:
        ours, theirs = getattr(tset, name), getattr(jset, name)
        assert ours is not theirs and ours.__module__ == "subzero_tpu_torch.settings"
        assert_same_dataclass(ours, theirs)


def _fields(obj):
    """A settings object as nested (class name, {field: value}) data."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


def test_validation_and_constructors_behave_alike():
    grid = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    assert _fields(tset.SubGridPointsGenerator.from_grid(grid, 2)) == _fields(
        jset.SubGridPointsGenerator.from_grid(grid, 2))
    build = [
        ("CouplingSettings", dict(dt=-5, dd=-1)),
        ("CouplingSettings", dict(eulerian=True, two_way_coupling_on=True)),
        ("WeldSettings", dict(weld_on=True, dts=(10, 40, 20), nxs=(1, 2, 3), nys=(3, 2, 1))),
        ("WeldSettings", dict(weld_on=True, dts=(10, -20), nxs=(1, 0), nys=(1, 1))),
        ("FloeSettings", dict(min_floe_area=-1.0, max_floe_height=-2.0)),
        ("CollisionSettings", dict(floe_floe_max_overlap=1.5, floe_domain_max_overlap=-0.5)),
        ("FractureSettings", dict(fractures_on=True, dt=0)),
    ]
    for name, kw in build:
        with warnings.catch_warnings(record=True) as ours_w:
            warnings.simplefilter("always")
            ours = getattr(tset, name)(**kw)
        with warnings.catch_warnings(record=True) as theirs_w:
            warnings.simplefilter("always")
            theirs = getattr(jset, name)(**kw)
        assert _fields(ours) == _fields(theirs), name
        assert [str(w.message) for w in ours_w] == [str(w.message) for w in theirs_w]
        assert port_settings(theirs) == ours
    with pytest.raises(NotImplementedError):
        tset.DamageStressCalculator()
