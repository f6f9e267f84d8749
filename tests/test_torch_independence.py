"""The port stands on its own: it imports nothing of JAX or of the JAX
package, and it builds on the card unless the caller names the CPU.

* In a fresh interpreter, importing ``subzero_tpu_torch`` with every module
  it holds, and ``chip_smoke``, leaves neither ``jax`` nor ``subzero_tpu`` in
  ``sys.modules``.
* ``subzero_tpu_torch.constants.Constants`` is the port's own class with the
  JAX package's fields and defaults (the settings classes are held the same
  way in tests/test_torch_settings.py).
* Every constructor, and ``convert.from_jax_state``, called without ``device`` on
  a machine without a CUDA device raises; none returns CPU tensors.  With
  ``device="cpu"`` they build on the CPU.  (The constructors that came with the
  host life cycle are held the same way in tests/test_torch_entry_points.py.)
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import subzero_tpu.constants as jconst
import subzero_tpu_torch.constants as tconst
from subzero_tpu.core import make_atmos as jax_make_atmos
from subzero_tpu.core import make_domain as jax_make_domain
from subzero_tpu.core import make_ocean as jax_make_ocean
from subzero_tpu.core.floes import build_floes as jax_build_floes
from subzero_tpu_torch import convert, core
from subzero_tpu_torch.device import resolve_device

from torch_port_helpers import REPO, assert_same_dataclass

GRID = core.make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
SQUARE = np.array([[1e4, 1e4], [1e4, 3e4], [3e4, 3e4], [3e4, 1e4]])


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import subzero_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            subzero_tpu_torch.__path__, "subzero_tpu_torch.")]
        assert len(names) >= 45, names
        for new in ("native", "io.logger", "physics.lifecycle_host", "io.writers",
                    "tools.conservation", "tools.scenarios", "tools.compare",
                    "tools.fixtures", "tools.mat_convert", "tools.analyze_floe",
                    "tools.plotting", "examples.common", "examples.uniform_flow",
                    "examples.shear_flow", "examples.simple_strait",
                    "examples.converge_diverge_flow", "examples.forcing_contained_floes",
                    "examples.moving_bounds", "examples.many_floes",
                    "examples.restart_sim", "parallel", "parallel.decomp",
                    "parallel.multihost", "examples.distributed_shear_flow",
                    "bench", "tools.f32_drift_table", "tools.e2e_shear_flow",
                    "tools.lifecycle_walltime", "tools.probe_overflow_source",
                    "tools.measure_scaling", "tools.lifecycle_overhead"):
            assert "subzero_tpu_torch." + new in names, new
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        foreign = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "subzero_tpu"))
        assert not foreign, foreign
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_constants_have_the_jax_package_fields_and_defaults():
    assert tconst.Constants is not jconst.Constants
    assert_same_dataclass(tconst.Constants, jconst.Constants)
    assert tconst.Constants(E=2e7).replace(mu=0.3) == tconst.Constants(E=2e7, mu=0.3)


def _domain():
    return core.make_domain(GRID, *([core.BoundaryKind.PERIODIC] * 4),
                            dtype=torch.float64, device="cpu")


def _jax_state():
    import jax.numpy as jnp

    kw = dict(dtype=jnp.float64)
    from subzero_tpu.core import BoundaryKind, make_grid

    grid = make_grid(0.0, 1e5, 0.0, 1e5, Nx=10, Ny=10)
    domain = jax_make_domain(grid, *([BoundaryKind.PERIODIC] * 4), **kw)
    floes = jax_build_floes([SQUARE], 0.25, 0.0, N=2, **kw)
    return floes, jax_make_ocean(grid, **kw), jax_make_atmos(grid, **kw), domain, grid


CONSTRUCTORS = {
    "make_ocean": lambda **kw: core.make_ocean(GRID, dtype=torch.float64, **kw),
    "make_atmos": lambda **kw: core.make_atmos(GRID, dtype=torch.float64, **kw),
    "make_domain": lambda **kw: core.make_domain(
        GRID, *([core.BoundaryKind.COLLISION] * 4), dtype=torch.float64, **kw),
    "empty_topography": lambda **kw: core.empty_topography(dtype=torch.float64, **kw),
    "empty_floes": lambda **kw: core.empty_floes(4, 8, 16, dtype=torch.float64, **kw),
    "build_floes": lambda **kw: core.build_floes(
        [SQUARE], 0.25, 0.0, N=2, dtype=torch.float64, **kw),
    "initialize_floe_field": lambda **kw: core.initialize_floe_field(
        4, [0.5], _domain(), 0.25, 0.0, rng=np.random.default_rng(0),
        dtype=torch.float64, **kw),
    "initialize_floe_field_coords": lambda **kw: core.initialize_floe_field_coords(
        [SQUARE], _domain(), 0.25, 0.0, dtype=torch.float64, **kw),
    "from_jax_state": lambda **kw: convert.from_jax_state(
        *_jax_state(), dtype=torch.float64, **kw),
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif hasattr(x, "__dict__"):
        for y in vars(x).values():
            yield from _tensors(y)


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_without_device_wants_the_card(name):
    """No ``device``: the card.  Where there is none the constructor raises and
    hands back nothing; it never falls back to CPU tensors."""
    if torch.cuda.is_available():
        ts = list(_tensors(CONSTRUCTORS[name]()))
        assert ts and all(t.is_cuda for t in ts)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CONSTRUCTORS[name]()
    ts = list(_tensors(CONSTRUCTORS[name](device="cpu")))
    assert ts and all(t.device.type == "cpu" for t in ts)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    else:
        assert resolve_device(None).type == "cuda"
