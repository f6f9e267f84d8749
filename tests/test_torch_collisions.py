"""The port's timestep_collisions against the JAX reference.

Every field of CollisionResult (the whole floe pool, the instantaneous
stress and the overflow flag) is compared on the tests/test_collisions.py
shapes - floe-floe, walls, topography, open and periodic boundaries, brought
over by subzero_tpu_torch.convert.  f64, rtol 1e-9 (absolute floor 1e-9 of
each field's largest magnitude); the per-capacity counters of
``with_debug=True`` (which term of the overflow flag fired) exactly.  The slow path and the candidate-row
compaction are held to the reference in test_torch_collisions_slow_path.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from subzero_tpu.core.floes import build_floes
from subzero_tpu.physics import collisions as jcol
from subzero_tpu_torch.physics import collisions as tcol

from test_collisions import (
    CONSTS,
    CORNER_RECT,
    CSET,
    CSHAPE,
    DT,
    FSET,
    OPEN_DOMAIN,
    TOPO_DOMAIN,
    TRI,
)
from torch_port_helpers import assert_fields_close, port_settings, port_state

_jax_collide = jax.jit(
    jcol.timestep_collisions,
    static_argnames=("consts", "dt", "collision_settings", "pair_cap",
                     "clip_cap", "with_debug"),
)


def _floes(coords, us, vs, N):
    fl = build_floes(coords, 0.25, 0.0, FSET, np.random.default_rng(0),
                     N=N, P=32, dtype=jnp.float64)
    pad = [0.0] * (N - len(coords))
    return fl._replace(u=jnp.asarray(list(us) + pad, jnp.float64),
                       v=jnp.asarray(list(vs) + pad, jnp.float64))


def _compare(jfl, jdomain, pair_cap, clip_cap=16):
    ref, dbg = _jax_collide(jfl, jdomain, consts=CONSTS, dt=DT,
                            collision_settings=CSET, pair_cap=pair_cap,
                            clip_cap=clip_cap, with_debug=True)
    tfl, _, _, tdom, _ = port_state(jfl, jdomain)
    got, tdbg = tcol.timestep_collisions(tfl, tdom, port_settings(CONSTS), DT,
                                         port_settings(CSET), pair_cap, clip_cap,
                                         with_debug=True)
    assert_same_counters(tdbg, dbg)
    assert_fields_close(got.floes, ref.floes, what="floes.")
    np.testing.assert_allclose(
        got.stress_instant.numpy(), np.asarray(ref.stress_instant), rtol=1e-9,
        atol=1e-9 * float(np.max(np.abs(np.asarray(ref.stress_instant)))),
    )
    assert bool(got.overflow) == bool(ref.overflow)
    return ref, dbg


def assert_same_counters(got, ref):
    """The port's with_debug dict equals the JAX package's: the same keys,
    each a 0-d tensor on the pool's device, the same integer or flag."""
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.dim() == 0 and v.device.type == "cpu", k
        assert v.item() == np.asarray(ref[k]).item(), (k, v.item(), ref[k])


SHIFTED = [[x + 0.5e4, y] for x, y in CORNER_RECT]
MIDDLE = [[1.8e4, 2.7e4], [1.8e4, 2.8e4], [2.1e4, 2.8e4], [2.1e4, 2.7e4]]
BIG_SHIFT = [[x + 1.9999999e4, y] for x, y in CORNER_RECT]
OPEN_CASES = {
    "triangle_rect": ([TRI, CORNER_RECT], [0.1, 0.0], [0.0, -0.1]),
    "cshape_two_regions": ([CSHAPE, CORNER_RECT], [0.3, 0.0], [0.0, -0.1]),
    "large_overlap_fuses": ([CORNER_RECT, SHIFTED], [0.0, 0.0], [-0.1, -0.1]),
    "middle_rect_fuses": ([CORNER_RECT, MIDDLE], [0.0, 0.0], [-0.1, 0.0]),
    "tiny_overlap": ([CORNER_RECT, BIG_SHIFT], [0.0, 0.0], [-0.1, -0.1]),
    "three_floes": ([TRI, CORNER_RECT, CSHAPE], [0.1, 0.0, 0.3], [0.0, -0.1, 0.0]),
}


@pytest.mark.parametrize("case", list(OPEN_CASES))
def test_floe_floe_open_domain(case):
    coords, us, vs = OPEN_CASES[case]
    _compare(_floes(coords, us, vs, N=3), OPEN_DOMAIN, pair_cap=64)


SMALL = [[9.5e4, 0.0], [9e4, 0.5e4], [10e4, 2.5e4], [10.05e4, 2e4]]
CSHAPE_WALL = [
    [9.5e4, 7e4], [9.5e4, 9e4], [1.05e5, 9e4], [1.05e5, 8.5e4],
    [9.9e4, 8.5e4], [9.9e4, 8e4], [1.05e5, 8e4], [1.05e5, 7e4],
]
TOPO_CASES = {
    "east_collision_wall": ([SMALL], [0.5], [0.25]),
    "cshape_wall_two_regions": ([CSHAPE_WALL], [0.0], [-0.1]),
    "large_wall_overlap_removes": (
        [[[9e4, -7e4], [9e4, -5e4], [1.4e5, -5e4], [1.4e5, -7e4]]], [-0.4], [0.2]),
    "open_boundary_removes": (
        [[[-9.75e4, 7e4], [-9.75e4, 5e4], [-10.05e4, 5e4], [-10.05e4, 7e4]]],
        [0.0], [0.0]),
    "periodic_boundary_noop": (
        [[[5e4, 9.75e4], [5e4, 10.05e4], [7e4, 10.05e4], [7e4, 9.75e4]]],
        [0.0], [0.0]),
    "topography_overlap": (
        [[[-0.5e4, 0.0], [-0.5e4, 0.75e4], [0.5e4, 0.75e4], [0.5e4, 0.0]]],
        [0.0], [0.0]),
    "wall_and_topography": (
        [SMALL, [[0.5e4, 0.2e4], [0.5e4, 1.5e4], [1.8e4, 1.5e4]]],
        [0.5, 0.0], [0.25, 0.0]),
}


@pytest.mark.parametrize("case", list(TOPO_CASES))
def test_walls_topography_open_periodic(case):
    coords, us, vs = TOPO_CASES[case]
    _compare(_floes(coords, us, vs, N=2), TOPO_DOMAIN, pair_cap=64)
