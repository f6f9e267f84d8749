"""The coupling's cell clip (B6, ``csrc/cell_clip.cuh``) on the CPU.

The g++ shim of the header (``cell_clip.run_host_shim``: the kernel's floes
and window cells one after another) against the plain PyTorch version
(``coupling._clip_area_to_rects``, as ``coupling._cell_areas`` runs it) in
f32 and f64: to the bit against the plain version's own shoelace terms
(``coupling._clip_edge_terms``) summed as ``torch.sum`` groups them on CUDA
(``card_sum``, which the card's tests hold to ``torch.sum`` there), and, in
f64, within rounding of the plain version as the CPU sums it and of the JAX
package's ``_clip_area_to_rects``, rtol 1e-12.  PyTorch's CPU build groups
the sum over a ring's edges otherwise than its CUDA build (a cascade over
blocks of rows, which depends on the shapes), and the kernel follows the
card's grouping, so the plain version on the CPU and the shim part in the
last bits.  The shim's count of the cells it clipped equals the window
mask's.

Fields: the 300-floe shear field of ``bench.build_sim`` with the coupling's
own windows (periodic grid), the same floes on a grid with walls (the
window's rects clamped at the boundaries, cells off the grid dropped), rings
of up to 128 vertices (padded rings among them) against random rects and
masks, an all-false mask, and rings that lie on cell edges.  On the CPU the
step counts the same cells into the marks' ``window_cells``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.physics.coupling import _clip_area_to_rects as jax_clip_rects
from subzero_tpu_torch.bench import build_sim
from subzero_tpu_torch.core import BoundaryKind, make_domain
from subzero_tpu_torch.physics import cell_clip
from subzero_tpu_torch.physics import coupling as tcpl
from subzero_tpu_torch.simulation import run_scan

from torch_port_helpers import card_sum, coupling_cell_inputs

DTYPES = {"f32": torch.float32, "f64": torch.float64}
CASES = ["shear_periodic", "shear_walls", "wide_rings", "all_false", "on_cell_edges"]


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return cell_clip.build_host_shim(tmp_path_factory.mktemp("cell_clip_shim"))


def _rects(xmin, xmax, ymin, ymax, okx, oky):
    """The window's rects and mask by axis as the plain version's [N, A, B]."""
    N, A, B = okx.shape[0], okx.shape[1], oky.shape[1]
    return (xmin[:, :, None].expand(N, A, B), xmax[:, :, None].expand(N, A, B),
            ymin[:, None, :].expand(N, A, B), ymax[:, None, :].expand(N, A, B),
            okx[:, :, None] & oky[:, None, :])


def plain_in_the_cards_order(verts, nverts, xmin, xmax, ymin, ymax, okx, oky):
    """``coupling._cell_areas``' plain version with its sum grouped as on
    the card."""
    *rects, ok = _rects(xmin, xmax, ymin, ymax, okx, oky)
    terms = tcpl._clip_edge_terms(verts, nverts, *rects)
    area = (0.5 * card_sum(terms)).reshape(ok.shape)
    area = torch.where(ok, torch.abs(area), 0.0)
    return torch.where(ok & (area > 0), area, 0.0)


def _star_rings(rng, N, V, dtype):
    """N star-shaped CCW rings of 3 to V vertices, padded with zeros to V."""
    verts = np.zeros((N, V, 2))
    nverts = rng.integers(3, V + 1, N)
    nverts[:3] = (V, 3, 4)
    for n, k in enumerate(nverts):
        th = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(1.0, 3.0, k)
        verts[n, :k] = np.stack([r * np.cos(th), r * np.sin(th)], -1) + rng.uniform(-1, 1, 2)
    return (torch.tensor(verts, dtype=dtype),
            torch.tensor(nverts, dtype=torch.int32))


_SIMS = {}


def _sim(dtype):
    if dtype not in _SIMS:
        _SIMS[dtype] = build_sim(300, 1e5, 4e3, device="cpu", dtype=dtype)
    return _SIMS[dtype]


def case_inputs(case, dtype):
    if case in ("shear_periodic", "all_false"):
        args = coupling_cell_inputs(_sim(dtype))
        if case == "all_false":
            args[6] = torch.zeros_like(args[6])
        return args
    if case == "shear_walls":
        sim = _sim(dtype)
        walls = make_domain(sim.model.grid, *([BoundaryKind.COLLISION] * 4),
                            dtype=dtype, device="cpu")
        return coupling_cell_inputs(sim, walls)
    rng = np.random.default_rng(17)
    if case == "wide_rings":
        verts, nverts = _star_rings(rng, 40, 128, dtype)
        xs, ys = np.linspace(-4.0, 3.5, 6), np.linspace(-3.7, 4.1, 7)
        okx = torch.from_numpy(rng.random((40, 5)) < 0.8)
        oky = torch.from_numpy(rng.random((40, 6)) < 0.8)
    else:  # on_cell_edges: rings whose edges and corners lie on cell lines
        sq = [(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)]
        rings = [sq, [(-1.0, -1.0), (2.0, -1.0), (2.0, 0.5), (-1.0, 0.5)],
                 [(0.0, -1.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0)],
                 [(-1.0, 1.0), (1.0, -1.0), (1.0, 1.0)]]
        verts = torch.zeros((len(rings), 32, 2), dtype=dtype)
        for n, r in enumerate(rings):
            verts[n, :len(r)] = torch.tensor(r, dtype=dtype)
        nverts = torch.tensor([len(r) for r in rings], dtype=torch.int32)
        xs, ys = np.arange(-3.0, 4.0), np.arange(-3.0, 4.0)
        okx = torch.ones((len(rings), 6), dtype=torch.bool)
        oky = torch.ones((len(rings), 6), dtype=torch.bool)
    N = verts.shape[0]
    xmin = torch.tensor(xs[:-1], dtype=dtype).expand(N, -1).contiguous()
    xmax = torch.tensor(xs[1:], dtype=dtype).expand(N, -1).contiguous()
    ymin = torch.tensor(ys[:-1], dtype=dtype).expand(N, -1).contiguous()
    ymax = torch.tensor(ys[1:], dtype=dtype).expand(N, -1).contiguous()
    return [verts, nverts, xmin, xmax, ymin, ymax, okx, oky]


def bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_shim_equals_plain_in_the_cards_order(shim, case, dtype):
    args = case_inputs(case, DTYPES[dtype])
    count = torch.zeros((), dtype=torch.int64)
    got = cell_clip.run_host_shim(shim, *args, count=count)
    ref = plain_in_the_cards_order(*args)
    assert torch.equal(bits(got), bits(ref))
    ok = _rects(*args[2:])[-1]
    assert int(count) == int(ok.sum())
    if case == "all_false":
        assert not bool(got.any())
    else:
        assert bool((got > 0).any())
    if case == "shear_walls":
        periodic = case_inputs("shear_periodic", DTYPES[dtype])
        assert not torch.equal(args[2], periodic[2])  # rects clamped
        assert int(args[6].sum()) < int(periodic[6].sum())  # cells off the grid
    if case == "wide_rings":
        assert int(args[1].max()) == args[0].shape[1] and int(args[1].min()) < 8


@pytest.mark.parametrize("case", CASES)
def test_shim_within_rounding_of_plain_on_the_cpu_and_of_jax_f64(shim, case):
    args = case_inputs(case, torch.float64)
    got = cell_clip.run_host_shim(shim, *args).numpy()
    plain = tcpl._cell_areas_plain(*args).numpy()
    *rects, ok = _rects(*args[2:])
    ref = np.asarray(jax_clip_rects(*(jnp.asarray(x.numpy()) for x in (args[0], args[1],
                                                                         *rects, ok))))
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * scale)


def test_the_step_counts_the_window_cells_on_the_cpu():
    """A coupled step's ``window_cells`` (marks, ``run_stats["graph"]``) is
    the window mask's count on the state it starts from; an uncoupled step
    adds none."""
    sim = build_sim(300, 1e5, 4e3, device="cpu")
    *_, okx, oky = coupling_cell_inputs(sim)
    want = int((okx[:, :, None] & oky[:, None, :]).sum())
    run_scan(sim, 1, start_tstep=10)
    assert sim.run_stats["graph"]["window_cells"] == want > 0
    run_scan(sim, 1, start_tstep=11)
    assert sim.run_stats["graph"]["window_cells"] == 0
