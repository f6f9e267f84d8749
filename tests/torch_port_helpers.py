"""Shared inputs and adapters for the PyTorch-port tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: the JAX
reference runs on the CPU (x64, as tests/conftest.py configures it), the
port on CPU tensors, which take its plain PyTorch versions.
"""

import ctypes
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on the same cores: one intra-op thread
# per worker keeps torch's thread pool from oversubscribing them (the port
# tests' tensors are small, so they lose nothing by it)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "subzero_tpu_torch" / "csrc"

# f32 tolerances of tests/test_pallas_clip.py (kernel vs plain narrow phase)
F32_TOL = {
    "contain": dict(rtol=1e-5, atol=1e-6),
    "area": dict(rtol=1e-4, atol=1e-6),
    "geometry": dict(rtol=1e-4, atol=1e-5),
}


def star_ring(rng, nv, cx, cy, r0):
    th = np.sort(rng.random(nv)) * 2 * np.pi
    r = r0 * (0.5 + rng.random(nv))
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)


def build_batch(B=256, seed=0, V=16, nmax=16, dtype=np.float32):
    """tests/test_pallas_clip.py:build_batch generalized to ring width V and
    up to nmax vertices (V = nmax = 16 gives the same batch): disjoint,
    two-crossing, multi-crossing and containment pairs in turn."""
    rng = np.random.default_rng(seed)
    pv = np.zeros((B, V, 2), dtype)
    qv = np.zeros((B, V, 2), dtype)
    pn = np.zeros((B,), np.int32)
    qn = np.zeros((B,), np.int32)
    for k in range(B):
        nv = int(rng.integers(3, nmax + 1))
        ring = star_ring(rng, nv, 0.0, 0.0, 1.0)
        pv[k, :nv] = ring
        pv[k, nv:] = ring[-1]
        pn[k] = nv
        nw = int(rng.integers(3, nmax + 1))
        mode = k % 4
        if mode == 0:      # likely overlapping
            dx, dy, s = rng.uniform(-1, 1, 2).tolist() + [1.0]
        elif mode == 1:    # disjoint
            dx, dy, s = 5.0 + rng.random(), 5.0, 1.0
        elif mode == 2:    # Q tiny, likely contained
            dx, dy, s = 0.0, 0.0, 0.15
        else:              # P contained in big Q
            dx, dy, s = 0.0, 0.0, 8.0
        ring = star_ring(rng, nw, dx, dy, s)
        qv[k, :nw] = ring
        qv[k, nw:] = ring[-1]
        qn[k] = nw
    pert = (1e-6 * (1 + rng.random(B))).astype(dtype)
    return pv, pn, qv, qn, pert


def tt(*arrays):
    """numpy -> CPU torch tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_two_cross_close(got, ref, f64, what=""):
    """Elementwise agreement of two TwoCrossResults (either package):
    counts and flags exact, values at the f64 or f32 tolerance; the region
    geometry is compared where the pair is ``ok``."""
    g = {k: to_np(getattr(got, k)) for k in got._fields}
    r = {k: to_np(getattr(ref, k)) for k in ref._fields}
    np.testing.assert_array_equal(g["cnt"], r["cnt"], err_msg=what + "cnt")
    np.testing.assert_array_equal(g["ok"], r["ok"], err_msg=what + "ok")
    ok = r["ok"].astype(bool)
    tol = {k: dict(rtol=1e-9, atol=1e-12) for k in F32_TOL} if f64 else F32_TOL
    np.testing.assert_allclose(g["contain"], r["contain"], **tol["contain"],
                               err_msg=what + "contain")
    np.testing.assert_allclose(g["area"], r["area"], **tol["area"],
                               err_msg=what + "area")
    for f in ("centroid", "chord_a", "chord_b", "p_norm"):
        np.testing.assert_allclose(g[f][ok], r[f][ok], **tol["geometry"],
                                   err_msg=what + f)


# ---- a field of rings wider than 32 vertices (tests/test_torch_wide_rings.py,
# and on the card tests/test_torch_cuda.py) ---------------------------------

WIDE_V = 40          # ring width of the pool and the topography
WIDE_CLIP_CAP = 48   # crossings a slow row keeps: the combs' rows cross 40 times
WIDE_PAIR_CAP = 64


def comb(x0, y0, k, tooth, gap, base, height):
    """A CCW comb of k teeth (width ``tooth``, ``gap`` apart, ``height``
    above a base of height ``base``) from (x0, y0): 4k vertices."""
    L = k * tooth + (k - 1) * gap
    pts = [(x0, y0), (x0 + L, y0)]
    for m in range(k - 1, -1, -1):
        xl = x0 + m * (tooth + gap)
        pts += [(xl + tooth, y0 + base + height), (xl, y0 + base + height)]
        if m > 0:
            pts += [(xl, y0 + base), (xl - gap, y0 + base)]
    return [list(p) for p in pts]


def trapezoid(x0, x1, y0, y1, h0, h1):
    """Bottom edge (x0, y0) -> (x1, y1), thickness h0 at x0 and h1 at x1.
    Across a comb's tooth it gives a region whose two P-chain segments
    differ in length, so the region's normal does not cancel to roundoff
    (as a bar of constant thickness across a tooth's parallel edges would:
    its force direction would be noise in either package)."""
    return [[x0, y0], [x1, y1], [x1, y1 + h1], [x0, y0 + h0]]


def wide_field_coords():
    """(floe rings, topography rings) of the wide field on the 2e5 m box
    centred on 0: a comb of 10 teeth (40 vertices) with a bar floe across
    its teeth (40 crossings, 10 regions), a bar floe across the teeth of a
    40-vertex topography comb, and a small rectangle over the first bar's
    end (a clean two-crossing contact)."""
    floes = [comb(-6e4, 1e4, 10, 8e2, 3e3, 3e3, 2e4),
             trapezoid(-6.2e4, -1.8e4, 1.9e4, 1.8e4, 2e3, 6e3),
             trapezoid(0.8e4, 5.2e4, -7.9e4, -8.0e4, 2e3, 6e3),
             [[-2.0e4, 2.1e4], [-1.5e4, 2.1e4], [-1.5e4, 2.6e4], [-2.0e4, 2.6e4]]]
    return floes, [comb(1e4, -9e4, 10, 8e2, 3e3, 3e3, 2e4)]


# velocities of the wide field's pool of 6 (four floes, two empty slots)
WIDE_U = [0.1, -0.1, 0.0, 0.2, 0.0, 0.0]
WIDE_V_VEL = [0.0, 0.05, 0.1, -0.1, 0.0, 0.0]


def lattice_pairs(K=64, seed=3, dtype=torch.float64, perturb=(-13.5, -12.5)):
    """Polygons with vertices on a coarse lattice against translated copies
    of themselves and against each other (shared edges, vertices on edges),
    as a slow batch (pools of width 16, every row slow: ssel 0..K-1), with a
    perturbation of 10^``perturb`` of each row's coordinates, where the
    crossing parity of some rows comes out odd and the retry resolves some.
    Returns (the 8 pool and pair-list tensors, ssel, n_slow) on the CPU."""
    rng = np.random.default_rng(seed)
    V = 16
    pv, qv = np.zeros((K, V, 2)), np.zeros((K, V, 2))
    pn, qn = np.zeros(K, np.int32), np.zeros(K, np.int32)

    def lattice_poly():
        nv = int(rng.integers(3, 9))
        th = np.sort(rng.choice(np.arange(16), nv, replace=False)) * 2 * np.pi / 16
        r = rng.integers(2, 5, nv)
        return np.round(np.stack([r * np.cos(th), r * np.sin(th)], 1))

    for k in range(K):
        P = lattice_poly()
        Q = P + rng.integers(-2, 3, 2) if k % 2 else lattice_poly()
        for v, n, ring in ((pv, pn, P), (qv, qn, Q)):
            v[k, :len(ring)] = ring
            v[k, len(ring):] = ring[-1]
            n[k] = len(ring)
    pert = np.abs(pv).max(axis=(1, 2)) * 10.0 ** rng.uniform(*perturb, K)
    idx = torch.arange(K)
    args = (torch.tensor(pv, dtype=dtype), torch.tensor(pn), torch.tensor(qv, dtype=dtype),
            torch.tensor(qn), idx, idx.clone(), torch.zeros((K, 2), dtype=dtype),
            torch.tensor(pert, dtype=dtype))
    return args, idx.clone(), torch.tensor(K)


def build_pair_list(B=256, seed=0, V=16, nmax=16, dtype=np.float32):
    """Ring pools and a candidate pair list as the narrow phase takes them
    (clip.TWO_CROSS_ARGS, numpy): the rings of ``build_batch`` as a P pool
    and a Q pool of B rings each, and 3B/2 rows.  Rows 0..B-1 pair P ring k
    with Q ring k unshifted (every regime of ``build_batch``); the rest pair
    random rings, so rings are shared between rows, with Q shifted by up to
    a ring radius.  Every 7th row is not valid.  The rows are shuffled, so
    nothing is row-structured."""
    pv, pn, qv, qn, _ = build_batch(B=B, seed=seed, V=V, nmax=nmax, dtype=dtype)
    rng = np.random.default_rng(seed + 1000)
    E = B // 2
    qi = np.concatenate([np.arange(B), rng.integers(0, B, E)]).astype(np.int64)
    qj = np.concatenate([np.arange(B), rng.integers(0, B, E)]).astype(np.int64)
    shift = np.concatenate([np.zeros((B, 2)), rng.uniform(-1, 1, (E, 2))])
    order = rng.permutation(B + E)
    qi, qj, shift = qi[order], qj[order], shift[order]
    valid = (np.arange(B + E) % 7) != 3
    pert = 1e-6 * (1 + rng.random(B + E))
    return (pv, pn, qv, qn, qi, qj, shift.astype(dtype), pert.astype(dtype), valid)


def rings_of_pair_list(args):
    """The materialised (pv, pn, qv, qn, pert) of a ``build_pair_list``
    result, in numpy: what the JAX package's narrow phase takes."""
    p_verts, p_n, q_verts, q_n, qi, qj, shift, pert, _ = args
    return (p_verts[qi], p_n[qi], q_verts[qj] + shift[:, None, :], q_n[qj], pert)


def zero_invalid_rows(res, valid):
    """A TwoCrossResult (either package) as numpy fields with the rows that
    are not valid zeroed, as the port's narrow phase returns them."""
    from subzero_tpu_torch.geometry.clip import TwoCrossResult

    def z(x):
        x = np.array(to_np(x))
        x[~valid] = 0
        return x

    return TwoCrossResult(*(z(getattr(res, f)) for f in TwoCrossResult._fields))


def build_host_shim(out_dir):
    """g++ build of csrc/two_cross_host.cpp (the kernel's per-term arithmetic
    from two_cross.cuh, combined serially) into a ctypes library; skips
    without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    so = Path(out_dir) / "libtwo_cross_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(so), str(CSRC / "two_cross_host.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, real in (("sz_two_cross_host_f32", ctypes.c_float),
                       ("sz_two_cross_host_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        # the CUDA library's arguments without the stream
        fn.argtypes = [p, p, i, i, p, p, i, i, p, p, p, p, p, i, real, p, p, p]
        fn.restype = None
    return lib


def run_host_shim_pairs(lib, p_verts, p_n, q_verts, q_n, qi, qj, shift, pert,
                        valid):
    """The shim on CPU tensors (clip.TWO_CROSS_ARGS) -> TwoCrossResult of the
    port, its fields views of one packed buffer as the CUDA wrapper's are."""
    from subzero_tpu_torch.geometry.clip import sliver_tol
    from subzero_tpu_torch.geometry.two_cross import alloc_output, result_of

    PC, dtype = qi.shape[0], p_verts.dtype
    buf = alloc_output(PC, dtype, "cpu")
    out = result_of(buf, PC, dtype)
    fn = lib.sz_two_cross_host_f64 if dtype == torch.float64 else lib.sz_two_cross_host_f32
    a = [x.contiguous() for x in (p_verts, p_n.to(torch.int32), q_verts,
                                  q_n.to(torch.int32), qi, qj, shift, pert, valid)]
    fn(a[0].data_ptr(), a[1].data_ptr(), a[0].shape[0], a[0].shape[1],
       a[2].data_ptr(), a[3].data_ptr(), a[2].shape[0], a[2].shape[1],
       *(x.data_ptr() for x in a[4:]), PC, sliver_tol(dtype),
       out.contain.data_ptr(), out.cnt.data_ptr(), out.ok.data_ptr())
    return out


def identity_pair_list(pv, pn, qv, qn, pert):
    """A materialised ring batch as pools and the pair list that pairs row k
    with row k, unshifted and valid (clip.TWO_CROSS_ARGS)."""
    B = pv.shape[0]
    k = torch.arange(B, dtype=torch.int64, device=pv.device)
    return (pv, pn, qv, qn, k, k, torch.zeros((B, 2), dtype=pv.dtype, device=pv.device),
            pert, torch.ones((B,), dtype=torch.bool, device=pv.device))


def run_host_shim(lib, pv, pn, qv, qn, pert):
    """The shim on a materialised ring batch."""
    return run_host_shim_pairs(lib, *identity_pair_list(pv, pn, qv, qn, pert))


def build_regions_shim(out_dir):
    """g++ build of csrc/intersect_regions_host.cpp (the slow clip's per-row
    arithmetic from intersect_regions.cuh, combined serially in the
    kernel's order) into a ctypes library; skips without g++."""
    from subzero_tpu_torch.geometry.regions import build_host_shim

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build_host_shim(out_dir)


def card_sum(terms):
    """``torch.sum(terms, dim=1)`` of [N, V, C] as CUDA groups it (a
    reduction over a dimension that is not the innermost, V <= 128): edge k
    into accumulator k % 4 of four, each from 0, then ((a0 + a1) + a2) +
    a3."""
    acc = [torch.zeros_like(terms[:, 0]) for _ in range(4)]
    for k in range(terms.shape[1]):
        acc[k % 4] = acc[k % 4] + terms[:, k]
    return ((acc[0] + acc[1]) + acc[2]) + acc[3]


def coupling_cell_inputs(sim, domain=None):
    """The arguments that the coupling hands ``coupling._cell_areas``
    (rings, rects and mask by axis) on the state of ``sim``, with
    ``domain``'s boundaries if given."""
    from subzero_tpu_torch.physics import coupling as tcpl

    m = sim.model
    return list(tcpl.window_inputs(m.floes, m.grid, domain or m.domain, sim.cell_cap))


def cuda_or_skip():
    """The first CUDA device, or skip: the kernel runs only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel); run on the card")
    return torch.device("cuda", 0)


def assert_fields_close(got, ref, rtol=1e-9, atol_rel=1e-9, what="", atol=None):
    """Field-by-field agreement of a port NamedTuple with the reference's:
    integer and boolean fields exact, floating fields to ``rtol`` with an
    absolute floor of ``atol_rel`` times the field's largest magnitude (sums
    with cancellation land near zero).  ``atol`` maps a field name to its
    own absolute floor (a scalar or an array of the field's shape)."""
    for f in ref._fields:
        g = to_np(getattr(got, f))
        r = np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f"{what}{f}: shape {g.shape} != {r.shape}"
        if np.issubdtype(r.dtype, np.floating):
            scale = float(np.max(np.abs(r))) if r.size else 0.0
            floor = atol_rel * scale + 1e-300
            if atol is not None and f in atol:
                floor = np.maximum(floor, atol[f])
            err = np.abs(g - r)
            bad = ~(err <= floor + rtol * np.abs(r))
            assert not bad.any(), (
                f"{what}{f}: {int(bad.sum())}/{r.size} beyond rtol {rtol} with "
                f"the absolute floor; worst abs err {err[bad].max():.3e} where "
                f"the floor is {np.broadcast_to(floor, r.shape)[bad].min():.3e}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=what + f)


def port_settings(obj):
    """A settings or constants dataclass of the JAX package -> the port's own
    class of the same name, built from the same field values (nested
    dataclasses too).  The port shares no class with the JAX package, and its
    ``isinstance`` checks want its own."""
    import subzero_tpu_torch.constants as tconst
    import subzero_tpu_torch.settings as tset

    if isinstance(obj, tuple):
        return tuple(port_settings(x) for x in obj)
    if not dataclasses.is_dataclass(obj):
        return obj
    name = type(obj).__name__
    cls = getattr(tset, name, None) or getattr(tconst, name)
    return cls(**{f.name: port_settings(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init})


def assert_same_dataclass(ours, theirs):
    """Two dataclass types have the same fields in the same order, with the
    same declared types and the same defaults (a default that is itself a
    settings object is compared through ``port_settings``)."""
    fo, ft = dataclasses.fields(ours), dataclasses.fields(theirs)
    assert [f.name for f in fo] == [f.name for f in ft], ours.__name__
    for a, b in zip(fo, ft):
        what = f"{ours.__name__}.{a.name}"
        assert str(a.type) == str(b.type), what
        assert (a.default is dataclasses.MISSING) == (b.default is dataclasses.MISSING), what
        if a.default is not dataclasses.MISSING:
            assert a.default == port_settings(b.default), what
        assert (a.default_factory is dataclasses.MISSING) == (
            b.default_factory is dataclasses.MISSING), what
        if a.default_factory is not dataclasses.MISSING:
            assert a.default_factory() == port_settings(b.default_factory()), what
    assert ours.__dataclass_params__.frozen == theirs.__dataclass_params__.frozen


def port_state(floes, domain, ocean=None, atmos=None, grid=None, dtype=torch.float64):
    """Reference state -> the port's (CPU) via subzero_tpu_torch.convert."""
    from subzero_tpu.core import make_atmos, make_grid, make_ocean
    from subzero_tpu_torch.convert import from_jax_state

    if grid is None:
        grid = make_grid(0.0, 1.0, 0.0, 1.0, Nx=1, Ny=1)
    if ocean is None:
        ocean = make_ocean(grid)
    if atmos is None:
        atmos = make_atmos(grid)
    return from_jax_state(floes, ocean, atmos, domain, grid, "cpu", dtype=dtype)


def assert_ocean_close(got, ref, rtol=1e-9, atol_rel=1e-9, what="ocean."):
    """OceanState agreement.  A cell whose ice area is roundoff (a floe edge
    grazing it: below 1e-8 of the cell in either package) gets the floe's
    stress divided by that roundoff area, so its ``tau`` is noise in both;
    there the stress is compared weighted by the ice fraction (its share of
    the force), everywhere else directly."""
    for f in ref._fields:
        g = to_np(getattr(got, f))
        r = np.asarray(getattr(ref, f))
        if f in ("tau_x", "tau_y"):
            frac = np.maximum(np.asarray(ref.si_frac), to_np(got.si_frac))
            real = np.minimum(np.asarray(ref.si_frac), to_np(got.si_frac)) > 1e-8
            real |= frac == 0
            scale = float(np.max(np.abs(r)))
            np.testing.assert_allclose(g[real], r[real], rtol=rtol,
                                       atol=atol_rel * scale, err_msg=what + f)
            np.testing.assert_allclose(g[~real] * frac[~real], r[~real] * frac[~real],
                                       rtol=0, atol=atol_rel * scale,
                                       err_msg=what + f + " (roundoff-ice cells)")
        else:
            scale = float(np.max(np.abs(r))) if r.size else 0.0
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol_rel * scale + 1e-300,
                                       err_msg=what + f)


# ---------------------------------------------------------------------------
# rank processes of the decomposition tests
# ---------------------------------------------------------------------------

def free_port():
    """A free TCP port on localhost for a process group's rendezvous."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Ranks:
    """Rank processes started together; ``wait`` returns when all have
    exited 0, and fails (killing the others) at the first that does not, or
    at the time limit: no rank's failure is caught."""

    def __init__(self, cmd, world, out_dir, env=None, timeout=600):
        self.out_dir, self.timeout, self.done = out_dir, timeout, False
        self.logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    cmd(r), stdout=log, stderr=subprocess.STDOUT,
                    env=(env or {}).get(r, rank_env())))

    def wait(self):
        deadline = time.monotonic() + self.timeout
        while not self.done:
            codes = [p.poll() for p in self.procs]
            if all(c == 0 for c in codes):
                self.done = True
                break
            if any(c not in (None, 0) for c in codes) or time.monotonic() > deadline:
                self.kill()
                tails = [open(f).read()[-3000:] for f in self.logs]
                pytest.fail(f"rank exit codes {codes}:\n" + "\n---\n".join(tails))
            time.sleep(0.2)
        return self

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def npz(self, name):
        self.wait()
        return np.load(os.path.join(self.out_dir, f"{name}.npz"))

    def rank_json(self, name, rank):
        self.wait()
        with open(os.path.join(self.out_dir, f"{name}.rank{rank}.json")) as f:
            return json.load(f)


def rank_env():
    """The environment of a rank process: the repo importable, one OpenMP
    thread (the ranks share the cores), JAX's platform pin dropped."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    return env
