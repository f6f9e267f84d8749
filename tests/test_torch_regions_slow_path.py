"""The step's slow path through the slow clip's kernel arithmetic (B2), on
the CPU: ``collisions._slow_path`` with ``intersect_regions_dispatch``
replaced by the g++ shim of ``csrc/intersect_regions.cuh`` (the kernel's
interface and its order of combination, serial) against the slow path as it
ran without the kernel: every one of the ``slow_cap`` rows clipped by
``clip.intersect_regions``, the 16-row retry always run, both masked.

On the packed 40-floe fields of tests/test_torch_collisions_slow_path.py
(f64): with n_slow = 0 (no slow pair), 1 and 7 (the slow selection of
``beyond_first_tier`` cut to its first rows, as a tier would hold them),
``slow_cap`` and above ``slow_cap`` (``beyond_slow_cap``'s), and with the
retry taking 16 of 26 odd rows (``parity_retry`` at CAP 2).  Rows before
n_slow equal the masked path's (bitwise where the sums' orders agree, else
1e-12 relative, floor 1e-12 of the field's largest magnitude: see
test_torch_regions.py); rows past it are zeros; the retry rewrites the
first 16 odd rows at most and no other.  ``timestep_collisions`` through the shim ends where the
plain version's does, to the same tolerance.  The kernel's wrapper refuses
a CAP or a ring wider than it takes before it launches.
"""

import numpy as np
import pytest
import torch

from subzero_tpu_torch.geometry import regions
from subzero_tpu_torch.geometry.clip import ClipRegions, first_true, intersect_regions
from subzero_tpu_torch.physics import collisions as tcol

from test_collisions import CONSTS, CSET, DT
from test_torch_collisions_slow_path import PACKED_CASES, PERIODIC_DOMAIN, _packed_field
from test_torch_regions import assert_against_plain
from torch_port_helpers import build_regions_shim, port_settings, port_state

PAIR_CAP = 320
SLOW_CAP = max(PAIR_CAP // 128, 32)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return build_regions_shim(tmp_path_factory.mktemp("regions_shim"))


def _field(case):
    r0, spike, clip_cap, _ = PACKED_CASES[case]
    fl, _, _, dom, _ = port_state(_packed_field(r0, spike), PERIODIC_DOMAIN)
    nb = tcol.narrow_phase_batch(fl, dom, PAIR_CAP)
    tc = tcol.two_cross_dispatch(*nb.two_cross_args())
    return fl, dom, nb, tc, clip_cap


def masked_path(floes, nb, tc, clip_cap, retry):
    """The slow path without the kernel: all ``slow_cap`` rows through
    ``intersect_regions`` and the retry on its 16 rows, every time, the
    rows that are not slow (or not odd) masked.  Returns (regions, valid,
    parity_bad)."""
    pairs, q_verts, q_n, perturb0 = nb.pairs, nb.q_verts, nb.q_n, nb.perturb
    PC = pairs.qi.shape[0]
    slow_mask = (tc.cnt > 0) & ~tc.ok
    ssel = first_true(slow_mask, SLOW_CAP, PC)
    svalid = ssel < PC
    ssafe = torch.clamp(ssel, max=PC - 1)
    i1, j1, shift1 = pairs.qi[ssafe], pairs.qj[ssafe], pairs.shift[ssafe]

    def clip_rows(rows, pscale):
        return intersect_regions(
            floes.verts[i1[rows]], floes.nverts[i1[rows]],
            q_verts[j1[rows]] + shift1[rows][:, None, :], q_n[j1[rows]],
            CAP=clip_cap, perturb=perturb0[ssafe[rows]] * pscale)

    sregions = clip_rows(slice(None), 1.0)
    bad1 = svalid & sregions.overflow
    if retry:
        bsel = first_true(bad1, 16, SLOW_CAP)
        bsafe = torch.clamp(bsel, max=SLOW_CAP - 1)
        regs2 = clip_rows(bsafe, -41.0)
        idx = torch.where((bsel < SLOW_CAP) & ~regs2.overflow, bsafe, SLOW_CAP)

        def put(a, b):
            ext = torch.cat([a, a[:1]], dim=0)
            ext[idx] = b
            return ext[:SLOW_CAP]

        sregions = ClipRegions(*(put(a, b) for a, b in zip(sregions, regs2)))
    return sregions, svalid, bad1


def _on_rows(r, rows):
    return ClipRegions(*(x[rows] for x in r))


def assert_slow_rows(got, gbad, ref, valid, rbad, what):
    """The kernel's rows against the masked path's: equal on the slow rows,
    zeros past them; parity flags equal."""
    n = int(valid.sum())
    assert bool(valid[:n].all()) and not bool(valid[n:].any())
    assert torch.equal(gbad, rbad), what + "parity_bad"
    assert_against_plain(_on_rows(got, slice(0, n)), _on_rows(ref, slice(0, n)),
                         True, what)
    for f, x in zip(got._fields, got):
        assert not bool(x[n:].any()), what + f + " past n_slow"


CASES = {"n_slow_0": ("no_slow_pairs", None), "n_slow_1": ("beyond_first_tier", 1),
         "n_slow_7": ("beyond_first_tier", 7),
         "n_slow_slow_cap": ("beyond_slow_cap", SLOW_CAP),
         "n_slow_above_slow_cap": ("beyond_slow_cap", None)}


@pytest.mark.parametrize("case", list(CASES))
def test_slow_path_through_the_kernel_arithmetic(case, shim, monkeypatch):
    field, cut = CASES[case]
    fl, dom, nb, tc, clip_cap = _field(field)
    slow = (tc.cnt > 0) & ~tc.ok
    n_field = int(slow.sum())
    if cut is None:  # the step's own slow path, through the shim
        ref, valid, rbad = masked_path(fl, nb, tc, clip_cap, retry=True)
        monkeypatch.setattr(tcol, "intersect_regions_dispatch",
                            lambda *a: regions.run_host_shim(shim, *a))
        got = tcol._slow_path(nb, tc, PAIR_CAP, clip_cap, retry=True)
        assert int(got.n_slow) == n_field
        assert torch.equal(got.valid, valid)
        assert_slow_rows(got.regions, got.parity_bad, ref, valid, rbad, case + ": ")
        want = 0 if case == "n_slow_0" else SLOW_CAP
        assert int(valid.sum()) == want and (want == 0 or n_field > SLOW_CAP)
        return
    # a tier's worth of the field's slow rows: the selection cut at ``cut``
    assert n_field >= cut
    PC = nb.pairs.qi.shape[0]
    ssel = first_true(slow, SLOW_CAP, PC)
    ssel = torch.where(torch.arange(SLOW_CAP) < cut, ssel, PC)
    n_slow = torch.tensor(cut)
    args = (*nb.two_cross_args()[:8], ssel, n_slow, clip_cap, 16)
    got, gbad = regions.run_host_shim(shim, *args)
    ref, rbad = regions.slow_regions_plain(*args)
    assert_slow_rows(got, gbad, ref, ssel < PC, rbad, case + ": ")
    # the masked path's rows on the same slow rows: the same clip
    full, _, _ = masked_path(fl, nb, tc, clip_cap, retry=False)
    part = _on_rows(full, slice(0, cut))
    first, _ = regions.run_host_shim(shim, *args[:-1], 0)
    assert_against_plain(_on_rows(first, slice(0, cut)), part, True, case + ": ")


def test_the_retry_takes_the_first_16_odd_rows_only(shim):
    """parity_retry's field at CAP 2: 26 rows come out odd (more crossings
    than CAP), more than the retry takes.  None of them resolves (the
    lattice polygons of test_torch_regions.py are where retries resolve),
    so the retry changes no row, and the result equals the masked path's
    merge."""
    fl, dom, nb, tc, _ = _field("parity_retry")
    slow = (tc.cnt > 0) & ~tc.ok
    PC = nb.pairs.qi.shape[0]
    args = (*nb.two_cross_args()[:8], first_true(slow, SLOW_CAP, PC), slow.sum(), 2)
    first, bad = regions.run_host_shim(shim, *args, 0)
    retried, bad2 = regions.run_host_shim(shim, *args, 16)
    assert int(bad.sum()) > 16 and torch.equal(bad, bad2), int(bad.sum())
    assert not bool((bad & ~retried.overflow).any())
    for f, a, b in zip(first._fields, first, retried):
        assert torch.equal(a, b), f
    ref, valid, rbad = masked_path(fl, nb, tc, 2, retry=True)
    assert_slow_rows(retried, bad2, ref, valid, rbad, "parity_retry CAP 2: ")


@pytest.mark.parametrize("case", ["parity_retry", "beyond_first_tier"])
def test_timestep_collisions_through_the_kernel_arithmetic(case, shim, monkeypatch):
    r0, spike, clip_cap, _ = PACKED_CASES[case]
    fl, _, _, dom, _ = port_state(_packed_field(r0, spike), PERIODIC_DOMAIN)
    args = (fl, dom, port_settings(CONSTS), DT, port_settings(CSET), PAIR_CAP, clip_cap)
    ref, rdbg = tcol.timestep_collisions(*args, with_debug=True)
    monkeypatch.setattr(tcol, "intersect_regions_dispatch",
                        lambda *a: regions.run_host_shim(shim, *a))
    got, gdbg = tcol.timestep_collisions(*args, with_debug=True)
    assert {k: int(v) for k, v in gdbg.items()} == {k: int(v) for k, v in rdbg.items()}
    assert rdbg["n_slow"] > 0
    for f, g, r in zip(ref.floes._fields, got.floes, ref.floes):
        if g.is_floating_point():
            torch.testing.assert_close(g, r, rtol=1e-12,
                                       atol=1e-12 * float(r.abs().max()), msg=f)
        else:
            assert torch.equal(g, r), f
    torch.testing.assert_close(got.stress_instant, ref.stress_instant, rtol=1e-12,
                               atol=1e-12 * float(ref.stress_instant.abs().max()))
    assert bool(got.overflow) == bool(ref.overflow)


def test_the_wrapper_refuses_what_the_kernel_cannot_take():
    """CAP above 64 (MAX_CAP) and rings wider than 128 (MAX_VERTS) raise
    ValueError naming the limit, before anything is launched (the checks
    read only shapes, so they run here); CPU tensors raise: the kernel takes
    CUDA tensors."""
    fl, dom, nb, tc, _ = _field("beyond_first_tier")
    PC = nb.pairs.qi.shape[0]
    slow = (tc.cnt > 0) & ~tc.ok
    base = [*nb.two_cross_args()[:8], first_true(slow, SLOW_CAP, PC), slow.sum(), 16, 16]
    assert (regions.MAX_CAP, regions.MAX_VERTS) == (64, 128)
    with pytest.raises(ValueError, match="CAP <= 64"):
        regions.regions_cuda(*base[:10], 65, 16)
    wide = torch.zeros((fl.capacity, 129, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="at most 128 vertices"):
        regions.regions_cuda(wide, *base[1:])
    with pytest.raises(ValueError, match="at most 128 vertices"):
        regions.regions_cuda(*base[:2], torch.zeros((nb.q_verts.shape[0], 129, 2),
                                                    dtype=torch.float64), *base[3:])
    with pytest.raises(ValueError, match="CUDA"):
        regions.regions_cuda(*base)
    # at the limits the checks pass and only the device is refused
    with pytest.raises(ValueError, match="CUDA"):
        regions.regions_cuda(*base[:10], 64, 16)
    # the CPU goes to the plain version, at any CAP
    got, _ = regions.intersect_regions_dispatch(*base[:10], 80, 16)
    ref, _ = regions.slow_regions_plain(*base[:10], 80, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert np.asarray(got.area).shape == (SLOW_CAP, 80)


def test_held_against_plain_limits_grow_past_the_read_width():
    """``regions.held_against_plain`` keeps LIMIT_SAME and LIMIT_F64 as read
    on rings of up to READ_VERTS (40) vertices, and on a wider row lets the
    limits of the summed fields grow with its prefix sums' terms, (2n + 1) /
    81: on the slow rows of star rings (f64), the plain version's own result
    passes at 40 and 128 vertices; one row's total_area moved by 1.5 times
    its limit is refused at 40 vertices, moved by half-way to the grown
    limit passes at 128 and moved by 1.5 times the grown limit is refused."""
    from subzero_tpu_torch.geometry.clip import two_cross_pairs

    from torch_port_helpers import build_pair_list, tt

    assert regions.READ_VERTS == 40
    limit, eps = regions.LIMIT_SAME["total_area"], torch.finfo(torch.float64).eps
    for V in (40, 128):
        args = tt(*build_pair_list(B=128, seed=5, V=V, nmax=V, dtype=np.float64))[:8]
        tc = two_cross_pairs(*args, torch.ones(args[4].shape[0], dtype=torch.bool))
        slow = (tc.cnt > 0) & ~tc.ok
        ssel, n_slow = first_true(slow, 16, args[4].shape[0]), slow.sum()
        assert int(n_slow) >= 16
        got, gbad = regions.slow_regions_plain(*args, ssel, n_slow, 32, 16)
        held = regions.held_against_plain(got, gbad, *args, ssel, n_slow, 32, 16)
        pv, pn, qv, qn, qi, qj, shift = args[:7]
        n = torch.maximum(pn[qi[ssel]], qn[qj[ssel]])
        row = int(n.argmax())
        i, j = int(qi[ssel[row]]), int(qj[ssel[row]])
        L = max(float(pv[i, :pn[i]].abs().max()),
                float((qv[j, :qn[j]] + shift[ssel[row]]).abs().max()))
        grow = max(1.0, (2 * int(n[row]) + 1) / 81)
        assert held["limits_grown_by"] == grow
        assert (grow == 1.0) == (V == 40)

        def moved(k):
            x = got.total_area.clone()
            x[row] += k * limit * eps * L ** 2
            return got._replace(total_area=x)

        if V == 128:
            regions.held_against_plain(moved((1 + grow) / 2), gbad, *args, ssel,
                                       n_slow, 32, 16)
        with pytest.raises(AssertionError, match="slow clip total_area"):
            regions.held_against_plain(moved(1.5 * grow), gbad, *args, ssel,
                                       n_slow, 32, 16)
