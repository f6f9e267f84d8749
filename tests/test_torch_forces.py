"""The force law's kernel arithmetic (B4, ``csrc/forces.cuh``) on the CPU.

The g++ shim of the header (``forces.run_host_shim``: the kernel's work
items run one after another) against the plain PyTorch force law
(``collisions._force_law_plain``) to the bit, in f32 and f64, with the
step's marking and without it (``pair_interactions``'): every force, force
point and overlap record of both contact lists, the fuse / remove marks and
the slow rows' sides, zeros' signs included.  On the contact lists of a
shear_flow field after 10 steps (the 500-floe example), of packed periodic
star fields whose contacts cross more than twice (slow rows with several
regions; rows past n_slow; more slow rows than slow_cap), and of walled and
open fields (floe-wall and floe-topography rows, the wall-normal correction,
fusing and removal).  ``timestep_collisions`` and ``pair_interactions``
through the shim end where the plain version does, to the bit.  And the
shim's forces against the JAX package's ``_region_forces`` on the same
inputs, f64, rtol 1e-9.

PyTorch's ``torch.sqrt`` on the CPU goes through MKL's vector math, within
an ulp but not correctly rounded (it parts from numpy's IEEE square root on
~0.7% of random inputs, in f32 and f64); on CUDA, and in the kernel and the
shim, a square root is correctly rounded.  So the plain version is held to
the shim with ``torch.sqrt`` taken as the IEEE square root (``ieee_sqrt``),
which is the plain version the card runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subzero_tpu.physics import collisions as jcol
from subzero_tpu_torch.examples import shear_flow
from subzero_tpu_torch.physics import collisions as tcol
from subzero_tpu_torch.physics import forces
from subzero_tpu_torch.simulation import run_scan

from test_collisions import CONSTS, CSET, DT, OPEN_DOMAIN, TOPO_DOMAIN
from test_torch_collisions import OPEN_CASES, TOPO_CASES, _floes
from test_torch_collisions_slow_path import PACKED_CASES, PERIODIC_DOMAIN, _packed_field
from torch_port_helpers import port_settings, port_state

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# field: (builder of the reference's floes and domain, pair_cap, clip_cap)
def _packed(case):
    return lambda: (_packed_field(*PACKED_CASES[case][:2]), PERIODIC_DOMAIN)


JAX_FIELDS = {
    "packed_beyond_first_tier": (_packed("beyond_first_tier"), 320, 16),
    "packed_beyond_slow_cap": (_packed("beyond_slow_cap"), 320, 16),
    "packed_parity_retry": (_packed("parity_retry"), 320, 4),
    **{f"walls_{name}": ((lambda c=c: (_floes(*c, N=2), TOPO_DOMAIN)), 64, 16)
       for name, c in TOPO_CASES.items()},
    **{f"open_{name}": ((lambda c=c: (_floes(*c, N=3), OPEN_DOMAIN)), 64, 16)
       for name, c in OPEN_CASES.items() if name in ("large_overlap_fuses",
                                                     "cshape_two_regions")},
}
FIELDS = ["shear_flow_step", *JAX_FIELDS]


@dataclasses.dataclass
class Batch:
    """One contact list's inputs to the force law, as the step makes them."""

    consts: object
    dt: float
    cs: object
    floes: object
    domain: object
    nb: object
    tc: object
    slow: object
    pair_cap: int
    clip_cap: int


def _batch(consts, dt, cs, fl, dom, pair_cap, clip_cap):
    nb = tcol.narrow_phase_batch(fl, dom, pair_cap)
    tc = tcol.two_cross_dispatch(*nb.two_cross_args())
    slow = tcol._slow_path(nb, tc, pair_cap, clip_cap, retry=True)
    return Batch(consts, dt, cs, fl, dom, nb, tc, slow, pair_cap, clip_cap)


_CACHE = {}


def batch_of(field, dtype):
    key = (field, dtype)
    if key not in _CACHE:
        if field == "shear_flow_step":
            sim, _ = run_scan(shear_flow.build(dtype=dtype, n_dt=0, device="cpu"), 10)
            m = sim.model
            _CACHE[key] = _batch(sim.consts, sim.dt, sim.collision_settings, m.floes,
                                 m.domain, sim.pair_cap, sim.clip_cap)
        else:
            make, pair_cap, clip_cap = JAX_FIELDS[field]
            jfl, jdom = make()
            fl, _, _, dom, _ = port_state(jfl, jdom, dtype=dtype)
            _CACHE[key] = _batch(port_settings(CONSTS), DT, port_settings(CSET), fl, dom,
                                 pair_cap, clip_cap)
    return _CACHE[key]


@pytest.fixture
def ieee_sqrt(monkeypatch):
    """torch.sqrt correctly rounded, as on CUDA (numpy's square root)."""
    monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(np.sqrt(x.numpy())))


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return forces.build_host_shim(tmp_path_factory.mktemp("forces_shim"))


def law_args(b: Batch, marking: bool):
    pairs, slow = b.nb.pairs, b.slow
    return (b.consts, b.dt, b.cs if marking else None, b.domain.vals, b.floes,
            b.nb.q_table, pairs.qi, pairs.qj, pairs.shift, pairs.valid, b.tc,
            slow.sel, slow.i, slow.j, slow.shift, slow.regions, marking)


def bits(x):
    x = x.contiguous()
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    return x


def assert_same_law(got, ref, what):
    """Every field of two ForceLaws equal to the bit (a zero's sign too)."""
    for f in forces.ForceLaw._fields:
        a, b = getattr(got, f), getattr(ref, f)
        if f == "s_sides":
            for g, x, y in zip(a._fields, a, b):
                assert torch.equal(bits(x), bits(y)), f"{what}: s_sides.{g}"
        elif a is None or b is None:
            assert a is None and b is None, f"{what}: {f}"
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, f"{what}: {f}"
            assert torch.equal(bits(a), bits(b)), f"{what}: {f}"


@pytest.mark.parametrize("marking", [True, False], ids=["step", "interactions"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("field", FIELDS)
def test_shim_equals_plain_force_law_bitwise(field, dtype, marking, shim, ieee_sqrt):
    b = batch_of(field, DTYPES[dtype])
    args = law_args(b, marking)
    ref = tcol._force_law_plain(b.consts, b.dt, args[2], b.domain.vals, b.floes,
                                b.nb, b.tc, b.slow, marking)
    got = forces.run_host_shim(shim, *args)
    assert_same_law(got, ref, f"{field} {dtype}")
    # the CUDA rule for min_area's "/ 1.75" moves no gate on these fields
    card = forces.run_host_shim(shim, *args, card_div=True)
    assert_same_law(card, ref, f"{field} {dtype} (card's division)")


def test_fields_cover_every_branch(shim):
    """Between them the fields hold what the kernel must get right: fast
    and slow rows with force and without, slow rows with several regions,
    rows past n_slow, more slow rows than slow_cap, wall and topography
    rows with force, a region past a wall (its normal component zeroed),
    fuse and domain-remove marks."""
    seen = dict.fromkeys(("fast_force", "fast_zero_valid", "slow_force",
                          "slow_multi_region", "past_n_slow", "beyond_slow_cap",
                          "wall_force", "topography_force", "past_a_wall",
                          "fuse", "dom_remove"), False)
    for field in FIELDS:
        b = batch_of(field, torch.float64)
        law = forces.run_host_shim(shim, *law_args(b, True))
        N = b.floes.capacity
        pairs, slow, tc = b.nb.pairs, b.slow, b.tc
        fnz = law.f_force[:, 0].abs().sum(-1) > 0
        seen["fast_force"] |= bool(fnz.any())
        seen["fast_zero_valid"] |= bool((pairs.valid & ~fnz).any())
        snz = law.s_force.abs().sum(-1) > 0
        seen["slow_force"] |= bool(snz.any())
        seen["slow_multi_region"] |= bool((slow.regions.valid.sum(1) > 1).any())
        seen["past_n_slow"] |= bool((~slow.valid).any()) and bool(slow.valid.any())
        seen["beyond_slow_cap"] |= int(slow.n_slow) > slow.valid.shape[0]
        j = pairs.qj
        seen["wall_force"] |= bool((fnz & (j >= N) & (j < N + 4)).any())
        seen["topography_force"] |= bool((fnz & (j >= N + 4)).any())
        wid = torch.clamp(j - N, 0, 3)
        fp = tc.centroid
        v = b.domain.vals[wid]
        beyond = torch.where(wid < 2, torch.where(wid == 0, fp[:, 1] >= v, fp[:, 1] <= v),
                             torch.where(wid == 2, fp[:, 0] >= v, fp[:, 0] <= v))
        seen["past_a_wall"] |= bool((fnz & (j >= N) & (j < N + 4) & beyond).any())
        seen["fuse"] |= bool(law.fuse.any())
        seen["dom_remove"] |= bool(law.dom_remove.any())
    assert all(seen.values()), seen


def _through_shim(shim, monkeypatch):
    def law(consts, dt, cs, vals, floes, nb, tc, slow, marking):
        pairs = nb.pairs
        return forces.run_host_shim(
            shim, consts, dt, cs, vals, floes, nb.q_table, pairs.qi, pairs.qj,
            pairs.shift, pairs.valid, tc, slow.sel, slow.i, slow.j, slow.shift,
            slow.regions, marking)
    monkeypatch.setattr(tcol, "_force_law", law)


@pytest.mark.parametrize("field", ["shear_flow_step", "packed_beyond_first_tier",
                                   "walls_wall_and_topography",
                                   "walls_large_wall_overlap_removes",
                                   "open_large_overlap_fuses"])
def test_step_and_interactions_through_the_shim_match_plain(field, shim, monkeypatch,
                                                            ieee_sqrt):
    """timestep_collisions and pair_interactions with the force law's shim in
    place of the plain force law: every output equal to the bit (f32)."""
    b = batch_of(field, torch.float32)

    def both():
        res = tcol.timestep_collisions(b.floes, b.domain, b.consts, b.dt, b.cs,
                                       b.pair_cap, b.clip_cap)
        rows = tcol.pair_interactions(b.floes, b.domain, b.consts, b.dt, b.pair_cap,
                                      b.clip_cap)
        return res, rows

    ref_res, ref_rows = both()
    _through_shim(shim, monkeypatch)
    got_res, got_rows = both()
    for f, x, y in zip(ref_res.floes._fields, got_res.floes, ref_res.floes):
        assert torch.equal(bits(x), bits(y)), f
    assert torch.equal(bits(got_res.stress_instant), bits(ref_res.stress_instant))
    assert torch.equal(got_res.overflow, ref_res.overflow)
    assert got_rows.keys() == ref_rows.keys()
    for k in ref_rows:
        assert torch.equal(bits(got_rows[k]), bits(ref_rows[k])), k


def _jax_sides(s, shift):
    return jcol._PairSides(**{f: jnp.asarray(getattr(s, f).numpy())
                              for f in jcol._PairSides._fields}), jnp.asarray(shift.numpy())


def _jax_regions(r):
    return jcol.ClipRegions(**{f: jnp.asarray(getattr(r, f).numpy())
                               for f in jcol.ClipRegions._fields})


@pytest.mark.parametrize("field", FIELDS)
def test_shim_forces_match_jax_region_forces(field, shim):
    """The shim's forces, force points and overlap records of both lists
    against the JAX package's _region_forces on the same sides, regions and
    pair gates, f64, rtol 1e-9 (floor 1e-9 of each field's largest
    magnitude)."""
    b = batch_of(field, torch.float64)
    law = forces.run_host_shim(shim, *law_args(b, True))
    jconsts = dataclasses.replace(CONSTS, E=b.consts.E, nu=b.consts.nu, mu=b.consts.mu)
    vals = jnp.asarray(b.domain.vals.numpy())
    slow, pairs = b.slow, b.nb.pairs
    # the pairs' gates, from the marks the shim made
    pair_on0 = b.tc.ok & ~law.fuse & ~law.dom_remove
    total = torch.where(slow.valid, slow.regions.total_area, 0.0)
    ssafe = slow.safe
    pair_on1 = slow.valid & ~law.fuse[ssafe] & ~law.dom_remove[ssafe] & (total > 0)
    sides1 = tcol._gather_sides(b.floes, b.nb.q_table, slow.i, slow.j)
    lists = (
        (b.nb.sides, pairs.shift, tcol._fast_regions(b.tc, b.tc.ok), pair_on0,
         (law.f_force, law.f_fp, law.f_rec)),
        (sides1, slow.shift, slow.regions, pair_on1, (law.s_force, law.s_fp, law.s_rec)),
    )
    for s, shift, regs, on, got in lists:
        js, jshift = _jax_sides(s, shift)
        ref = jcol._region_forces(jconsts, b.dt, vals, js, jshift, _jax_regions(regs),
                                  jnp.asarray(on.numpy()))
        for name, g, r in zip(("force", "fp", "overlap_rec"), got, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-9,
                                       atol=1e-9 * max(float(np.abs(r).max()), 1e-300),
                                       err_msg=f"{field}: {name}")
