"""Spatial domain decomposition: 1-D x-slabs or 2-D (x, y) slabs, one rank each.

Port of ``subzero_tpu/parallel/decomp.py``.  The global domain is split into
slabs; each rank (a process of its own, ``parallel/multihost.py``) owns the
floes whose centroid lies in its slab, in a pool of ``local_cap`` rows.  A
step on every rank:

  1. **Halo exchange**: floes within ``margin`` of a slab edge are packed into
     fixed-size buffers (every field of a buffer in one flat message) and sent
     to the neighbour, shifted through a periodic boundary.
  2. **Contacts** on ``[local | halo from below | halo from above]``; the
     broad phase takes the local rows only (``owned_rows``), so a seam pair is
     computed on both ranks and no force travels back.
  3. **Coupling, integration, wrap, removal**: per-floe work is local; the
     two-way coupling's per-cell sums and the dissolved-mass deposit are
     summed over the ranks in rank order before use.
  4. **Migration**: floes whose centroid left the slab move, whole, to the
     owner's free rows.

The coupling cadence, the host life cycle and the writers are host branches
taken alike on every rank (``tstep`` is a Python int).  A step reads the host
once: one ``all_reduce(MAX)`` of its overflow and fuse flags.
"""

from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.domain import EAST, NORTH, SOUTH, WEST, Domain
from ..core.floes import FloeState
from ..geometry import two_cross as _two_cross
from ..geometry.clip import first_true
from ..physics import collisions as _collisions
from ..physics import coupling as _coupling
from ..physics import simplification as _simplification
from ..physics import update_floe as _update_floe
from .multihost import Comm, is_io_process, pack_rows, unpack_rows

__all__ = [
    "Decomp", "make_decomp", "distribute", "gather", "build_decomp_step",
    "build_decomp_step_halves", "build_decomp_segment",
    "run_decomp", "measure_decomp_scaling", "time_decomp_steps",
    "Decomp2D", "make_decomp_2d", "distribute_2d", "build_decomp_step_2d",
]

# fields a halo copy needs: everything the pair kernel and the force recipe
# read from either side of a contact, and "id" so a fuse mark against a halo
# copy can name the partner (_fuse_with_to_ids)
_HALO_FIELDS = (
    "verts", "nverts", "centroid", "height", "area", "rmax",
    "u", "v", "xi", "active", "id",
)

# Diagnostic: when True, every halo and migration exchange hands a rank its
# own buffers back instead of its neighbours' (the JAX package's identity
# permutation).  Buffer shapes, packing and the contact and coupling work stay
# as they are and no data moves between ranks, so timing against False
# isolates the transport.  Received halo copies are deactivated (they would
# sit on the sender's own floes).
COMM_IDENTITY = False


def comm_bytes_per_step(sim, dec) -> dict:
    """The bytes one rank sends in one step, by channel, as capacity bounds
    (a buffer always has its full rows):
      * halo exchange: 2 directions x halo_cap rows of _HALO_FIELDS (2-D:
        both axes, and the y pass re-sends the x halos: corners);
      * migration: 2 directions x mig_cap rows of the whole floe state;
      * grid sums at the coupling cadence (two-way coupling) and the
        dissolved deposit, as a ring all-reduce would send them (~2x the
        array), amortised over the cadence.
    The same formula as the JAX package's."""
    fl = sim.model.floes

    def row(t):
        return int(np.prod(t.shape[1:]) or 1) * t.element_size()

    halo_row = sum(row(getattr(fl, f)) for f in _HALO_FIELDS)
    full_row = sum(row(t) for t in fl)
    n_axes = 2 if isinstance(dec, Decomp2D) else 1
    halo_b = 2 * n_axes * dec.halo_cap * halo_row
    if n_axes == 2:
        halo_b += 2 * 2 * dec.halo_cap * halo_row  # corner pass-through
    mig_b = 2 * n_axes * dec.mig_cap * full_row
    grid_b = 0
    if sim.coupling_settings.coupling_on:
        oc = sim.model.ocean

        def size(t):
            return int(np.prod(t.shape) or 1) * t.element_size()

        per_inv = sum(size(t) for t in (oc.tau_x, oc.tau_y, oc.si_frac,
                                        oc.hflx_factor, oc.dissolved))
        if not sim.coupling_settings.two_way_coupling_on:
            per_inv = size(oc.dissolved)
        grid_b = int(2 * per_inv / max(int(sim.coupling_settings.dt), 1))
    return {
        "halo_bytes": halo_b,
        "migration_bytes": mig_b,
        "grid_psum_bytes_amortized": grid_b,
        "total": halo_b + mig_b + grid_b,
        "halo_row_bytes": halo_row,
        "full_row_bytes": full_row,
    }


@dataclasses.dataclass(frozen=True)
class Decomp:
    """Static 1-D decomposition parameters.  ``comm`` is this rank's view of
    the process group (``multihost.Comm``); a decomposition whose group has
    another size than ``n_dev`` is a plan only (its capacities can be read,
    but its step refuses to run)."""

    comm: Comm
    axis: str            # axis name, as the JAX package's
    n_dev: int           # ranks along the axis
    local_cap: int       # a rank's floe pool capacity
    halo_cap: int        # most floes ghosted across one slab edge
    mig_cap: int         # most floes crossing one slab edge in a step
    margin: float        # halo width (>= 2 * max floe radius)


def _comm_for(floes: FloeState, group) -> Comm:
    return Comm(group, floes.verts.device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def make_decomp(
    floes: FloeState,
    domain: Domain,
    n_devices: Optional[int] = None,
    axis: str = "x",
    local_cap: Optional[int] = None,
    halo_cap: Optional[int] = None,
    mig_cap: Optional[int] = None,
    margin: Optional[float] = None,
    group=None,
) -> Decomp:
    """Choose decomposition capacities from the initial floe field (the JAX
    package's rules).  ``n_devices`` defaults to the size of ``group`` (the
    default process group; one rank without one)."""
    comm = _comm_for(floes, group)
    D = comm.size if n_devices is None else int(n_devices)
    act = _host(floes.active)
    cx = _host(floes.centroid[:, 0])[act]
    rmax = _host(floes.rmax)[act]
    vals = _host(domain.vals).astype(float)
    w, e = vals[WEST], vals[EAST]
    slab_w = (e - w) / D
    if margin is None:
        margin = float(2.2 * rmax.max()) if rmax.size else slab_w / 4
        # tiny pools or many slabs: the margin can exceed the slab; clamp it
        # (the halo then covers the whole neighbour slab: more traffic, still
        # correct) so that the defaults work at any pool size
        margin = min(margin, float(slab_w))
    if margin > slab_w:
        raise ValueError(
            f"halo margin {margin:.3g} exceeds slab width {slab_w:.3g}; "
            f"use fewer devices or smaller floes"
        )
    slab = np.clip(((cx - w) / slab_w).astype(int), 0, D - 1)
    occ = np.bincount(slab, minlength=D)
    if local_cap is None:
        # headroom for density imbalance and fracture pieces
        local_cap = int(max(2 * occ.max() + 8, 16))
    if halo_cap is None:
        near = 0
        for d in range(D):
            lo = w + d * slab_w
            hi = lo + slab_w
            m = (slab == d) & (
                (cx - rmax < lo + margin) | (cx + rmax > hi - margin)
            )
            near = max(near, int(m.sum()))
        halo_cap = int(max(2 * near + 8, 8))
    if mig_cap is None:
        mig_cap = int(max(local_cap // 8, 8))
    return Decomp(
        comm=comm, axis=axis, n_dev=D, local_cap=local_cap,
        halo_cap=halo_cap, mig_cap=mig_cap, margin=float(margin),
    )


def _slab_rows(slab, act, n_slabs: int, cap: int) -> list:
    """Pool rows of each slab's active floes, in row order; raises
    ValueError when a slab holds more than ``cap`` (every rank checks every
    slab, so all of them raise alike)."""
    out = []
    for d in range(n_slabs):
        rows = np.flatnonzero(act & (slab == d))
        if rows.size > cap:
            raise ValueError(f"slab {d} holds {rows.size} floes > local_cap {cap}")
        out.append(rows)
    return out


def _place(rows, cap: int, tree, device):
    """This rank's block: the given pool rows on top, zeros below, on
    ``device``.  ``tree``: a FloeState or one tensor."""
    idx = torch.as_tensor(rows, dtype=torch.int64)

    def one(a):
        a = a.to(device)
        block = a.new_zeros((cap,) + a.shape[1:])
        block[: idx.numel()] = a[idx.to(device)]
        return block

    if isinstance(tree, torch.Tensor):
        return one(tree)
    return type(tree)(*(one(a) for a in tree))


def _slabs_1d(floes, domain, D):
    vals = _host(domain.vals).astype(float)
    w, e = vals[WEST], vals[EAST]
    cx = _host(floes.centroid[:, 0])
    return np.clip(((cx - w) / ((e - w) / D)).astype(int), 0, D - 1)


def distribute(floes: FloeState, domain: Domain, dec: Decomp, extra=None):
    """This rank's block of a global floe pool: the active floes of its slab
    in pool order, then empty rows, ``[local_cap]`` on this rank's device.
    Every rank holds the same global pool.  Rank d's block is rows
    ``[d * local_cap, (d + 1) * local_cap)`` of the JAX package's pool.

    ``extra``: a tensor with the pool's leading length (the per-floe stress
    rows a mid-step host pass carries) placed the same way; the return is
    then ``(floes, extra)``."""
    rows = _slab_rows(_slabs_1d(floes, domain, dec.n_dev), _host(floes.active),
                      dec.n_dev, dec.local_cap)[dec.comm.rank]
    out = _place(rows, dec.local_cap, floes, dec.comm.device)
    if extra is None:
        return out
    return out, _place(rows, dec.local_cap, extra, dec.comm.device)


def gather(floes_d: FloeState, dec=None) -> FloeState:
    """Every rank's block in rank order, on every rank: the JAX package's
    ``[D * local_cap]`` pool row for row, on this rank's device.  A
    collective: every rank of the decomposition calls it."""
    comm = dec.comm if dec is not None else _comm_for(floes_d, None)
    return comm.gather_tree(floes_d)


def _compact_active(floes: FloeState, host_cap: int):
    """The active rows of a pool in order, in a [host_cap] pool whose other
    rows are empty (fuse_with -1: safe free rows for the host passes'
    pieces).  ``fuse_with`` holds partner ids in a decomposition
    (_fuse_with_to_ids), so renumbering rows is safe.  Returns (pool,
    overflow): overflow means host_cap must grow."""
    N = floes.capacity
    mask = floes.active
    sel = first_true(mask, host_cap, N)
    valid = sel < N
    safe = torch.clamp(sel, max=N - 1)

    def take(a):
        v = valid.reshape((host_cap,) + (1,) * (a.dim() - 1))
        return torch.where(v, a[safe], torch.zeros_like(a[safe]))

    out = FloeState(*(take(a) for a in floes))
    out = out._replace(
        active=out.active & valid,
        fuse_with=torch.where(valid, out.fuse_with, -1).to(torch.int32),
    )
    return out, bool(mask.sum() > host_cap)


def gather_active(floes_d: FloeState, host_cap: int, dec=None):
    """``gather`` restricted to the active rows, in a [host_cap] pool on every
    rank.  Returns (pool, overflow)."""
    return _compact_active(gather(floes_d, dec), host_cap)


def _fuse_with_to_ids(fuse_with, ext: FloeState):
    """Collision fuse marks from extended-pool rows to the partner's id.

    In a decomposition ``fuse_with`` holds partner ids, not rows: migration
    renumbers local rows, halo rows exist only inside one rank's step, and
    ``gather_active`` compacts rows again, so a row would name the wrong
    floe.  ``run_decomp`` maps ids back to rows of the gathered pool just
    before the host fuse pass (``_fuse_ids_to_rows``)."""
    cap = ext.capacity
    pid = ext.id[torch.clamp(fuse_with.long(), 0, cap - 1)]
    return torch.where(fuse_with >= 0, pid, -1).to(torch.int32)


def _fuse_ids_to_rows(floes: FloeState) -> FloeState:
    """Inverse of _fuse_with_to_ids on a gathered pool: ``fuse_with`` partner
    ids become rows (what lifecycle_host.fuse_floes takes).  A partner no
    longer in the pool is cleared to -1, and so is a floe's mark against its
    own periodic image (fusing a floe with itself means nothing)."""
    fw = _host(floes.fuse_with)
    marked = np.nonzero(fw >= 0)[0]
    if marked.size == 0:
        return floes
    ids = _host(floes.id)
    act = _host(floes.active)
    lookup = {int(ids[r]): int(r) for r in np.nonzero(act)[0]}
    out = np.full_like(fw, -1)
    for r in marked:
        p = lookup.get(int(fw[r]), -1)
        out[r] = -1 if p == r else p
    return floes._replace(fuse_with=torch.as_tensor(out, device=floes.fuse_with.device))


def _pack(floes: FloeState, mask, cap: int, fields):
    """The masked floes, in row order, in a fixed [cap] buffer of the given
    fields (rows past the masked ones repeat the last row, inactive); and
    whether more than ``cap`` were masked."""
    N = floes.capacity
    sel = first_true(mask, cap, N)
    valid = sel < N
    safe = torch.clamp(sel, max=N - 1)
    out = {f: getattr(floes, f)[safe] for f in fields}
    out["active"] = out["active"] & valid
    return out, mask.sum() > cap


def _as_halo_state(template: FloeState, packed: dict, cap: int) -> FloeState:
    """A FloeState of ``cap`` rows with the packed fields filled in and every
    other field zero (halo copies never need them)."""
    return FloeState(*(
        packed[f] if f in packed else a.new_zeros((cap,) + a.shape[1:])
        for f, a in zip(FloeState._fields, template)
    ))


def _shift_xy(state_dict: dict, dx, dy):
    """Translate packed halo or migration buffers by (dx, dy)."""
    out = dict(state_dict)
    c = state_dict["centroid"]
    sv = torch.stack([torch.as_tensor(dx, dtype=c.dtype, device=c.device),
                      torch.as_tensor(dy, dtype=c.dtype, device=c.device)])
    out["verts"] = state_dict["verts"] + sv
    out["centroid"] = c + sv
    return out


def _shift_x(state_dict: dict, dx):
    return _shift_xy(state_dict, dx, 0.0)


def _swap(comm: Comm, to_lo: dict, to_hi: dict, lo, hi, fields):
    """Send two packed dicts to the lower and upper neighbour rank (None: no
    neighbour) as one flat message each; returns (from_lo, from_hi) dicts:
    what the lower neighbour sent up and the upper one sent down."""
    if COMM_IDENTITY:
        return dict(to_hi), dict(to_lo)
    like = [to_lo[f] for f in fields]
    got_lo, got_hi = comm.exchange(pack_rows(like), pack_rows([to_hi[f] for f in fields]),
                                   lo, hi)
    return (dict(zip(fields, unpack_rows(got_lo, like))),
            dict(zip(fields, unpack_rows(got_hi, like))))


def _deactivated(packed: dict) -> dict:
    return dict(packed, active=torch.zeros_like(packed["active"]))


def _neighbours(me: int, D: int, wrap: bool):
    """(lower, upper) neighbour along an axis of D ranks; None at a closed edge."""
    lo = (me - 1) % D if (wrap or me > 0) else None
    hi = (me + 1) % D if (wrap or me < D - 1) else None
    return lo, hi


def _put(x, idx, vals, n: int):
    """x with rows idx set to vals; idx == n rows drop out."""
    ext = torch.cat([x, x[:1]], dim=0)
    ext[idx] = vals
    return ext[:n]


def _migrate_axis(floes, comm, D, me, stride, origin, slab_w, coord, wrap,
                  Hm, Nl, overflow):
    """Move the floes whose centroid left this rank's slab along one axis to
    the owner, into its free rows.  Ranks along the axis are ``stride``
    apart in the group."""
    if D == 1:
        return floes, overflow
    c = floes.centroid[:, coord]
    dest = torch.clamp(torch.floor((c - origin) / slab_w).to(torch.int32), 0, D - 1)
    hop = torch.remainder(dest - me, D)
    go_up = floes.active & (hop >= 1) & (hop <= D // 2)
    go_dn = floes.active & (dest != me) & ~go_up
    fields = FloeState._fields
    mg_up, ov1 = _pack(floes, go_up, Hm, fields)
    mg_dn, ov2 = _pack(floes, go_dn, Hm, fields)
    overflow = overflow | ov1 | ov2
    floes = floes._replace(active=floes.active & ~(go_up | go_dn))
    base = comm.rank - me * stride
    lo, hi = _neighbours(me, D, wrap)
    recv_lo, recv_hi = _swap(
        comm, mg_dn, mg_up,
        None if lo is None else base + lo * stride,
        None if hi is None else base + hi * stride, fields)
    free = ~floes.active
    fidx = first_true(free, 2 * Hm, Nl)
    for k, recv in enumerate((recv_lo, recv_hi)):
        slots = fidx[k * Hm:(k + 1) * Hm]
        ok = recv["active"] & (slots < Nl)
        overflow = overflow | torch.any(recv["active"] & (slots >= Nl))
        idx = torch.where(ok, slots, Nl)
        floes = FloeState(*(_put(a, idx, recv[f], Nl) for f, a in zip(fields, floes)))
        # only floes really received become active
        floes = floes._replace(active=_put(floes.active, idx, ok, Nl))
    return floes, overflow


def _row_cap(sim, row_cap):
    # the per-floe candidate budget of the single-device configuration, from
    # the USER pool's capacity: run_decomp snapshots it at entry, because a
    # writer puts the (larger) gathered pool into sim.model mid-run
    if row_cap is None:
        row_cap = max(sim.pair_cap // max(sim.model.floes.capacity, 1), 8)
    return row_cap


def _check_ranks(dec, D: int):
    if dec.comm.size != D:
        raise ValueError(
            f"a decomposition over {D} slabs runs as {D} ranks, one process "
            f"each; this process group has {dec.comm.size}"
        )


def _halves(sim, dec, make_halo, migrate, row_cap):
    """collide_local / finish_local of a decomposition whose halo exchange
    (``make_halo(floes, domain) -> (ext, overflow)``) and migration
    (``migrate(floes, domain, overflow) -> (floes, overflow)``) are given.
    Their overflow flags are this rank's; the callers reduce them."""
    grid = sim.model.grid
    atmos = sim.model.atmos
    consts = sim.consts
    dt = float(sim.dt)
    fs = sim.floe_settings
    cps = sim.coupling_settings
    cls = sim.collision_settings
    comm = dec.comm
    Nl = dec.local_cap
    # only the Nl local rows take candidate budget (owned_rows); seam rows
    # own their whole halo contact degree, and the second-chance list
    # (_extra_cap) takes the few deep rows, so the budget stays the
    # single-device row_cap a floe
    pair_cap = max(_row_cap(sim, row_cap) * Nl, 256)
    # the coupling and accumulation sums are float32 one-hot products on the
    # card; TF32 would keep only about three digits of them
    torch.backends.cuda.matmul.allow_tf32 = False

    def collide_local(floes, ocean, domain: Domain, tstep: int):
        ext, overflow = make_halo(floes, domain)
        stress_instant = torch.zeros_like(floes.stress_accum)
        if cls.collisions_on:
            res = _collisions.timestep_collisions(
                ext, domain, consts, dt, cls, pair_cap, sim.clip_cap, None,
                owned_rows=Nl,
            )
            # the local rows only: a halo copy's forces are its owner's, who
            # computes the seam pair too
            loc = FloeState(*(a[:Nl] for a in res.floes))
            floes = floes._replace(
                collision_force=loc.collision_force,
                collision_trq=loc.collision_trq,
                overarea=loc.overarea,
                remove=loc.remove,
                fuse_with=_fuse_with_to_ids(loc.fuse_with, ext),
            )
            stress_instant = res.stress_instant[:Nl]
            overflow = overflow | res.overflow
        domain = domain.update_boundaries(dt)
        return floes, domain, stress_instant, overflow

    def finish_local(floes, ocean, domain: Domain, stress_instant, tstep: int):
        overflow = torch.zeros((), dtype=torch.bool, device=floes.verts.device)
        if cps.coupling_on and tstep % cps.dt == 0:
            floes, ocean, cp_overflow = _coupling.timestep_coupling(
                floes, grid, domain, ocean, atmos, consts, cps, fs, dt,
                sim.cell_cap, reduce_sums=comm.ordered_sum,
            )
            overflow = overflow | cp_overflow
        floes = _update_floe.timestep_floe_properties(floes, dt, fs, stress_instant)
        floes = _update_floe.wrap_periodic(floes, domain)
        diss0 = ocean.dissolved
        floes, ocean = _simplification.remove_and_dissolve(floes, ocean, grid, domain, fs)
        ocean = ocean._replace(dissolved=diss0 + comm.ordered_sum(ocean.dissolved - diss0))
        floes, overflow = migrate(floes, domain, overflow)
        return floes, ocean, domain, overflow

    return collide_local, finish_local


def _make_parts_1d(sim, dec: Decomp, row_cap=None):
    """The rank's step of the 1-D decomposition in two halves:

      collide_local(floes, ocean, domain, tstep)
          -> (floes, domain, stress_instant, overflow)   [halo + collisions]
      finish_local(floes, ocean, domain, stress_instant, tstep)
          -> (floes, ocean, domain, overflow)  [coupling/integrate/migrate]

    as simulation.build_step_parts splits the single-device step, so that the
    host ridge/raft pass can run between them on the gathered pool."""
    D = dec.n_dev
    _check_ranks(dec, D)
    comm = dec.comm
    H, Hm, Nl = dec.halo_cap, dec.mig_cap, dec.local_cap
    me = comm.rank

    def slab(domain):
        vals = domain.vals
        Lx = vals[EAST] - vals[WEST]
        return vals[WEST], Lx, Lx / D

    def make_halo(floes, domain):
        overflow = torch.zeros((), dtype=torch.bool, device=floes.verts.device)
        # one slab holds every floe, and the broad phase's minimum-image shift
        # covers a periodic wrap: no halo, the single-device compute
        if D == 1:
            return floes, overflow
        w_val, Lx, slab_w = slab(domain)
        lo = w_val + float(me) * slab_w
        hi = lo + slab_w
        cx, r = floes.centroid[:, 0], floes.rmax
        pk_l, ov1 = _pack(floes, floes.active & (cx - r < lo + dec.margin), H, _HALO_FIELDS)
        pk_r, ov2 = _pack(floes, floes.active & (cx + r > hi - dec.margin), H, _HALO_FIELDS)
        wrap = domain.ew_periodic
        from_left, from_right = _swap(comm, pk_l, pk_r, *_neighbours(me, D, wrap),
                                      _HALO_FIELDS)
        if COMM_IDENTITY:
            from_left, from_right = _deactivated(from_left), _deactivated(from_right)
        if wrap:
            # through the periodic edge: rank 0's lower neighbour is rank
            # D-1, whose floes lie at the east edge, so they move west by Lx
            if me == 0:
                from_left = _shift_x(from_left, -Lx)
            if me == D - 1:
                from_right = _shift_x(from_right, Lx)
        ext = FloeState(*(
            torch.cat([a, b, c]) for a, b, c in zip(
                floes, _as_halo_state(floes, from_left, H),
                _as_halo_state(floes, from_right, H))
        ))
        return ext, overflow | ov1 | ov2

    def migrate(floes, domain, overflow):
        w_val, _, slab_w = slab(domain)
        return _migrate_axis(floes, comm, D, me, 1, w_val, slab_w, 0,
                             domain.ew_periodic, Hm, Nl, overflow)

    return _halves(sim, dec, make_halo, migrate, row_cap)


def _compose_parts(collide_local, finish_local):
    def local_step(floes, ocean, domain, tstep):
        floes, domain, si, ov1 = collide_local(floes, ocean, domain, tstep)
        floes, ocean, domain, ov2 = finish_local(floes, ocean, domain, si, tstep)
        return floes, ocean, domain, ov1 | ov2

    return local_step


def _dec_parts(sim, dec, row_cap=None):
    if isinstance(dec, Decomp):
        return _make_parts_1d(sim, dec, row_cap)
    return _make_parts_2d(sim, dec, row_cap)


def build_decomp_step(sim, dec, row_cap=None):
    """One decomposed step, run on every rank: (floes_d, ocean, domain,
    tstep) -> (floes_d, ocean, domain, overflow).  ``floes_d`` is this rank's
    block (``distribute``); ``overflow`` (a Python bool) is any rank's.
    ``sim`` gives the physics configuration, as for the single-device step.
    The host life cycle is not in it: ``run_decomp`` runs it on the
    gathered pool at its cadences."""
    local_step = _compose_parts(*_dec_parts(sim, dec, row_cap))

    def step(floes_d, ocean, domain, tstep: int):
        floes_d, ocean, domain, ov = local_step(floes_d, ocean, domain, int(tstep))
        return floes_d, ocean, domain, bool(dec.comm.flag_max(ov.reshape(1))[0])

    return step


def build_decomp_step_halves(sim, dec, row_cap=None):
    """The two halves of the decomposed step, for the mid-step host
    ridge/raft pass (simulation.build_step_parts' counterpart):

      collide(floes_d, ocean, domain, tstep)
          -> (floes_d, domain, stress_instant_d, overflow)
      finish(floes_d, ocean, domain, stress_instant_d, tstep)
          -> (floes_d, ocean, domain, overflow)
    """
    collide_local, finish_local = _dec_parts(sim, dec, row_cap)
    comm = dec.comm

    def collide(floes_d, ocean, domain, tstep: int):
        floes_d, domain, si, ov = collide_local(floes_d, ocean, domain, int(tstep))
        return floes_d, domain, si, bool(comm.flag_max(ov.reshape(1))[0])

    def finish(floes_d, ocean, domain, si, tstep: int):
        floes_d, ocean, domain, ov = finish_local(floes_d, ocean, domain, si, int(tstep))
        return floes_d, ocean, domain, bool(comm.flag_max(ov.reshape(1))[0])

    return collide, finish


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    parts = [_tree_map(fn, v) for v in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def _tree_cat(trees):
    """Concatenate trees of stacked per-step outputs along the step axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees]) for k in first}
    parts = [_tree_cat([t[i] for t in trees]) for i in range(len(first))]
    return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)


def build_decomp_segment(sim, dec, row_cap=None, collect=None, seg_cap=None):
    """Steps of the decomposition between two host events:

      seg(floes_d, ocean, domain, t0, t_stop)
          -> (floes_d, ocean, domain, t_reached, n_overflow, fuse[, buf])

    advances from step t0 until t_stop, or until collisions mark a fuse pair
    (the host fuse pass must run before the next step), reading the host
    once a step (overflow and fuse flags in one reduction).  ``seg_cap``,
    when given, bounds the steps of one call.

    ``collect(floes_local, ocean)`` maps each step's LOCAL pool to outputs
    that are summed over the ranks (in rank order), so they must be additive
    over floes (sums of KE, momentum, mass over active rows: a rank's pool
    holds only the floes it owns); ``buf`` stacks them, one row a step."""
    local_step = _compose_parts(*_dec_parts(sim, dec, row_cap))
    check_fuse = sim.collision_settings.collisions_on
    comm = dec.comm

    def seg(floes, ocean, domain, t0, t_stop):
        t, t_stop = int(t0), int(t_stop)
        if seg_cap is not None:
            t_stop = min(t_stop, t + seg_cap)
        n_over, fuse, rows = 0, False, []
        dev = floes.verts.device
        while t < t_stop and not fuse:
            floes, ocean, domain, ov = local_step(floes, ocean, domain, t)
            marked = (torch.any(floes.fuse_with >= 0) if check_fuse
                      else torch.zeros((), dtype=torch.bool, device=dev))
            ov, fuse = comm.flag_max(torch.stack([ov, marked]))
            fuse = bool(fuse)
            if collect is not None:
                rows.append(_tree_map(comm.ordered_sum, collect(floes, ocean)))
            n_over += ov
            t += 1
        out = (floes, ocean, domain, t, n_over, fuse)
        if collect is None:
            return out
        from ..simulation import _stack_steps

        return out + ((_stack_steps(rows) if rows else None),)

    return seg


def _dec_distribute(floes: FloeState, domain: Domain, dec, extra=None):
    if isinstance(dec, Decomp):
        return distribute(floes, domain, dec, extra=extra)
    return distribute_2d(floes, domain, dec, extra=extra)


def _dec_grow(dec):
    """The same decomposition with doubled capacities (fracture or welding
    grew a slab past local_cap)."""
    return dataclasses.replace(
        dec, local_cap=2 * dec.local_cap, halo_cap=2 * dec.halo_cap,
        mig_cap=2 * dec.mig_cap,
    )


class _NullLogger:
    """Logger stand-in for the ranks that write nothing."""

    def log(self, *a, **k):
        pass

    def warn(self, *a, **k):
        pass

    def close(self):
        pass


def run_decomp(sim, dec, start_tstep: int = 0, callback=None, collect=None):
    """``run`` over a 1-D (``Decomp``) or 2-D (``Decomp2D``) decomposition,
    called on every rank (timestep_sim!'s order of events,
    simulation.jl:94-220, as the single-device ``run`` keeps it).

    Between host events (writer intervals, life-cycle cadences) the ranks
    step through ``build_decomp_segment``, which stops early when collisions
    mark a fuse pair.  At a life-cycle cadence (ridge/raft, fracture, weld,
    smooth, fuse) every rank gathers the active rows, runs the host passes
    on that pool with the same generator (so every rank makes the same
    pieces), and takes its block of the result (``distribute``), growing the
    capacities when a slab outgrows them.  With ``sim.interleave_ridge_raft``
    (the default) ridge/raft runs between the collide and finish halves.
    Writers fire on the gathered pool, on rank 0 only.  Overflow is counted
    and warned about as the single-device ``run`` does.

    ``collect(floes_local, ocean)``: per-step outputs additive over floes,
    summed over the ranks (see build_decomp_segment); when given, returns
    ``(sim, collected)`` stacked over steps.

    Returns ``sim`` holding the final gathered pool; ``sim.n_overflow`` and
    ``sim.run_stats`` (steps, segments, seconds, host passes and their
    kernel launches, and ``comm``: this rank's messages, bytes, staging
    copies and reductions) as ``run`` sets them."""
    from ..io.logger import SimulationLogger
    from ..physics import lifecycle_host as _lifecycle
    from ..simulation import (_HostPass, _host_lifecycle_passes, _host_ridge_raft,
                              _new_run_state, _stack_steps)

    # every rank runs this loop; host passes run alike everywhere on the
    # gathered pool, and rank 0 alone writes and logs
    io_proc = is_io_process()
    logger = SimulationLogger(sim.name) if io_proc else _NullLogger()
    comm = dec.comm
    stats0 = dict(comm.stats)

    # the per-floe candidate budget, from the USER pool, before a writer puts
    # the gathered (D * local_cap) pool into sim.model
    row_cap = max(sim.pair_cap // max(sim.model.floes.capacity, 1), 8)

    def segment():
        # built on the decomposition of the moment (capacities can grow)
        return build_decomp_segment(sim, dec, row_cap, collect=collect)

    domain = sim.model.domain
    floes_d = _dec_distribute(sim.model.floes, domain, dec)
    ocean = sim.model.ocean
    rng = np.random.default_rng(sim.seed)
    if sim.rng_state is not None:
        rng.bit_generator.state = sim.rng_state
    state = _new_run_state(int(torch.max(sim.model.floes.id)))
    # the gathered pool is unsorted: the host passes' queries take the dense
    # broad phase, with the pair budget set for the gathered capacity
    host_sim = copy.copy(sim)
    host_sim.bins = None

    rr = sim.ridgeraft_settings
    rr_on = rr.ridge_raft_on and rr.dt > 0
    rr_mid_step = sim.interleave_ridge_raft and rr_on

    def host_ops_due(tstep, include_rr=True):
        if tstep <= 0:
            return False
        fr = sim.fracture_settings
        ws = sim.weld_settings
        sp = sim.simp_settings
        return (
            (include_rr and rr_on and tstep % rr.dt == 0)
            or (fr.fractures_on and fr.dt > 0 and tstep % fr.dt == 0)
            or (ws.weld_on and any(tstep % wdt == 0 for wdt in ws.dts))
            or (sp.smooth_vertices_on and sp.dt_smooth > 0
                and tstep % sp.dt_smooth == 0)
        )

    def writers_due(tstep):
        w = sim.writers
        if w is None:
            return False
        return (
            (tstep == start_tstep and w.initial_state is not None)
            or (w.floes is not None and tstep % w.floes.interval == 0)
            or (w.grid is not None and tstep % w.grid.interval == 0)
            or (w.checkpoint is not None and tstep % w.checkpoint.interval == 0)
        )

    has_collision_fusing = sim.collision_settings.collisions_on
    n_overflow = 0

    def cell_cap_needed(g) -> int:
        """The two-way coupling window the pool needs (Simulation's rule);
        welding and fusing can grow rmax past it without a slab overflowing,
        so this is checked after every host pass."""
        rmax_now = float(torch.max(torch.where(g.active, g.rmax, 0.0)))
        gr = sim.model.grid
        cap = int(2 * np.ceil(1.5 * rmax_now / min(gr.dx, gr.dy)) + 3)
        return min(cap, max(gr.Nx, gr.Ny) + 1)

    # the host pool holds the active floes with room for one fracture pass
    # (npieces a floe) and weld/ridge pieces; it only grows
    fr_np = sim.fracture_settings.npieces if sim.fracture_settings.fractures_on else 1
    headroom = fr_np + 1

    def host_cap_for(n_act, cur=0):
        want = ((headroom * n_act + 64 + 63) // 64) * 64
        return max(want, cur, 128)

    host_cap = host_cap_for(int(torch.sum(sim.model.floes.active)))

    def gather_active_grow(floes_d):
        nonlocal host_cap
        g = gather(floes_d, dec)
        host_cap = host_cap_for(int(torch.sum(g.active)), cur=host_cap)
        g, over = _compact_active(g, host_cap)
        while over:
            host_cap = 2 * host_cap
            g, over = _compact_active(g, host_cap)
        return _fuse_ids_to_rows(g)

    def redistribute(g, tstep, extra=None):
        """This rank's block of a host pool, growing the slab capacities or
        the coupling window where the pool needs it."""
        nonlocal dec
        if sim.coupling_settings.two_way_coupling_on:
            cap = cell_cap_needed(g)
            if cap > sim.cell_cap:
                sim.cell_cap = cap
                logger.warn(
                    f"floe growth outran the two-way coupling window: "
                    f"growing cell_cap to {cap}",
                    tstep,
                )
        try:
            return _dec_distribute(g, domain, dec, extra=extra)
        except ValueError:
            # a slab outgrew local_cap (every rank sees it on the same pool)
            dec = _dec_grow(dec)
            logger.warn(
                f"slab overflow: growing local_cap to {dec.local_cap}", tstep,
            )
            return _dec_distribute(g, domain, dec, extra=extra)

    use_segments = callback is None
    pre_cads = []   # host needed BEFORE the step at multiples of these
    post_cads = []  # host needed AFTER the step at multiples of these
    if use_segments:
        if sim.writers is not None:
            for w in (sim.writers.floes, sim.writers.grid, sim.writers.checkpoint):
                if w is not None:
                    pre_cads.append(w.interval)
        if sim.verbose:
            pre_cads.append(50)
        if rr_mid_step:
            pre_cads.append(rr.dt)
        elif rr_on:
            post_cads.append(rr.dt)
        fr = sim.fracture_settings
        if fr.fractures_on and fr.dt > 0:
            post_cads.append(fr.dt)
        if sim.weld_settings.weld_on:
            post_cads.extend(sim.weld_settings.dts)
        if sim.simp_settings.smooth_vertices_on and sim.simp_settings.dt_smooth > 0:
            post_cads.append(sim.simp_settings.dt_smooth)

    def next_on(t, c, skip_zero):
        s = ((t + c - 1) // c) * c
        return c if (skip_zero and s == 0) else s

    collected = []
    n_segments = 0
    t_start = time.perf_counter()
    launches0 = _two_cross.launch_count()
    end_tstep = start_tstep + sim.n_dt
    tstep = start_tstep
    while tstep <= end_tstep:
        if use_segments:
            t_stop = end_tstep + 1
            for c in pre_cads:
                t_stop = min(t_stop, next_on(tstep, c, skip_zero=False))
            for c in post_cads:
                t_stop = min(t_stop, next_on(tstep, c, skip_zero=True))
            if t_stop > tstep:
                n_segments += 1
                out = segment()(floes_d, ocean, domain, tstep, t_stop)
                floes_d, ocean, domain, t_dev, nov, fuse = out[:6]
                seg_len = t_dev - tstep
                tstep = t_dev
                if collect is not None and seg_len > 0:
                    collected.append(out[6])
                if nov:
                    n_overflow += nov
                    logger.warn(
                        f"halo/migration/pair capacity exceeded on {nov} of "
                        f"the last {seg_len} steps; results may be incomplete",
                        tstep - 1,
                    )
                if fuse and has_collision_fusing:
                    # same-step fusing: the host fuse pass runs before the
                    # next step (collisions.jl:364-368)
                    g = gather_active_grow(floes_d)
                    with _HostPass(state, "fuse"):
                        g, state["max_floe_id"] = _lifecycle.fuse_floes(
                            g, state["max_floe_id"], sim.floe_settings,
                            float(sim.dt), rng,
                        )
                    floes_d = redistribute(g, tstep)
                continue  # tstep is now on a host event (or past the end)
        if sim.verbose and tstep % 50 == 0 and io_proc:
            print(f"{tstep} timesteps")
        if callback is not None or writers_due(tstep):
            # the gather is a collective: every rank takes part, rank 0 writes
            g = gather(floes_d, dec)
            if callback is not None:
                callback(tstep, g, ocean, domain)
            if writers_due(tstep) and io_proc:
                sim.model = sim.model.replace(floes=g, ocean=ocean, domain=domain)
                sim.writers.write_data(
                    sim, tstep, g, ocean, domain,
                    rng_state=rng.bit_generator.state,
                )
        rr_now = rr_mid_step and tstep % rr.dt == 0 and tstep > 0
        if rr_now:
            # mid-step: collisions -> ridge/raft -> coupling/integration
            # (simulation.jl:108-135); the whole pool is gathered row for
            # row, the pass changes it in place, and the per-floe stress rows
            # are placed with it (pieces made mid-step carry zero stress, as
            # in the single-device run)
            collide_d, _ = build_decomp_step_halves(sim, dec, row_cap)
            floes_d, domain, si_d, ov1 = collide_d(floes_d, ocean, domain, tstep)
            g = gather(floes_d, dec)
            si = comm.gather_tree(si_d)
            host_sim.pair_cap = row_cap * g.capacity
            g = _host_ridge_raft(host_sim, g, domain, tstep, rng, state, logger)
            floes_d, si_d = redistribute(g, tstep, extra=si)
            _, finish_d = build_decomp_step_halves(sim, dec, row_cap)  # dec may have grown
            floes_d, ocean, domain, ov2 = finish_d(floes_d, ocean, domain, si_d, tstep)
            overflow = ov1 or ov2
            marked = has_collision_fusing and bool(comm.flag_max(
                torch.any(floes_d.fuse_with >= 0).reshape(1))[0])
            if collect is not None:
                collected.append(_stack_steps(
                    [_tree_map(comm.ordered_sum, collect(floes_d, ocean))]))
        else:
            # the event's step: a segment of one step
            out = segment()(floes_d, ocean, domain, tstep, tstep + 1)
            floes_d, ocean, domain, _, nov, marked = out[:6]
            overflow = nov > 0
            if collect is not None:
                collected.append(out[6])
        if overflow:
            n_overflow += 1
            logger.warn(
                "halo/migration/pair capacity exceeded; results may be "
                "incomplete this step",
                tstep,
            )
        need_host = host_ops_due(tstep, include_rr=not rr_now) or (
            has_collision_fusing and marked
        )
        if need_host:
            g = gather_active_grow(floes_d)
            host_sim.pair_cap = row_cap * g.capacity
            g = _host_lifecycle_passes(
                host_sim, g, domain, tstep, rng, state, logger,
                skip_ridge_raft=rr_now,
            )
            floes_d = redistribute(g, tstep)
        tstep += 1
    n_overflow += state["n_overflow"]
    sim.n_overflow = n_overflow
    if n_overflow and io_proc:
        warnings.warn(
            f"{n_overflow} steps exceeded a decomposition capacity; results "
            "may be inaccurate. Increase halo/mig/pair caps."
        )
    if sim.writers is not None and io_proc:
        sim.writers.close()
    logger.close()
    sim.model = sim.model.replace(floes=gather(floes_d, dec), ocean=ocean, domain=domain)
    sim.run_stats = {
        "steps": end_tstep - start_tstep + 1,
        "segments": n_segments,
        "seconds": time.perf_counter() - t_start,
        "kernel_launches": _two_cross.launch_count() - launches0,
        "host_pass_seconds": state["seconds"],
        "host_pass_count": state["passes"],
        "host_pass_launches": state["launches"],
        "rng_state": rng.bit_generator.state,
        "max_floe_id": state["max_floe_id"],
        "local_cap": dec.local_cap,
        "comm": {k: comm.stats[k] - stats0[k] for k in comm.stats},
    }
    if collect is not None:
        return sim, (_tree_cat(collected) if collected else None)
    return sim


def time_decomp_steps(sim, dec, n_steps: int, segment: bool = False):
    """Steps/s of the decomposed step on ``dec`` from ``sim``'s state, on
    every rank of ``dec``: one step first (warm-up), then ``n_steps`` timed
    ones.  ``segment=True`` times ``build_decomp_segment`` (what
    ``run_decomp`` runs; a fuse mark can end it early) instead of
    ``build_decomp_step``.  Returns (steps/s, the timed steps, this rank's
    ``Comm.stats`` change over the timed steps)."""
    m = sim.model
    floes_d = _dec_distribute(m.floes, m.domain, dec)
    ocean, domain = m.ocean, m.domain
    dev = dec.comm.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if segment:
        seg = build_decomp_segment(sim, dec)
        floes_d, ocean, domain = seg(floes_d, ocean, domain, 0, 1)[:3]
        sync()
        stats0 = dict(dec.comm.stats)
        t0 = time.perf_counter()
        out = seg(floes_d, ocean, domain, 1, 1 + n_steps)
        sync()
        done = max(out[3] - 1, 1)
    else:
        step = build_decomp_step(sim, dec)
        floes_d, ocean, domain, _ = step(floes_d, ocean, domain, 0)
        sync()
        stats0 = dict(dec.comm.stats)
        t0 = time.perf_counter()
        for k in range(1, n_steps + 1):
            floes_d, ocean, domain, _ = step(floes_d, ocean, domain, k)
        sync()
        done = n_steps
    sps = done / (time.perf_counter() - t0)
    return sps, done, {k: dec.comm.stats[k] - stats0[k] for k in stats0}


def measure_decomp_scaling(
    sim_builder, n_steps: int = 20, axis: str = "x", n_dev=None,
    segment: bool = False,
):
    """Steps/s of the decomposed step on 1 rank against ``n_dev`` ranks, on
    every rank of the default group.

    ``sim_builder()`` must return a fresh Simulation (a decomposition changes
    capacities).  ``n_dev``: None -> 1-D over every rank; an int -> 1-D over
    that many x-slabs (the group's size); an (Dx, Dy) tuple -> 2-D slabs.
    The 1-slab case runs on rank 0 alone, through a one-rank subgroup, while
    the others wait.  ``segment=True`` times ``build_decomp_segment`` (what
    ``run_decomp`` runs) instead of ``build_decomp_step``
    (``time_decomp_steps``).

    Returns, on every rank, rank 0's {1: sps, n_dev: sps, "efficiency": e},
    e = sps_D / sps_1 (the same problem, strong scaling; ranks that share a
    card share its time)."""
    ranked = dist.is_initialized()
    rank = dist.get_rank() if ranked else 0
    if n_dev is None:
        n_dev = dist.get_world_size() if ranked else 1
    one = dist.new_group([0]) if ranked else None

    res = {}
    for nd in (1, n_dev):
        if nd == 1 and rank != 0:
            continue
        sim = sim_builder()
        m = sim.model
        group = one if nd == 1 else None
        if isinstance(nd, tuple):
            dec = make_decomp_2d(m.floes, m.domain, n_dev=nd, group=group)
        else:
            dec = make_decomp(m.floes, m.domain, n_devices=nd, axis=axis, group=group)
        res[nd] = time_decomp_steps(sim, dec, n_steps, segment)[0]
    if ranked:  # every rank returns rank 0's figures
        got = [res]
        dist.broadcast_object_list(got, src=0)
        res = got[0]
    res["efficiency"] = res[n_dev] / res[1]
    return res


# ---------------------------------------------------------------------------
# 2-D (x, y) domain decomposition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decomp2D:
    """Static 2-D decomposition parameters: Dx x Dy rectangular slabs, rank r
    owning slab (r // Dy, r % Dy) (the JAX mesh's row-major layout).  The halo
    exchange runs along x, then along y over the x-extended pool, which
    reaches the corner neighbours with four messages instead of eight."""

    comm: Comm
    dx_dev: int
    dy_dev: int
    local_cap: int
    halo_cap: int
    mig_cap: int
    margin: float


def make_decomp_2d(
    floes: FloeState,
    domain: Domain,
    n_dev=(2, 2),
    local_cap: Optional[int] = None,
    halo_cap: Optional[int] = None,
    mig_cap: Optional[int] = None,
    margin: Optional[float] = None,
    group=None,
) -> Decomp2D:
    """Capacities of a (Dx, Dy) slab decomposition (the JAX package's
    rules)."""
    Dx, Dy = n_dev
    comm = _comm_for(floes, group)
    act = _host(floes.active)
    cx = _host(floes.centroid[:, 0])[act]
    cy = _host(floes.centroid[:, 1])[act]
    rmax = _host(floes.rmax)[act]
    vals = _host(domain.vals).astype(float)
    w, e = vals[WEST], vals[EAST]
    s, n = vals[SOUTH], vals[NORTH]
    slab_x = (e - w) / Dx
    slab_y = (n - s) / Dy
    if margin is None:
        margin = float(2.2 * rmax.max()) if rmax.size else min(slab_x, slab_y) / 4
        # clamp the default so tiny pools work on any layout (see make_decomp)
        margin = min(margin, float(min(slab_x, slab_y)))
    if margin > min(slab_x, slab_y):
        raise ValueError(
            f"halo margin {margin:.3g} exceeds slab size "
            f"({slab_x:.3g} x {slab_y:.3g}); use fewer devices or smaller floes"
        )
    ix = np.clip(((cx - w) / slab_x).astype(int), 0, Dx - 1)
    iy = np.clip(((cy - s) / slab_y).astype(int), 0, Dy - 1)
    occ = np.bincount(ix * Dy + iy, minlength=Dx * Dy)
    if local_cap is None:
        local_cap = int(max(2 * occ.max() + 8, 16))
    if halo_cap is None:
        near = 0
        for d in range(Dx * Dy):
            lo_x = w + (d // Dy) * slab_x
            lo_y = s + (d % Dy) * slab_y
            m = (ix * Dy + iy == d) & (
                (cx - rmax < lo_x + margin)
                | (cx + rmax > lo_x + slab_x - margin)
                | (cy - rmax < lo_y + margin)
                | (cy + rmax > lo_y + slab_y - margin)
            )
            near = max(near, int(m.sum()))
        halo_cap = int(max(2 * near + 8, 8))
    if mig_cap is None:
        mig_cap = int(max(local_cap // 8, 8))
    return Decomp2D(
        comm=comm, dx_dev=Dx, dy_dev=Dy, local_cap=local_cap,
        halo_cap=halo_cap, mig_cap=mig_cap, margin=float(margin),
    )


def _slabs_2d(floes, domain, Dx, Dy):
    vals = _host(domain.vals).astype(float)
    w, e = vals[WEST], vals[EAST]
    s, n = vals[SOUTH], vals[NORTH]
    c = _host(floes.centroid)
    ix = np.clip(((c[:, 0] - w) / ((e - w) / Dx)).astype(int), 0, Dx - 1)
    iy = np.clip(((c[:, 1] - s) / ((n - s) / Dy)).astype(int), 0, Dy - 1)
    return ix * Dy + iy


def distribute_2d(floes: FloeState, domain: Domain, dec: Decomp2D, extra=None):
    """This rank's block of a global pool over 2-D slabs: rank r holds slab
    (r // Dy, r % Dy), row block r of the JAX package's pool.  ``extra``:
    see ``distribute``."""
    n_slabs = dec.dx_dev * dec.dy_dev
    rows = _slab_rows(_slabs_2d(floes, domain, dec.dx_dev, dec.dy_dev),
                      _host(floes.active), n_slabs, dec.local_cap)[dec.comm.rank]
    out = _place(rows, dec.local_cap, floes, dec.comm.device)
    if extra is None:
        return out
    return out, _place(rows, dec.local_cap, extra, dec.comm.device)


def build_decomp_step_2d(sim, dec: Decomp2D):
    """One decomposed step over 2-D slabs (``build_decomp_step``'s contract)."""
    return build_decomp_step(sim, dec)


def _make_parts_2d(sim, dec: Decomp2D, row_cap=None):
    """collide_local / finish_local of the 2-D slab step: the 1-D pipeline,
    with the halo exchange and the migration in two axis passes (x, then y
    over the x-extended pool: ``ext_cap = local_cap + 4 * halo_cap``)."""
    Dx, Dy = dec.dx_dev, dec.dy_dev
    _check_ranks(dec, Dx * Dy)
    comm = dec.comm
    H, Hm, Nl = dec.halo_cap, dec.mig_cap, dec.local_cap
    me_x, me_y = divmod(comm.rank, Dy)

    def geometry(domain):
        vals = domain.vals
        w, s = vals[WEST], vals[SOUTH]
        Lx, Ly = vals[EAST] - w, vals[NORTH] - s
        return w, s, Lx, Ly, Lx / Dx, Ly / Dy

    def halo_axis(floes, D, me, stride, lo, hi, L, wrap, coord):
        """Exchange edge floes along one axis: returns the packed dicts from
        the lower and the upper neighbour, and the overflow flag."""
        c = floes.centroid[:, coord]
        r = floes.rmax
        pk_lo, ov1 = _pack(floes, floes.active & (c - r < lo + dec.margin), H, _HALO_FIELDS)
        pk_hi, ov2 = _pack(floes, floes.active & (c + r > hi - dec.margin), H, _HALO_FIELDS)
        base = comm.rank - me * stride
        nlo, nhi = _neighbours(me, D, wrap)
        from_lo, from_hi = _swap(
            comm, pk_lo, pk_hi,
            None if nlo is None else base + nlo * stride,
            None if nhi is None else base + nhi * stride, _HALO_FIELDS)
        if COMM_IDENTITY:
            from_lo, from_hi = _deactivated(from_lo), _deactivated(from_hi)
        if wrap:
            shift = (lambda d, v: _shift_xy(d, v, 0.0)) if coord == 0 else (
                lambda d, v: _shift_xy(d, 0.0, v))
            if me == 0:
                from_lo = shift(from_lo, -L)
            if me == D - 1:
                from_hi = shift(from_hi, L)
        return from_lo, from_hi, ov1 | ov2

    def extend(pool, template, from_lo, from_hi):
        return FloeState(*(
            torch.cat([a, b, c]) for a, b, c in zip(
                pool, _as_halo_state(template, from_lo, H),
                _as_halo_state(template, from_hi, H))
        ))

    def make_halo(floes, domain):
        overflow = torch.zeros((), dtype=torch.bool, device=floes.verts.device)
        w, s, Lx, Ly, slab_x, slab_y = geometry(domain)
        lo_x = w + float(me_x) * slab_x
        lo_y = s + float(me_y) * slab_y
        # an axis of one slab needs no halo (the minimum-image shift covers
        # its wrap)
        ext = floes
        if Dx > 1:
            rl, rh, ov = halo_axis(floes, Dx, me_x, Dy, lo_x, lo_x + slab_x, Lx,
                                   domain.ew_periodic, 0)
            overflow = overflow | ov
            ext = extend(floes, floes, rl, rh)
        if Dy > 1:
            rd, ru, ov = halo_axis(ext, Dy, me_y, 1, lo_y, lo_y + slab_y, Ly,
                                   domain.ns_periodic, 1)
            overflow = overflow | ov
            ext = extend(ext, floes, rd, ru)
        return ext, overflow

    def migrate(floes, domain, overflow):
        w, s, _, _, slab_x, slab_y = geometry(domain)
        floes, overflow = _migrate_axis(floes, comm, Dx, me_x, Dy, w, slab_x, 0,
                                        domain.ew_periodic, Hm, Nl, overflow)
        return _migrate_axis(floes, comm, Dy, me_y, 1, s, slab_y, 1,
                             domain.ns_periodic, Hm, Nl, overflow)

    return _halves(sim, dec, make_halo, migrate, row_cap)
