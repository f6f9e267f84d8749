"""Collisions: floe-floe, floe-wall, floe-topography contact forces.

Port of ``subzero_tpu/physics/collisions.py``: the dense and the binned
broad phase, the step's ``timestep_collisions``, and the host passes'
``pair_overlaps`` / ``pair_interactions``.  Same physics and the same
capacities and overflow flags as the reference:

  * periodic wrap is a minimum-image shift carried on each candidate pair;
  * each unordered pair is computed once and +F/-F land on both floes;
  * floes, the four walls and topography form one "Q pool" that every
    candidate pair indexes;
  * the fused two-crossing narrow phase (``two_cross_dispatch``: the CUDA
    kernel on the card) handles the common contacts, and the general region
    clip the few multi-region or degenerate ones, with an odd-parity retry;
  * Hopkins elastic + Coulomb friction forces (collisions.jl:30-283; the
    force law, ``_force_law``: one CUDA kernel on the card,
    ``physics/forces.py``) are accumulated into per-floe force, torque,
    stress moments and overlap.

Accumulations are deterministic: row-structured reshape sums, segment sums
over stably sorted rows, or writes to distinct indices - never float
atomics, whose order changes between runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import Constants
from ..core.domain import (
    BoundaryKind,
    Domain,
    EAST,
    NORTH,
    SOUTH,
    WEST,
    wall_rect,
)
from ..core.floes import FloeState
from ..geometry.clip import (
    ClipRegions,
    DEFAULT_CAP,
    first_true,
    two_cross_dispatch,
)
from ..geometry.regions import intersect_regions_dispatch
from ..settings import CollisionSettings
from .forces import ContactSides, ForceLaw, force_law_cuda

# rows of the slow path's parity retry
RETRY_CAP = 16
D_SPILL = 8


class PairArrays(NamedTuple):
    qi: torch.Tensor        # [PC] floe index i (P side)
    qj: torch.Tensor        # [PC] Q-pool index
    shift: torch.Tensor     # [PC, 2] translation applied to Q (periodic image)
    valid: torch.Tensor     # [PC]
    overflow: torch.Tensor  # [] bool: more candidates than capacity
    # [2] int64 of the binned broad phase (None on the dense one): the slot
    # tests it made and its fullest bin's floes (``_bin_counts``)
    bin_counts: torch.Tensor | None = None


def _sq(x):
    return x * x


def find_candidate_pairs(
    floes: FloeState, domain: Domain, pair_cap: int, bins: tuple | None = None,
    owned_rows: int | None = None,
) -> PairArrays:
    """Broad phase: bounding-circle tests over all i<j pairs plus walls and
    topography (potential_interaction, collisions.jl:705-710), with the
    minimum-image periodic fold.

    ``bins``: optional static (nbx, nby, M) spatial binning parameters - when
    given, floe-floe candidates come from the bin neighbourhoods of a
    spatial bin grid (O(N * M) instead of O(N^2)); M is the per-bin floe
    capacity.

    ``owned_rows``: when the pool is a rank's local block extended with halo
    copies (parallel/decomp.py), rows >= owned_rows are halos: pairs of two
    halo copies are a neighbour's and are skipped, a local-halo pair is
    owned by the local row, and halo rows take no wall or topography
    candidate, so only the owned rows hold candidates and take the budget.
    None = every row owned.  The binned broad phase takes a single pool
    only."""
    if bins is not None:
        if owned_rows is not None:
            raise ValueError("the binned broad phase is single-pool only "
                             "(owned_rows needs the dense broad phase)")
        return _find_candidate_pairs_binned(floes, domain, pair_cap, bins)
    return _find_candidate_pairs_dense(floes, domain, pair_cap, owned_rows)


def _rank_select_rows(mask, row_cap: int, extra_cap: int = 0):
    """Per-row compaction of a boolean [N, C] candidate matrix: sel[i, k] =
    column of the (k+1)-th True in row i (or C if the row has fewer).

    ``extra_cap`` > 0 also compacts up to D_SPILL candidates per row that
    did not fit their row into a global second-chance list of extra_cap
    flat positions (N*C when unused); overflow fires only when even that
    list truncates.  One top-k over the row keys yields both the row slots
    and the spill columns.

    Returns (sel [N, row_cap], valid [N, row_cap], overflow [], extra_pos
    [extra_cap])."""
    N, C = mask.shape
    dev = mask.device
    col = torch.arange(C, device=dev)
    row_tot = mask.sum(1)
    depth = row_cap + (D_SPILL if extra_cap > 0 else 0)
    # key > 0 iff candidate; larger key = smaller column index
    key = torch.where(mask, C - col, 0)
    if depth > C:
        key = torch.cat([key, key.new_zeros((N, depth - C))], dim=1)
    topv = torch.topk(key, depth, dim=1, sorted=True).values
    cols = torch.where(topv > 0, C - topv, C)
    sel = cols[:, :row_cap]
    valid = sel < C
    if extra_cap > 0:
        spill = torch.clamp(row_tot - row_cap, min=0)
        n_drop = torch.clamp(spill, max=D_SPILL).sum()
        overflow = (n_drop > extra_cap) | torch.any(row_tot > row_cap + D_SPILL)
        dvalid = torch.arange(D_SPILL, device=dev)[None, :] < spill[:, None]
        flat = torch.where(
            dvalid,
            torch.arange(N, device=dev)[:, None] * C + cols[:, row_cap:],
            N * C,
        ).reshape(-1)
        esel = first_true(flat < N * C, extra_cap, N * D_SPILL)
        extra_pos = torch.where(
            esel < N * D_SPILL, flat[torch.clamp(esel, max=N * D_SPILL - 1)],
            N * C,
        )
    else:
        overflow = torch.any(row_tot > row_cap)
        extra_pos = torch.full((0,), N * C, dtype=torch.int64, device=dev)
    return sel, valid, overflow, extra_pos


def _extra_cap(N: int) -> int:
    """Second-chance list capacity (PC = N * row_cap + _extra_cap(N))."""
    return max(N // 2, 64)


def _wall_topo_masks(floes: FloeState, domain: Domain):
    """Wall [N, 4] and topography [N, T] candidate masks."""
    c = floes.centroid
    r = floes.rmax
    act = floes.active
    vals = domain.vals
    # a wall that exerts no force keeps no candidate; the kinds are static
    # Python config, so its column is zeros and no mask of kinds is uploaded
    beyond = (
        lambda: c[:, 1] + r > vals[NORTH],
        lambda: c[:, 1] - r < vals[SOUTH],
        lambda: c[:, 0] + r > vals[EAST],
        lambda: c[:, 0] - r < vals[WEST],
    )
    none = torch.zeros_like(act)
    fw = torch.stack(
        [
            act & beyond[w]()
            if domain.kinds[w] in (BoundaryKind.COLLISION, BoundaryKind.MOVING)
            else none
            for w in range(4)
        ],
        dim=1,
    )
    T = domain.topography.count
    if T > 0:
        tc = domain.topography.centroid
        tr = domain.topography.rmax
        dt_ = c[:, None, :] - tc[None, :, :]
        ft = act[:, None] & (
            torch.sum(dt_ * dt_, dim=-1) < _sq(r[:, None] + tr[None, :])
        )
    else:
        ft = torch.zeros((floes.capacity, 0), dtype=torch.bool, device=c.device)
    return fw, ft


def _find_candidate_pairs_dense(
    floes: FloeState, domain: Domain, pair_cap: int,
    owned_rows: int | None = None,
) -> PairArrays:
    N = floes.capacity
    c = floes.centroid
    r = floes.rmax
    act = floes.active
    dev = c.device
    vals = domain.vals
    Lx = vals[EAST] - vals[WEST]
    Ly = vals[NORTH] - vals[SOUTH]

    # floe-floe: [N, N] with min-image fold
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    sx = torch.zeros_like(dx)
    sy = torch.zeros_like(dy)
    if domain.ew_periodic:
        sx = torch.where(torch.abs(dx) > Lx / 2, torch.sign(dx) * Lx, 0.0)
        dx = dx - sx
    if domain.ns_periodic:
        sy = torch.where(torch.abs(dy) > Ly / 2, torch.sign(dy) * Ly, 0.0)
        dy = dy - sy
    dist2 = dx * dx + dy * dy
    rsum = r[:, None] + r[None, :]
    iidx = torch.arange(N, device=dev)
    # balanced pair ownership: each unordered pair is computed exactly once,
    # assigned to i or j by (i+j) parity so per-row candidate counts stay
    # near deg/2
    lt = iidx[:, None] < iidx[None, :]
    even = ((iidx[:, None] + iidx[None, :]) % 2) == 0
    own = (even == lt) & (iidx[:, None] != iidx[None, :])
    if owned_rows is not None:
        # extended pool of a rank: halo-halo pairs are skipped (the rank
        # that owns both computes them), a local-halo pair is the local row's
        loc_i = iidx[:, None] < owned_rows
        loc_j = iidx[None, :] < owned_rows
        own = torch.where(loc_i & loc_j, own, loc_i & ~loc_j)
    pair_mask = act[:, None] & act[None, :] & (dist2 < _sq(rsum)) & own

    fw, ft = _wall_topo_masks(floes, domain)
    if owned_rows is not None:
        # halo copies take no wall or topography contact (the owner does)
        loc_rows = (iidx < owned_rows)[:, None]
        fw = fw & loc_rows
        ft = ft & loc_rows
    T = domain.topography.count
    # the row-structured list covers the NR owned rows (all N by default)
    NR = N if owned_rows is None else owned_rows
    mask = torch.cat([pair_mask, fw, ft], dim=1)[:NR]
    NQ = N + 4 + T
    row_cap = max(min(pair_cap // max(NR, 1), NQ), 8)
    sel, valid, overflow, epos = _rank_select_rows(
        mask, row_cap, extra_cap=_extra_cap(N)
    )

    qi = iidx[:NR, None].expand(NR, row_cap).reshape(-1)
    qj = torch.clamp(sel, max=NQ - 1)
    jsafe = torch.clamp(qj, max=N - 1)
    is_ff = (qj < N).reshape(-1)
    sxg = torch.gather(sx[:NR], 1, jsafe).reshape(-1)
    syg = torch.gather(sy[:NR], 1, jsafe).reshape(-1)
    shift = torch.where(is_ff[:, None], torch.stack([sxg, syg], dim=-1), 0.0)

    # second-chance block: flat positions into [NR, NQ]
    evalid = epos < NR * NQ
    eps_ = torch.clamp(epos, max=NR * NQ - 1)
    ei = torch.where(evalid, eps_ // NQ, N - 1)
    ecol = torch.where(evalid, eps_ % NQ, N - 1)
    ejsafe = torch.clamp(ecol, max=N - 1)
    esx = sx.reshape(-1)[ei * N + ejsafe]
    esy = sy.reshape(-1)[ei * N + ejsafe]
    eshift = torch.where(
        ((ecol < N) & evalid)[:, None], torch.stack([esx, esy], dim=-1), 0.0
    )
    return PairArrays(
        qi=torch.cat([qi, ei]),
        qj=torch.cat([qj.reshape(-1), torch.clamp(ecol, max=NQ - 1)]),
        shift=torch.cat([shift, eshift], dim=0),
        valid=torch.cat([valid.reshape(-1), evalid]),
        overflow=overflow,
    )


def _find_candidate_pairs_binned(
    floes: FloeState, domain: Domain, pair_cap: int, bins: tuple
) -> PairArrays:
    """O(N*M) broad phase: floes sorted into an (nbx, nby) spatial bin grid;
    candidates come from each floe's bin neighbourhood (wrapping through
    periodic boundaries).  Requires bin size >= 2*max(rmax), which the
    Simulation guarantees when choosing (nbx, nby); the overflow
    flag fires when floes outgrow it or a bin holds more than M floes.
    Same candidate order as the reference, element for element."""
    nbx, nby, M = bins
    N = floes.capacity
    c = floes.centroid
    r = floes.rmax
    act = floes.active
    dev = c.device
    vals = domain.vals
    w_val = vals[WEST]
    s_val = vals[SOUTH]
    Lx = vals[EAST] - w_val
    Ly = vals[NORTH] - s_val
    bx = Lx / nbx
    by = Ly / nby

    ibx = torch.clamp(torch.floor((c[:, 0] - w_val) / bx).long(), 0, nbx - 1)
    iby = torch.clamp(torch.floor((c[:, 1] - s_val) / by).long(), 0, nby - 1)
    NB = nbx * nby
    bin_id = torch.where(act, ibx * nby + iby, NB)
    # per-bin member lists: a stable sort on the bin id (members keep pool
    # order inside a bin, inactive floes sort last), then each bin's
    # contiguous run gathered into its [M] row
    order = torch.argsort(bin_id, stable=True)
    # (a scatter of ones, not bincount, which reads its input's maximum on
    # the host on the card)
    counts = torch.zeros(NB + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, bin_id, torch.ones_like(bin_id))[:NB]
    start = torch.cumsum(counts, 0) - counts
    kk = torch.arange(M, device=dev)
    mem_valid = kk[None, :] < counts[:, None]                    # [NB, M]
    flat = start[:, None] + kk[None, :]
    jt = torch.where(mem_valid, order[torch.clamp(flat, max=N - 1)], N)
    bin_overflow = torch.any(counts > M)

    # Neighbour bins: a forward half-shell (self + E, NE, N, NW) instead of
    # the full 3x3, so every floe-floe pair is enumerated by exactly one
    # side.  Same-bin pairs keep the (i+j)-parity rule; cross-bin pairs
    # belong to the floe whose bin sees the other in its forward set.
    # Degenerate grids where the periodic wrap would collide a forward
    # offset with a backward one (nbx or nby < 3) fall back to the full
    # 3x3 with parity everywhere.
    half_shell = (nbx >= 3 or not domain.ew_periodic) and (
        nby >= 3 or not domain.ns_periodic
    )
    if half_shell:
        d_off = ((0, 0), (1, 0), (1, 1), (0, 1), (-1, 1))
    else:
        d_off = ((0, 0), (1, 0), (1, 1), (0, 1), (-1, 1),
                 (-1, 0), (-1, -1), (0, -1), (1, -1))
    NK = len(d_off)
    # (offsets and ownership are static Python config: built from scalars
    # on the device, nothing is uploaded)
    nx_idx = torch.stack([ibx + o[0] for o in d_off], dim=1)     # [N, NK]
    ny_idx = torch.stack([iby + o[1] for o in d_off], dim=1)
    if domain.ew_periodic:
        nx_ok = torch.ones_like(nx_idx, dtype=torch.bool)
        nx_idx = torch.remainder(nx_idx, nbx)
    else:
        nx_ok = (nx_idx >= 0) & (nx_idx < nbx)
        nx_idx = torch.clamp(nx_idx, 0, nbx - 1)
    if domain.ns_periodic:
        ny_ok = torch.ones_like(ny_idx, dtype=torch.bool)
        ny_idx = torch.remainder(ny_idx, nby)
    else:
        ny_ok = (ny_idx >= 0) & (ny_idx < nby)
        ny_idx = torch.clamp(ny_idx, 0, nby - 1)
    nb_id = nx_idx * nby + ny_idx                                # [N, NK]
    nb_ok = nx_ok & ny_ok
    bin_counts = _bin_counts(counts, M, nb_id, nb_ok, act)

    # candidates: the members of the neighbour bins, gathered directly
    jg = jt[nb_id]                                               # [N, NK, M]
    slot_ok = jg < N
    j_cand = torch.clamp(jg, max=N - 1)
    cx_cand = c[:, 0][j_cand]
    cy_cand = c[:, 1][j_cand]
    r_cand = torch.where(slot_ok, r[j_cand], 0.0)
    iidx = torch.arange(N, device=dev)[:, None, None]

    # min-image fold + circle test (identical physics to the dense path)
    dx = c[:, 0][:, None, None] - cx_cand
    dy = c[:, 1][:, None, None] - cy_cand
    sx = torch.zeros_like(dx)
    sy = torch.zeros_like(dy)
    if domain.ew_periodic:
        sx = torch.where(torch.abs(dx) > Lx / 2, torch.sign(dx) * Lx, 0.0)
        dx = dx - sx
    if domain.ns_periodic:
        sy = torch.where(torch.abs(dy) > Ly / 2, torch.sign(dy) * Ly, 0.0)
        dy = dy - sy
    rsum = r[:, None, None] + r_cand
    own = (((iidx + j_cand) % 2) == 0) == (iidx < j_cand)
    if half_shell:  # every forward neighbour bin (k > 0) is owned outright
        own = own | (torch.arange(NK, device=dev) > 0)[None, :, None]
    mask = (
        nb_ok[:, :, None]
        & slot_ok
        & act[:, None, None]
        # members are active by construction (inactive bin_id -> NB)
        & own
        & (iidx != j_cand)
        & (dx * dx + dy * dy < rsum * rsum)
    )

    # the neighbourhoods only capture pairs within one bin length: flag if
    # floes have grown (fuse/weld) beyond the bin-size guarantee
    rmax_ok = 2.0 * torch.amax(torch.where(act, r, 0.0)) <= torch.minimum(bx, by)
    bin_overflow = bin_overflow | ~rmax_ok

    fw, ft = _wall_topo_masks(floes, domain)
    T = domain.topography.count

    # unified candidate matrix: [N, NK*M | 4 walls | T topo]
    CFF = NK * M
    C2 = CFF + 4 + T
    full_mask = torch.cat([mask.reshape(N, CFF), fw, ft], dim=1)
    row_cap = max(min(pair_cap // max(N, 1), C2), 8)
    sel, valid, sel_overflow, epos = _rank_select_rows(
        full_mask, row_cap, extra_cap=_extra_cap(N)
    )
    overflow = bin_overflow | sel_overflow

    is_ff = sel < CFF
    selg = torch.clamp(sel, max=CFF + 3 + T)
    sel_ff = torch.clamp(selg, max=CFF - 1)
    # ff columns map through j_cand; wall/topo columns map to pool slots
    jc = j_cand.reshape(N, CFF)
    j_ff = torch.gather(jc, 1, sel_ff)
    j_other = N + torch.clamp(selg - CFF, min=0)
    qj = torch.where(is_ff, j_ff, j_other).reshape(-1)
    qi = torch.arange(N, device=dev)[:, None].expand(N, row_cap).reshape(-1)
    sxg = torch.gather(sx.reshape(N, CFF), 1, sel_ff).reshape(-1)
    syg = torch.gather(sy.reshape(N, CFF), 1, sel_ff).reshape(-1)
    shift = torch.where(
        is_ff.reshape(-1)[:, None], torch.stack([sxg, syg], dim=-1), 0.0
    )

    # second-chance block: flat positions into [N, C2]
    evalid = epos < N * C2
    eps_ = torch.clamp(epos, max=N * C2 - 1)
    ei = torch.where(evalid, eps_ // C2, N - 1)
    ecol = torch.where(evalid, eps_ % C2, 0)
    e_is_ff = ecol < CFF
    eflat = ei * CFF + torch.clamp(ecol, max=CFF - 1)
    ej = torch.where(
        e_is_ff, j_cand.reshape(-1)[eflat],
        torch.clamp(N + torch.clamp(ecol - CFF, min=0), max=N + 3 + T),
    )
    ej = torch.where(evalid, ej, N - 1)
    eshift = torch.where(
        (e_is_ff & evalid)[:, None],
        torch.stack([sx.reshape(-1)[eflat], sy.reshape(-1)[eflat]], dim=-1),
        0.0,
    )
    return PairArrays(
        qi=torch.cat([qi, ei]),
        qj=torch.cat([qj, ej]),
        shift=torch.cat([shift, eshift], dim=0),
        valid=torch.cat([valid.reshape(-1), evalid]),
        overflow=overflow,
        bin_counts=bin_counts,
    )


def _bin_counts(counts, M: int, nb_id, nb_ok, act):
    """The binned broad phase's work counters, [2] int64 on the device:
    the slot tests of the step (each live floe against the occupied slots,
    at most M a bin, of each of its neighbour bins, itself among them) and
    the floes in the fullest bin (past M: the bins overflowed)."""
    occupied = torch.clamp(counts, max=M)[nb_id]                  # [N, NK]
    live = nb_ok & act[:, None]
    tests = torch.where(live, occupied, 0).sum()
    return torch.stack([tests, counts.max()])


class _PairSides(NamedTuple):
    """Per-pair gathered quantities for one contact list ([K] or [K, 2])."""

    area_i: torch.Tensor
    h_i: torch.Tensor
    nv_i: torch.Tensor
    cent_i: torch.Tensor
    u_i: torch.Tensor
    v_i: torch.Tensor
    xi_i: torch.Tensor
    rmax_i: torch.Tensor
    n_j: torch.Tensor
    u_j: torch.Tensor
    v_j: torch.Tensor
    xi_j: torch.Tensor
    cent_j: torch.Tensor
    h_j: torch.Tensor
    area_j: torch.Tensor
    rmax_j: torch.Tensor
    is_floe_j: torch.Tensor
    wall_id_j: torch.Tensor


def _q_table(floes: FloeState, domain: Domain, q_n, q_cent, dtype):
    """The per-Q-slot scalars of the force recipe as one [NQ, 9] table."""
    T = domain.topography.count
    dev = floes.u.device
    zeros_t = torch.zeros((T,), dtype=dtype, device=dev)
    ones_wt = torch.ones((4 + T,), dtype=dtype, device=dev)
    vel = domain.velocities.to(dtype)
    q_u = torch.cat([floes.u, vel[:, 0], zeros_t])
    q_v = torch.cat([floes.v, vel[:, 1], zeros_t])
    q_xi = torch.cat([floes.xi, torch.zeros((4,), dtype=dtype, device=dev), zeros_t])
    q_height = torch.cat([floes.height, ones_wt])
    q_area = torch.cat([floes.area, ones_wt])
    q_rmax = torch.cat([floes.rmax, ones_wt])
    return torch.stack(
        [
            q_n.to(dtype), q_u, q_v, q_xi,
            q_cent[:, 0], q_cent[:, 1], q_height, q_area, q_rmax,
        ],
        dim=1,
    )


def _gather_sides(floes, q_table, i, j, row_cap=None, g=None,
                  n_rows=None) -> _PairSides:
    """Gather both sides of a contact list.  With ``row_cap`` the first
    NR * row_cap entries are row-structured (i == k // row_cap: broadcasts,
    NR = ``n_rows``, all N rows by default) and any remaining second-chance
    entries are gathered.  ``g``: the pre-gathered ``q_table[j]`` rows."""
    N = floes.capacity
    if row_cap is not None:
        NR = N if n_rows is None else n_rows
        R = NR * row_cap

        def bi(x):
            b = x[:NR, None].expand((NR, row_cap) + x.shape[1:]).reshape(
                (R,) + x.shape[1:]
            )
            if i.shape[0] == R:
                return b
            return torch.cat([b, x[i[R:]]], dim=0)
    else:
        def bi(x):
            return x[i]

    if g is None:
        g = q_table[j]
    return _PairSides(
        area_i=bi(floes.area),
        h_i=bi(floes.height),
        nv_i=bi(floes.nverts),
        cent_i=bi(floes.centroid),
        u_i=bi(floes.u),
        v_i=bi(floes.v),
        xi_i=bi(floes.xi),
        rmax_i=bi(floes.rmax),
        n_j=g[:, 0],
        u_j=g[:, 1],
        v_j=g[:, 2],
        xi_j=g[:, 3],
        cent_j=g[:, 4:6],
        h_j=g[:, 6],
        area_j=g[:, 7],
        rmax_j=g[:, 8],
        is_floe_j=j < N,
        wall_id_j=j - N,
    )


def _norm2(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def _region_forces(consts: Constants, dt: float, vals, s: _PairSides, shift,
                   regions: ClipRegions, pair_on):
    """Hopkins elastic + Coulomb friction forces for one contact list
    (calc_elastic_forces / calc_normal_force / calc_friction_forces,
    collisions.jl:30-283, plus the wall normal-direction correction,
    boundaries.jl:37-148).  Returns (force [K,R,2], fp [K,R,2],
    overlap_rec [K,R])."""
    dtype = regions.area.dtype

    # ------- force factor (collisions.jl:371-379, 528) ---------------------
    # empty pool slots have h = r = 0: keep the 0/0s out of the sums
    hi = s.h_i
    ri = torch.sqrt(s.area_i)
    hj = s.h_j
    rj = torch.sqrt(torch.where(s.is_floe_j, s.area_j, 1.0))
    den_big = torch.minimum(ri, rj)
    ff_big = consts.E * torch.minimum(hi, hj) / torch.where(den_big > 0, den_big, 1.0)
    den_std = hi * rj + hj * ri
    ff_std = consts.E * (hi * hj) / torch.where(den_std > 0, den_std, 1.0)
    ff_floe = torch.where((ri > 1e5) | (rj > 1e5), ff_big, ff_std)
    ff_dom = consts.E * hi / torch.where(ri > 0, ri, 1.0)
    force_factor = torch.where(s.is_floe_j, ff_floe, ff_dom)

    # ------- per-region elastic normal forces ------------------------------
    # region min-area filter (calc_elastic_forces, collisions.jl:158-169)
    min_area = torch.minimum(s.nv_i.to(dtype), s.n_j) * 100.0 / 1.75
    reg_ok = regions.valid & (regions.area >= min_area[:, None]) & pair_on[:, None]

    chord = regions.chord_b - regions.chord_a
    chord_len = _norm2(chord)
    two_pts = regions.n_cross == 2
    # 2-crossing case: direction perpendicular to the chord, sign chosen to
    # reduce the overlap = aligned with the P-chain inward-normal sum
    perp = torch.stack([-chord[..., 1], chord[..., 0]], dim=-1)
    sgn = torch.sign(torch.sum(perp * regions.p_norm, dim=-1))
    sgn = torch.where(sgn == 0, 1.0, sgn)
    dir2 = perp * sgn[..., None] / torch.clamp(chord_len, min=1e-30)[..., None]
    # many-crossing case (_many_intersect_normal_force!, collisions.jl:78-119)
    pn_norm = _norm2(regions.p_norm)
    dirM = regions.p_norm / torch.clamp(pn_norm, min=1e-30)[..., None]
    p_cnt = regions.p_cnt
    dlM = regions.p_len / torch.clamp(p_cnt, min=1).to(dtype)
    # reference condition 0 < n_pts < npoints(region)-1: require a Q chain too
    manyok = (p_cnt > 0) & (regions.q_cnt > 0)

    dl = torch.where(two_pts, chord_len, torch.where(manyok, dlM, 0.0))
    fdir = torch.where(
        two_pts[..., None], dir2, torch.where(manyok[..., None], dirM, 0.0)
    )
    # overlap-too-small gate (collisions.jl:51, 112)
    force_on = reg_ok & (dl > 0.1)
    normal_force = (
        fdir * (regions.area * force_factor[:, None])[..., None]
    ) * force_on[..., None]

    # ------- wall normal-direction correction ------------------------------
    fp = regions.centroid
    is_wall = (s.wall_id_j >= 0) & (s.wall_id_j < 4)
    wid = torch.clamp(s.wall_id_j, 0, 3)
    wall_val = vals[wid]
    zx = (
        ((wid == NORTH)[:, None] & (fp[..., 1] >= wall_val[:, None]))
        | ((wid == SOUTH)[:, None] & (fp[..., 1] <= wall_val[:, None]))
    )
    zy = (
        ((wid == EAST)[:, None] & (fp[..., 0] >= wall_val[:, None]))
        | ((wid == WEST)[:, None] & (fp[..., 0] <= wall_val[:, None]))
    )
    nx = torch.where(is_wall[:, None] & zx, 0.0, normal_force[..., 0])
    ny = torch.where(is_wall[:, None] & zy, 0.0, normal_force[..., 1])
    normal_force = torch.stack([nx, ny], dim=-1)

    # ------- friction (calc_friction_forces, collisions.jl:243-283) --------
    G = consts.E / (2.0 * (1.0 + consts.nu))
    nnorm = _norm2(normal_force)
    ci = s.cent_i
    ui = s.u_i[:, None] + s.xi_i[:, None] * -(fp[..., 1] - ci[:, None, 1])
    vi_ = s.v_i[:, None] + s.xi_i[:, None] * (fp[..., 0] - ci[:, None, 0])
    cjs = s.cent_j + shift  # shifted centroid of Q
    ujp = s.u_j[:, None] + s.xi_j[:, None] * -(fp[..., 1] - cjs[:, None, 1])
    vjp = s.v_j[:, None] + s.xi_j[:, None] * (fp[..., 0] - cjs[:, None, 0])
    udiff = ui - ujp
    vdiff = vi_ - vjp
    vnorm = torch.sqrt(udiff * udiff + vdiff * vdiff)
    vn_safe = torch.where(vnorm > 0, vnorm, 1.0)
    xdir = torch.where(vnorm > 0, udiff / vn_safe, 0.0)
    ydir = torch.where(vnorm > 0, vdiff / vn_safe, 0.0)
    dot_dir = xdir * udiff + ydir * vdiff
    xfric = G * dl * dt * nnorm * xdir * -dot_dir
    yfric = G * dl * dt * nnorm * ydir * -dot_dir
    fric_norm = torch.sqrt(xfric * xfric + yfric * yfric)
    over = fric_norm > consts.mu * nnorm
    xfric = torch.where(over, -consts.mu * nnorm * xdir, xfric)
    yfric = torch.where(over, -consts.mu * nnorm * ydir, yfric)
    friction = torch.stack([xfric, yfric], dim=-1) * force_on[..., None]

    force = normal_force + friction
    # interactions are recorded only when force != 0 (add_interactions!,
    # collisions.jl:288)
    nonzero = force_on & (torch.sum(torch.abs(force), dim=-1) > 0)
    overlap_rec = torch.where(nonzero, regions.area, 0.0)
    return force, fp, overlap_rec


def _segment_sum(payload, idx, N: int):
    """Sum ``payload [K, F]`` into ``out [N, F]`` at rows ``idx [K]``; rows
    with idx outside [0, N) drop out.  Deterministic without float atomics:
    the rows are sorted stably by idx and each floe's rows are added one
    after another in their original order, in O(K F + N F) memory."""
    key = torch.where((idx >= 0) & (idx < N), idx, N).long()
    key, order = torch.sort(key, stable=True)
    # segment n is rows [bounds[n], bounds[n + 1]); segment N holds the
    # dropped rows and is cut off
    bounds = torch.searchsorted(key, torch.arange(N + 2, device=idx.device))
    return torch.segment_reduce(payload[order], "sum", offsets=bounds,
                                axis=0, unsafe=True)[:N]


def _put_rows(x, idx, n: int):
    """out [n] with out[idx[k]] = x[k] for the distinct idx in [0, n);
    idx == n rows drop out (their x must be zero, as the callers mask)."""
    out = x.new_zeros((n + 1,) + x.shape[1:])
    out[idx] = x
    return out[:n]


def _accumulate_contacts(N, i, j, s, pair_valid, is_ff, shift,
                         force, fp, overlap_rec, row_cap=None, n_rows=None):
    """Symmetric +F/-F accumulation of one contact list onto the floe pool
    (replaces the reference's serial reaction pass, collisions.jl:799-862).
    ``s``: the list's sides (a ``_PairSides`` or ``forces.ContactSides``:
    the centroids ``cent_i`` and ``cent_j`` are read).
    With ``row_cap`` the i side of the first ``n_rows`` (default N) rows is
    row-structured and sums by reshape.
    Returns (col_force, col_trq, stress_moments, overarea) per floe."""
    K = i.shape[0]
    fsum = torch.sum(force, dim=1)  # [K, 2]

    # torques about each side's centroid (calc_torque!, collisions.jl:673-686)
    ri_ = fp - s.cent_i[:, None, :]
    trq_i = torch.sum(ri_[..., 0] * force[..., 1] - ri_[..., 1] * force[..., 0], dim=1)
    fp_j = fp - shift[:, None, :]  # force point in j's unshifted frame
    rj_ = fp_j - s.cent_j[:, None, :]
    trq_j = torch.sum(
        rj_[..., 0] * (-force[..., 1]) - rj_[..., 1] * (-force[..., 0]), dim=1
    )

    # stress moments (calc_stress!, update_floe.jl:392-414)
    def stress_moments(rvec, f):
        s11 = torch.sum(rvec[..., 0] * f[..., 0], dim=1)
        s12 = 0.5 * torch.sum(
            rvec[..., 1] * f[..., 0] + rvec[..., 0] * f[..., 1], dim=1
        )
        s22 = torch.sum(rvec[..., 1] * f[..., 1], dim=1)
        return torch.stack([s11, s12, s22], dim=-1)

    smv_i = stress_moments(ri_, force)
    smv_j = stress_moments(rj_, -force)
    ov = torch.sum(overlap_rec, dim=1)

    # payload columns: fx, fy, trq, s11, s12, s22, overarea  (7); the i
    # side is masked before its reshape sums so a dropped row contributes
    # exact zeros, the segment sums drop rows by their index
    pay_i = torch.cat([fsum, trq_i[:, None], smv_i, ov[:, None]], dim=1)
    pay_i = torch.where(pair_valid[:, None], pay_i, 0.0)
    pay_j = torch.cat([-fsum, trq_j[:, None], smv_j, ov[:, None]], dim=1)

    if row_cap is not None:
        NR = N if n_rows is None else n_rows
        R = NR * row_cap
        acc_i = torch.sum(pay_i[:R].reshape(NR, row_cap, -1), dim=1)
        if NR < N:
            acc_i = torch.cat([acc_i, acc_i.new_zeros((N - NR, acc_i.shape[1]))])
        if K > R:  # second-chance entries: arbitrary i
            seg_ie = torch.where(pair_valid[R:], i[R:], N)
            acc_i = acc_i + _segment_sum(pay_i[R:], seg_ie, N)
    else:
        acc_i = _segment_sum(pay_i, torch.where(pair_valid, i, N), N)
    acc_j = _segment_sum(pay_j, torch.where(is_ff, j, N), N)

    acc = acc_i + acc_j
    col_force = acc[:, 0:2]
    col_trq = acc[:, 2]
    s11, s12, s22 = acc[:, 3], acc[:, 4], acc[:, 5]
    sm = torch.stack(
        [torch.stack([s11, s12], -1), torch.stack([s12, s22], -1)], dim=-2
    )
    return col_force, col_trq, sm, acc[:, 6]


class CollisionResult(NamedTuple):
    floes: FloeState
    stress_instant: torch.Tensor  # [N, 2, 2] this-step stress (calc_stress!)
    overflow: torch.Tensor        # pair-capacity or crossing-capacity overflow


class NarrowBatch(NamedTuple):
    """What the narrow phase runs on: the ring pools and the candidate list.
    No per-pair ring is materialised."""

    pairs: PairArrays       # qi, qj, shift, valid of every candidate row
    p_verts: torch.Tensor   # [N, V, 2] P pool: the floes
    p_n: torch.Tensor       # [N] int32
    q_verts: torch.Tensor   # [NQ, V, 2] Q pool: floes, 4 walls, topography
    q_n: torch.Tensor       # [NQ] int32
    q_table: torch.Tensor   # [NQ, 9] (_q_table)
    sides: _PairSides       # both sides of every candidate pair
    row_cap: int            # row-structured entries: the first NR * row_cap
    perturb: torch.Tensor   # [PC] degeneracy-breaking offset of Q

    def two_cross_args(self):
        """The arguments of ``two_cross_dispatch`` (clip.TWO_CROSS_ARGS)."""
        return (self.p_verts, self.p_n, self.q_verts, self.q_n, self.pairs.qi,
                self.pairs.qj, self.pairs.shift, self.perturb, self.pairs.valid)


def narrow_phase_batch(floes: FloeState, domain: Domain, pair_cap: int,
                       bins: tuple | None = None,
                       owned_rows: int | None = None) -> NarrowBatch:
    """Broad phase, Q pool and the pair list that timestep_collisions hands
    to ``two_cross_dispatch`` (``owned_rows``: see find_candidate_pairs)."""
    N = floes.capacity
    NR = N if owned_rows is None else owned_rows
    V = floes.max_verts
    dtype = floes.verts.dtype
    dev = floes.verts.device
    pairs = find_candidate_pairs(floes, domain, pair_cap, bins, owned_rows)
    PC = pairs.qi.shape[0]

    # ---------------- Q pool: floes, 4 walls, topography --------------------
    walls = [wall_rect(domain, w, V, dtype) for w in range(4)]
    q_verts = torch.cat(
        [floes.verts, torch.stack([wv for wv, _ in walls]),
         domain.topography.verts.to(dtype)],
        dim=0,
    )
    q_n = torch.cat(
        [floes.nverts, torch.full((4,), 4, dtype=floes.nverts.dtype, device=dev),
         domain.topography.nverts.to(floes.nverts.dtype)]
    )
    q_cent = torch.cat(
        [floes.centroid, torch.zeros((4, 2), dtype=dtype, device=dev),
         domain.topography.centroid.to(dtype)],
        dim=0,
    )
    q_table = _q_table(floes, domain, q_n, q_cent, dtype)

    # ---------------- both sides of every candidate pair --------------------
    # hybrid list from find_candidate_pairs: NR*row_cap row-structured
    # entries followed by _extra_cap(N) second-chance entries
    row_cap0 = (PC - _extra_cap(N)) // NR
    sides0 = _gather_sides(floes, q_table, pairs.qi, pairs.qj, row_cap=row_cap0,
                           n_rows=NR)

    # deterministic degeneracy-breaking perturbation, scaled to the pair
    eps_rel = 1e-9 if dtype == torch.float64 else 2e-6
    perturb0 = eps_rel * (
        sides0.rmax_i + torch.where(sides0.is_floe_j, sides0.rmax_j, sides0.rmax_i)
    )
    return NarrowBatch(
        pairs=pairs, p_verts=floes.verts.contiguous(), p_n=floes.nverts,
        q_verts=q_verts,
        q_n=q_n, q_table=q_table, sides=sides0, row_cap=row_cap0,
        perturb=perturb0,
    )


def _fast_regions(tc, fast_ok) -> ClipRegions:
    """The narrow phase's two-crossing contacts as one-region ClipRegions
    (a row is a region where ``fast_ok`` holds and its area is positive)."""
    PC = tc.area.shape[0]
    dtype, dev = tc.area.dtype, tc.area.device
    zi = torch.zeros((PC, 1), dtype=torch.int32, device=dev)
    return ClipRegions(
        total_area=tc.area,
        area=tc.area[:, None],
        centroid=tc.centroid[:, None, :],
        n_cross=torch.full((PC, 1), 2, dtype=torch.int32, device=dev),
        chord_a=tc.chord_a[:, None, :],
        chord_b=tc.chord_b[:, None, :],
        p_norm=tc.p_norm[:, None, :],
        p_len=torch.zeros((PC, 1), dtype=dtype, device=dev),
        p_cnt=zi,
        q_cnt=zi,
        valid=(fast_ok & (tc.area > 0))[:, None],
        overflow=torch.zeros((PC,), dtype=torch.bool, device=dev),
    )


class _SlowPairs(NamedTuple):
    """The candidate rows that went through the general region clip."""

    sel: torch.Tensor      # [slow_cap] row of the candidate list, PC = unused
    valid: torch.Tensor    # [slow_cap]
    safe: torch.Tensor     # [slow_cap] sel clamped into the list
    i: torch.Tensor        # [slow_cap] P-side floe
    j: torch.Tensor        # [slow_cap] Q-pool slot
    shift: torch.Tensor    # [slow_cap, 2]
    regions: ClipRegions   # rows that are not valid are zeros
    n_slow: torch.Tensor   # [] slow rows in the list (may exceed slow_cap)
    # [slow_cap] rows whose crossing parity came out odd before the retry
    parity_bad: torch.Tensor


def _slow_path(nb: "NarrowBatch", tc, pair_cap: int, clip_cap: int,
               retry: bool) -> _SlowPairs:
    """Send the candidate rows that cross but are not a clean two-crossing
    contact (``cnt > 0 & ~ok``) through the general region clip, at most
    ``slow_cap = max(pair_cap // 128, 32)`` of them.  ``retry``: rerun the
    first ``RETRY_CAP`` rows whose crossing parity came out odd with the
    perturbation flipped and scaled, keeping the retry where it resolves
    (rows beyond RETRY_CAP stay overflowed and the caller's flag fires).

    Nothing here reads the device, so the step can be captured as a CUDA
    graph.  The JAX package sizes the clip's batch by ``lax.cond``s on the
    number of slow rows (a ladder of tiers) and on whether any parity came
    out odd (collisions.py:1336-1402).  On the card the slow clip's kernel
    (``regions.intersect_regions_dispatch``) decides the same on the device:
    it reads ``n_slow`` there, clips only the rows before it and finds the
    odd rows to retry itself.  On the CPU the plain version clips all
    ``slow_cap`` rows and masks.  Either way the rows past the slow ones
    are zeros."""
    pairs = nb.pairs
    PC = pairs.qi.shape[0]
    slow_cap = max(pair_cap // 128, 32)
    slow_mask = (tc.cnt > 0) & ~tc.ok
    n_slow = slow_mask.sum()
    ssel = first_true(slow_mask, slow_cap, PC)
    svalid = ssel < PC
    ssafe = torch.clamp(ssel, max=PC - 1)
    retry_rows = min(RETRY_CAP, slow_cap) if retry else 0
    sregions, bad1 = intersect_regions_dispatch(
        *nb.two_cross_args()[:8], ssel, n_slow, clip_cap, retry_rows)
    return _SlowPairs(ssel, svalid, ssafe, pairs.qi[ssafe], pairs.qj[ssafe],
                      pairs.shift[ssafe], sregions, n_slow, bad1)


def _force_law_plain(consts: Constants, dt: float, cs, vals, floes, nb, tc,
                     slow: _SlowPairs, marking: bool) -> ForceLaw:
    """The force law in plain PyTorch: with ``marking`` (the step) the
    overlap total of every candidate row and its fuse / remove marks, which
    gate both lists' pairs; without (``pair_interactions``) the pairs are
    gated by their validity and overlap alone.  Then ``_region_forces`` on
    the narrow phase's one-region rows and on the slow clip's regions."""
    pairs, sides0 = nb.pairs, nb.sides
    PC = pairs.qi.shape[0]
    ssel, svalid, ssafe, sregions = slow.sel, slow.valid, slow.safe, slow.regions
    if marking:
        fast_ok = tc.ok
        contain0 = tc.contain
        slow_total = torch.where(svalid, sregions.total_area, 0.0)
        # total intersection area for every candidate pair (containment
        # included); each valid slow row targets a distinct pair, so its sum
        # is a write
        total_area0 = (
            contain0
            + torch.where(fast_ok, tc.area, 0.0)
            + _put_rows(slow_total, ssel, PC)
        )

        # ------- fuse / remove marking (collisions.jl:364-368, 522-525) ----
        area_i0 = sides0.area_i
        area_j0 = torch.where(sides0.is_floe_j, sides0.area_j, torch.inf)
        overlap_frac0 = torch.maximum(total_area0 / area_i0, total_area0 / area_j0)
        is_ff_pair0 = sides0.is_floe_j & pairs.valid
        fuse_pair0 = (
            is_ff_pair0
            & (overlap_frac0 > cs.floe_floe_max_overlap)
            & (total_area0 > 0)
        )
        # domain pairs: remove if max single-region overlap fraction too big
        smax_reg = torch.amax(torch.where(sregions.valid, sregions.area, 0.0), dim=1)
        max_reg0 = torch.maximum(
            torch.where(fast_ok, tc.area, 0.0),
            _put_rows(torch.where(svalid, smax_reg, 0.0), ssel, PC),
        )
        # containment against a wall counts as a full-floe region
        max_reg0 = torch.maximum(
            max_reg0, torch.where(~sides0.is_floe_j, contain0, 0.0)
        )
        dom_remove_pair0 = (
            pairs.valid
            & ~sides0.is_floe_j
            & (max_reg0 / area_i0 > cs.floe_domain_max_overlap)
        )
        pair_on0 = fast_ok & ~fuse_pair0 & ~dom_remove_pair0
        pair_on1 = (
            svalid
            & ~fuse_pair0[ssafe]
            & ~dom_remove_pair0[ssafe]
            & (slow_total > 0)
        )
    else:
        fast_ok = pairs.valid & tc.ok
        is_ff_pair0 = fuse_pair0 = dom_remove_pair0 = None
        pair_on0 = fast_ok
        pair_on1 = svalid & (sregions.total_area > 0)

    sides1 = _gather_sides(floes, nb.q_table, slow.i, slow.j)
    f_force, f_fp, f_rec = _region_forces(
        consts, dt, vals, sides0, pairs.shift, _fast_regions(tc, fast_ok), pair_on0,
    )
    s_force, s_fp, s_rec = _region_forces(
        consts, dt, vals, sides1, slow.shift, sregions, pair_on1,
    )
    return ForceLaw(f_force, f_fp, f_rec, s_force, s_fp, s_rec, is_ff_pair0,
                    fuse_pair0, dom_remove_pair0,
                    ContactSides(sides1.cent_i, sides1.cent_j, sides1.is_floe_j))


def _force_law(consts: Constants, dt: float, cs, vals, floes, nb, tc,
               slow: _SlowPairs, marking: bool) -> ForceLaw:
    """The force law on the tensors' device: CUDA tensors go to its kernel
    (``forces.force_law_cuda``, one launch, B4), which raises on what it
    cannot take (no fallback); CPU tensors go to ``_force_law_plain``.
    ``cs``: the CollisionSettings (None without ``marking``)."""
    if tc.area.is_cuda:
        pairs = nb.pairs
        return force_law_cuda(consts, dt, cs, vals, floes, nb.q_table, pairs.qi,
                              pairs.qj, pairs.shift, pairs.valid, tc, slow.sel,
                              slow.i, slow.j, slow.shift, slow.regions, marking)
    return _force_law_plain(consts, dt, cs, vals, floes, nb, tc, slow, marking)


def timestep_collisions(
    floes: FloeState,
    domain: Domain,
    consts: Constants,
    dt: float,
    collision_settings: CollisionSettings,
    pair_cap: int,
    clip_cap: int = DEFAULT_CAP,
    bins: tuple | None = None,
    owned_rows: int | None = None,
    with_debug: bool = False,
    mark=None,
) -> CollisionResult:
    """timestep_collisions! (collisions.jl:734-864), batched over the pool.

    Every shape is fixed and nothing is read on the host (the slow path
    masks where the JAX package branches with ``lax.cond``), so the step
    can be captured as a CUDA graph.  ``owned_rows``: see find_candidate_pairs
    (a rank's halo-extended pool; only the owned rows' results are used).
    ``with_debug``: also return the JAX package's dict of per-capacity
    counters, each a 0-d tensor on the pool's device, which says which term
    of the overflow flag fired (``tools/probe_overflow_source.py``):
    ``pairs_overflow``, ``n_candidates``, ``compact_overflow`` (always False:
    the compaction branch is not ported), ``n_slow``, ``slow_cap``,
    ``n_parity_bad`` (before the retry) and ``clip_overflow`` (after it).
    Returns ``(result, dbg)`` then.  ``mark``: the step's layer marks
    (``tracing.Marks``), called after the broad phase (with the candidate
    rows to count, and the binned broad phase's counters), after the narrow
    phase and the slow clip (with the slow rows) and after the force law;
    None marks nothing."""
    N = floes.capacity
    NR = N if owned_rows is None else owned_rows
    V = floes.max_verts
    dtype = floes.verts.dtype
    dev = floes.verts.device
    act = floes.active

    # ---------------- open-boundary removal (collisions.jl:427-441) --------
    remove = floes.remove
    vals = domain.vals
    vx = floes.verts[..., 0]
    vy = floes.verts[..., 1]
    vmask = torch.arange(V, device=dev)[None, :] < floes.nverts[:, None]
    big = 1e30
    for w, cmp in (
        (NORTH, lambda: torch.amax(torch.where(vmask, vy, -big), 1) > vals[NORTH]),
        (SOUTH, lambda: torch.amin(torch.where(vmask, vy, big), 1) < vals[SOUTH]),
        (EAST, lambda: torch.amax(torch.where(vmask, vx, -big), 1) > vals[EAST]),
        (WEST, lambda: torch.amin(torch.where(vmask, vx, big), 1) < vals[WEST]),
    ):
        if domain.kinds[w] == BoundaryKind.OPEN:
            remove = remove | (act & cmp())

    # ---------------- fused narrow phase (fast path) ------------------------
    nb = narrow_phase_batch(floes, domain, pair_cap, bins, owned_rows)
    pairs, sides0, row_cap0 = nb.pairs, nb.sides, nb.row_cap
    PC = pairs.qi.shape[0]
    i0 = pairs.qi
    j0 = pairs.qj
    pvalid0 = pairs.valid
    R0 = NR * row_cap0
    if mark is not None:
        mark(1, pairs=pvalid0, bins=pairs.bin_counts,
             bin_cap=0 if bins is None else bins[2])
    # the narrow phase zeroes the rows that are not candidates (cnt 0, ok
    # False, contain 0), so nothing here masks them again
    tc = two_cross_dispatch(*nb.two_cross_args())

    # ---------------- slow path: general region kernel ---------------------
    slow = _slow_path(nb, tc, pair_cap, clip_cap, retry=True)
    svalid, sregions = slow.valid, slow.regions
    i1, j1, shift1, n_slow = slow.i, slow.j, slow.shift, slow.n_slow
    slow_cap = svalid.shape[0]
    if mark is not None:
        mark(2, slow=n_slow, slow_cap=slow_cap)
    law = _force_law(consts, dt, collision_settings, vals, floes, nb, tc, slow,
                     marking=True)
    is_ff_pair0, fuse_pair0, dom_remove_pair0 = law.is_ff, law.fuse, law.dom_remove
    if mark is not None:
        mark(3)
    f_acc = _accumulate_contacts(
        N, i0, j0, sides0, pvalid0, is_ff_pair0, pairs.shift,
        law.f_force, law.f_fp, law.f_rec, row_cap=row_cap0, n_rows=NR,
    )
    s_acc = _accumulate_contacts(
        N, i1, j1, law.s_sides, svalid, law.s_sides.is_floe_j & svalid, shift1,
        law.s_force, law.s_fp, law.s_rec,
    )
    col_force = f_acc[0] + s_acc[0]
    col_trq = f_acc[1] + s_acc[1]
    sm = f_acc[2] + s_acc[2]
    overarea = f_acc[3] + s_acc[3]

    ah = floes.area * floes.height
    ah_safe = torch.where(ah > 0, ah, 1.0)
    stress_instant = sm / ah_safe[:, None, None]

    # fuse / remove marks over the FULL candidate list (containment pairs
    # included); one-sided: the pair's owner records the partner.  Rows past
    # the NR owned ones hold no candidate.
    def pad_rows(a, fill):
        return a if NR == N else torch.cat([a, a.new_full((N - NR,), fill)])

    fp_row = fuse_pair0[:R0].reshape(NR, row_cap0)
    fw_i = pad_rows(torch.amax(
        torch.where(fp_row, j0[:R0].reshape(NR, row_cap0), -1), dim=1
    ), -1)
    fuse_i = pad_rows(torch.any(fp_row, dim=1), False)
    rem_i = pad_rows(
        torch.any(dom_remove_pair0[:R0].reshape(NR, row_cap0), dim=1), False)
    if PC > R0:  # second-chance entries: per-floe maxima over their i
        ie = i0[R0:]
        fw_e = torch.full((N + 1,), -1, dtype=j0.dtype, device=dev).scatter_reduce(
            0, torch.where(fuse_pair0[R0:], ie, N),
            torch.where(fuse_pair0[R0:], j0[R0:], -1), reduce="amax",
        )[:N]
        fuse_i = fuse_i | (fw_e >= 0)
        fw_i = torch.maximum(fw_i, fw_e)
        rem_e = torch.zeros((N + 1,), dtype=torch.int64, device=dev).scatter_reduce(
            0, torch.where(dom_remove_pair0[R0:], ie, N),
            dom_remove_pair0[R0:].long(), reduce="amax",
        )[:N]
        rem_i = rem_i | (rem_e > 0)
    fuse_with = torch.where(fuse_i, fw_i, -1).to(torch.int32)
    remove = remove | rem_i

    new_floes = floes._replace(
        collision_force=torch.where(act[:, None], col_force, 0.0),
        collision_trq=torch.where(act, col_trq, 0.0),
        overarea=torch.where(act, overarea, 0.0),
        remove=remove,
        fuse_with=torch.where(act, fuse_with, -1).to(torch.int32),
    )
    clip_overflow = torch.any(torch.where(svalid, sregions.overflow, False))
    overflow = pairs.overflow | (n_slow > slow_cap) | clip_overflow
    result = CollisionResult(
        floes=new_floes,
        stress_instant=torch.where(act[:, None, None], stress_instant, 0.0),
        overflow=overflow,
    )
    if not with_debug:
        return result

    dbg = {
        "pairs_overflow": pairs.overflow,
        "n_candidates": pvalid0.sum(),
        "compact_overflow": torch.zeros((), dtype=torch.bool, device=dev),
        "n_slow": n_slow,
        "slow_cap": torch.full((), slow_cap, dtype=torch.int64, device=dev),
        "n_parity_bad": slow.parity_bad.sum(),
        "clip_overflow": clip_overflow,
    }
    return result, dbg


def _encode_partner(j, N: int):
    """Q-pool slot -> partner code: floes keep their pool index, walls are
    -1..-4 (N, S, E, W), topography element t is -5 - t (domains.jl:150-163)."""
    return torch.where(
        j < N, j, torch.where(j < N + 4, -(j - N) - 1, -(j - N - 4) - 5)
    )


def pair_overlaps(
    floes: FloeState,
    domain: Domain,
    pair_cap: int,
    clip_cap: int = DEFAULT_CAP,
    bins: tuple | None = None,
):
    """Overlap areas of all currently intersecting pairs, for the host
    ridge/raft pass (the analog of walking per-floe interaction lists,
    ridge_raft.jl:704-753).

    Returns (i, j, area, valid, overflow): j >= 0 is a floe pool index;
    j < 0 encodes walls (-1..-4 for N,S,E,W) and topography (-5 - t).
    ``overflow`` (scalar bool) fires when the broad phase or the slow-path
    multi-region capacity truncated candidates, i.e. the overlap list may
    be incomplete (as timestep_collisions reports it)."""
    N = floes.capacity
    nb = narrow_phase_batch(floes, domain, pair_cap, bins)
    pairs = nb.pairs
    PC = pairs.qi.shape[0]
    tc = two_cross_dispatch(*nb.two_cross_args())
    # multi-region / degenerate pairs through the general clip
    slow = _slow_path(nb, tc, pair_cap, clip_cap, retry=False)
    slow_total = torch.where(slow.valid, slow.regions.total_area, 0.0)
    area = (
        tc.contain
        + torch.where(tc.ok, tc.area, 0.0)
        + _put_rows(slow_total, slow.sel, PC)
    )
    valid = pairs.valid & (area > 0)
    overflow = (
        pairs.overflow
        | (slow.n_slow > slow.valid.shape[0])
        | torch.any(torch.where(slow.valid, slow.regions.overflow, False))
    )
    return pairs.qi, _encode_partner(pairs.qj, N), area, valid, overflow


def pair_interactions(
    floes: FloeState,
    domain: Domain,
    consts: Constants,
    dt: float,
    pair_cap: int,
    clip_cap: int = DEFAULT_CAP,
    bins: tuple | None = None,
):
    """Materialized per-contact interaction rows, for the fracture pass's
    deformation and for diagnostics (the step only keeps aggregates).

    Returns a dict of tensors over a fixed contact capacity:
      i [K]        P-side floe pool index
      j [K]        partner: >= 0 floe pool index, -1..-4 walls, <= -5 topo
      fx, fy [K]   contact force on floe i (add_interactions! columns 2-3)
      px, py [K]   force application point (columns 4-5)
      torque [K]   torque about i's centroid (calc_torque!, column 6)
      overlap [K]  region overlap area (column 7)
      valid [K]    row validity mask
      overflow []  capacity-truncation flag
    Rows are two-sided for floe-floe contacts (add_interactions! on both
    floes + the reaction pass, collisions.jl:285-309, 799-828): each
    unordered pair emits the owner's row AND the partner's mirror row
    (negated force, force point shifted to the partner's periodic frame,
    torque about the partner's centroid).  Wall/topography contacts emit
    one row.  Row order: fast owner rows, fast mirror rows, slow owner
    rows, slow mirror rows, each in candidate-list order."""
    N = floes.capacity
    vals = domain.vals
    nb = narrow_phase_batch(floes, domain, pair_cap, bins)
    pairs = nb.pairs
    tc = two_cross_dispatch(*nb.two_cross_args())
    fast_ok = pairs.valid & tc.ok
    # slow path (multi-region contacts)
    slow = _slow_path(nb, tc, pair_cap, clip_cap, retry=False)
    law = _force_law(consts, dt, None, vals, floes, nb, tc, slow, marking=False)

    def rows(i, j, s, force, fp, rec, base_valid, shift):
        R = force.shape[1]
        ri_ = fp - s.cent_i[:, None, :]
        trq = ri_[..., 0] * force[..., 1] - ri_[..., 1] * force[..., 0]
        nonzero = torch.sum(torch.abs(force), dim=-1) > 0
        out_valid = base_valid[:, None] & nonzero

        def tile(x):
            return x[:, None].expand(x.shape[0], R).reshape(-1)

        # partner-side mirror rows (floe-floe only): force point moved to
        # the partner's unshifted periodic frame, torque about its centroid
        fp_j = fp - shift[:, None, :]
        rj_ = fp_j - s.cent_j[:, None, :]
        trq_j = rj_[..., 0] * (-force[..., 1]) - rj_[..., 1] * (-force[..., 0])
        m_valid = out_valid & s.is_floe_j[:, None]
        cat = torch.cat
        return {
            "i": cat([tile(i), tile(j)]),
            "j": cat([tile(_encode_partner(j, N)), tile(i)]),
            "fx": cat([force[..., 0].reshape(-1), -force[..., 0].reshape(-1)]),
            "fy": cat([force[..., 1].reshape(-1), -force[..., 1].reshape(-1)]),
            "px": cat([fp[..., 0].reshape(-1), fp_j[..., 0].reshape(-1)]),
            "py": cat([fp[..., 1].reshape(-1), fp_j[..., 1].reshape(-1)]),
            "torque": cat([trq.reshape(-1), trq_j.reshape(-1)]),
            "overlap": cat([rec.reshape(-1), rec.reshape(-1)]),
            "valid": cat([out_valid.reshape(-1), m_valid.reshape(-1)]),
        }

    rf = rows(pairs.qi, pairs.qj, nb.sides, law.f_force, law.f_fp, law.f_rec,
              fast_ok, pairs.shift)
    rs = rows(slow.i, slow.j, law.s_sides, law.s_force, law.s_fp, law.s_rec,
              slow.valid, slow.shift)
    out = {k: torch.cat([rf[k], rs[k]]) for k in rf}
    out["overflow"] = (
        pairs.overflow
        | (slow.n_slow > slow.valid.shape[0])
        | torch.any(torch.where(slow.valid, slow.regions.overflow, False))
    )
    return out
