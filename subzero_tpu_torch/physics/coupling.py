"""Ice <-> ocean/atmosphere coupling (port of
``subzero_tpu/physics/coupling.py``).

  * one-way (ocean/atmos -> ice): sub-floe points are rotated to the world
    frame, the fields are bilinearly interpolated there (periodic seams
    wrap), and quadratic drag + Coriolis + pressure-gradient stresses are
    averaged into per-floe forces and torques (coupling.jl:1486-1589);
  * two-way (ice/atmos -> ocean): per-point ocean stresses are summed into
    (floe, window-cell) buckets, the floe area inside each covered cell is
    clipped exactly, and per-cell stress / sea-ice fraction / heatflux
    factor are assembled on the grid (coupling.jl:1617-1680);
  * Eulerian OA mode (``CouplingSettings.eulerian``): grid-cell forcing
    weighted by the exact ice area per cell, instead of sub-floe points.

The sums onto cells are one-hot products, which are deterministic.  Call
with ``torch.backends.cuda.matmul.allow_tf32 = False`` on the card (the
step, simulation.build_step_parts, sets it): TF32 would keep about three
digits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import Constants
from ..core.domain import Domain
from ..core.fields import AtmosState, OceanState
from ..core.floes import FloeState
from ..core.grid import RegRectilinearGrid
from ..settings import CouplingSettings, FloeSettings
from . import cell_clip as _cell_clip


def _bilinear(field, gx, gy, grid: RegRectilinearGrid, ew_periodic, ns_periodic):
    """Bilinear interpolation of grid-point field(s) at world coords.

    ``field`` is [Nx+1, Ny+1] or [Nx+1, Ny+1, F]; periodic directions wrap
    (grid line 0 == grid line N), the others clamp to the grid."""
    fx = (gx - grid.x0) / grid.dx
    fy = (gy - grid.y0) / grid.dy
    fx = torch.remainder(fx, grid.Nx) if ew_periodic else torch.clamp(fx, 0.0, grid.Nx)
    fy = torch.remainder(fy, grid.Ny) if ns_periodic else torch.clamp(fy, 0.0, grid.Ny)
    ix = torch.clamp(torch.floor(fx).long(), 0, grid.Nx - 1)
    iy = torch.clamp(torch.floor(fy).long(), 0, grid.Ny - 1)
    wx = fx - ix
    wy = fy - iy
    GY = grid.Ny + 1
    flat = field.reshape((grid.Nx + 1) * GY, *field.shape[2:])
    k00 = ix * GY + iy
    f00 = flat[k00]
    f10 = flat[k00 + GY]
    f01 = flat[k00 + 1]
    f11 = flat[k00 + GY + 1]
    if field.dim() == 3:
        wx = wx[..., None]
        wy = wy[..., None]
    return (
        f00 * (1 - wx) * (1 - wy)
        + f10 * wx * (1 - wy)
        + f01 * (1 - wx) * wy
        + f11 * wx * wy
    )


def _window_overflow(px, py, centroid, grid: RegRectilinearGrid, W: int):
    """[N, P] points outside their floe's W-node interpolation window.

    The reference interpolates one-way fields from a per-floe window of
    W x W grid nodes around the centroid (its _windowed_interp) and flags a
    point that leaves the window; the values equal the plain bilinear ones,
    so this port interpolates with ``_bilinear`` and keeps only the same
    window test, clamps included."""
    PX = grid.Nx + 1 + 2 * W
    PY = grid.Ny + 1 + 2 * W
    bx0 = torch.floor((centroid[:, 0] - grid.x0) / grid.dx).long() - (W // 2 - 1)
    by0 = torch.floor((centroid[:, 1] - grid.y0) / grid.dy).long() - (W // 2 - 1)
    bxp = torch.clamp(bx0 + W, 0, PX - W)
    byp = torch.clamp(by0 + W, 0, PY - W)
    lx = torch.floor((px - grid.x0) / grid.dx).long() - (bxp - W)[:, None]
    ly = torch.floor((py - grid.y0) / grid.dy).long() - (byp - W)[:, None]
    return (lx < 0) | (lx > W - 2) | (ly < 0) | (ly > W - 2)


class OneWayResult(NamedTuple):
    floes: FloeState
    # per-point data retained for two-way coupling
    pt_x: torch.Tensor        # [N, P] world x of sub-floe points
    pt_y: torch.Tensor
    pt_mask: torch.Tensor     # [N, P] in-bounds & active & < nsub
    pt_tau_x_ocn: torch.Tensor  # [N, P] ocean-on-ice stress at point
    pt_tau_y_ocn: torch.Tensor
    pt_cell: torch.Tensor     # [N, P] flattened line-centered cell index
    window_ovf: torch.Tensor  # [] interpolation-window coverage overflow


def calc_one_way_coupling(
    floes: FloeState,
    grid: RegRectilinearGrid,
    domain: Domain,
    ocean: OceanState,
    atmos: AtmosState,
    consts: Constants,
    window: int | None = None,
) -> OneWayResult:
    """One-way (ocean/atmos -> floe) forcing (coupling.jl:1180-1300).
    ``window``: node-window width whose coverage ``window_ovf`` reports
    (None: no window, no flag)."""
    N, P = floes.sub_x.shape
    act = floes.active
    dev = floes.sub_x.device

    # world-frame sub-floe points (calc_subfloe_values!, coupling.jl:627-657)
    ca = torch.cos(floes.alpha)[:, None]
    sa = torch.sin(floes.alpha)[:, None]
    px = ca * floes.sub_x - sa * floes.sub_y + floes.centroid[:, 0:1]
    py = sa * floes.sub_x + ca * floes.sub_y + floes.centroid[:, 1:2]

    pmask = torch.arange(P, device=dev)[None, :] < floes.nsub[:, None]
    # in_bounds (coupling.jl:494-597): off-grid only through periodic sides
    if not domain.ew_periodic:
        pmask = pmask & (px >= grid.x0) & (px <= grid.xf)
    if not domain.ns_periodic:
        pmask = pmask & (py >= grid.y0) & (py <= grid.yf)
    pmask = pmask & act[:, None]

    npoints = torch.sum(pmask, dim=1)
    np_safe = torch.clamp(npoints, min=1)

    window_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    if window is not None:
        window_ovf = torch.any(
            _window_overflow(px, py, floes.centroid, grid, window) & pmask
        )
    stacked = torch.stack(
        [atmos.u, atmos.v, ocean.u, ocean.v, ocean.hflx_factor], dim=-1
    )
    vals = _bilinear(stacked, px, py, grid, domain.ew_periodic, domain.ns_periodic)
    uatm, vatm, uocn, vocn, hflx = vals.unbind(-1)

    # rigid-body point velocities
    xc = px - floes.centroid[:, 0:1]
    yc = py - floes.centroid[:, 1:2]
    upoint = floes.u[:, None] - floes.xi[:, None] * yc
    vpoint = floes.v[:, None] + floes.xi[:, None] * xc

    # atmosphere drag (calc_atmosphere_forcing, coupling.jl:1212-1232)
    du_ai = uatm - upoint
    dv_ai = vatm - vpoint
    nrm_a = torch.sqrt(du_ai * du_ai + dv_ai * dv_ai)
    tx_atm = consts.rho_a * consts.Cd_ia * nrm_a * du_ai
    ty_atm = consts.rho_a * consts.Cd_ia * nrm_a * dv_ai

    # ocean drag + pressure gradient (calc_ocean_forcing!, coupling.jl:1277-1299)
    area_safe = torch.where(floes.area > 0, floes.area, 1.0)
    ma_ratio = (floes.mass / area_safe)[:, None]
    du_oi = uocn - upoint
    dv_oi = vocn - vpoint
    nrm_o = torch.sqrt(du_oi * du_oi + dv_oi * dv_oi)
    ct, st = math.cos(consts.turn_angle), math.sin(consts.turn_angle)
    tx_ocn = consts.rho_o * consts.Cd_io * nrm_o * (ct * du_oi - st * dv_oi)
    ty_ocn = consts.rho_o * consts.Cd_io * nrm_o * (st * du_oi + ct * dv_oi)
    tx_pgrad = -ma_ratio * consts.f * vocn
    ty_pgrad = ma_ratio * consts.f * uocn

    tx = tx_atm + tx_pgrad + tx_ocn
    ty = ty_atm + ty_pgrad + ty_ocn
    trq = -tx * yc + ty * xc

    def msum(x):
        return torch.sum(torch.where(pmask, x, 0.0), dim=1)

    # Coriolis contribution: constant per point (coupling.jl:1522-1525)
    cor_x = ma_ratio[:, 0] * consts.f * floes.v
    cor_y = -(ma_ratio[:, 0] * consts.f * floes.u)
    tot_tx = msum(tx) + npoints * cor_x
    tot_ty = msum(ty) + npoints * cor_y
    tot_trq = msum(trq)
    tot_hflx = msum(hflx)

    fx_oa = tot_tx / np_safe * floes.area
    fy_oa = tot_ty / np_safe * floes.area
    trq_oa = tot_trq / np_safe * floes.area
    hflx_factor = tot_hflx / np_safe

    # floes with zero in-bounds points are marked remove (coupling.jl:1507-1508)
    remove = floes.remove | (act & (npoints == 0))

    new_floes = floes._replace(
        fx_oa=torch.where(act, fx_oa, floes.fx_oa),
        fy_oa=torch.where(act, fy_oa, floes.fy_oa),
        trq_oa=torch.where(act, trq_oa, floes.trq_oa),
        hflx_factor=torch.where(act, hflx_factor, floes.hflx_factor),
        remove=remove,
    )

    # line-centered cell index per point, with periodic shift
    # (find_center_cell_index + shift_cell_idx, coupling.jl:466-470, 1154-1178)
    cxi = torch.floor((px - grid.x0) / grid.dx + 0.5).long()
    cyi = torch.floor((py - grid.y0) / grid.dy + 0.5).long()
    cxi = torch.remainder(cxi, grid.Nx) if domain.ew_periodic else torch.clamp(cxi, 0, grid.Nx)
    cyi = torch.remainder(cyi, grid.Ny) if domain.ns_periodic else torch.clamp(cyi, 0, grid.Ny)
    cell = cxi * (grid.Ny + 1) + cyi

    return OneWayResult(
        floes=new_floes,
        pt_x=px,
        pt_y=py,
        pt_mask=pmask,
        pt_tau_x_ocn=tx_ocn,
        pt_tau_y_ocn=ty_ocn,
        pt_cell=cell,
        window_ovf=window_ovf,
    )


def _window_origin(floes, grid, cap):
    """Each floe's cap x cap window of line-centered cells: its centroid's
    cell (cx0, cy0) [N] and the window's offsets from it, ``offs`` [cap]."""
    cx0 = torch.floor((floes.centroid[:, 0] - grid.x0) / grid.dx + 0.5).long()
    cy0 = torch.floor((floes.centroid[:, 1] - grid.y0) / grid.dy + 0.5).long()
    offs = torch.arange(cap, device=floes.verts.device) - cap // 2
    return cx0, cy0, offs


def window_inputs(floes, grid, domain, cap):
    """``_cell_areas``' arguments (rings, rects and mask by axis) for the
    pool's cap x cap windows, as the coupling hands them over."""
    return _window(floes, grid, domain, *_window_origin(floes, grid, cap))[1]


def _floe_cell_areas(floes, grid, domain, cx0, cy0, offs, window_cells=None):
    """Per-floe cell window + exact ice area per window cell: a cap x cap
    window of line-centered cells (``offs`` [cap] from the centroid's cell
    ``cx0``, ``cy0``) around each floe, with the floe clipped against every
    cell rect that its bounding circle reaches.  Returns (wx, wy, wxs, wys,
    w_area): unshifted window indices and periodic-shifted or clamped
    indices by axis [N, cap], and the ice area per cell [N, cap, cap] (0 in
    a cell that is not clipped).
    ``window_cells``: a 0-d int64 tensor that the cells clipped are added
    to, or None."""
    idx, args = _window(floes, grid, domain, cx0, cy0, offs)
    return (*idx, _cell_areas(*args, window_cells))


def _window(floes, grid, domain, cx0, cy0, offs):
    """``_floe_cell_areas``' window: its indices (wx, wy, wxs, wys) and the
    clip's arguments (rings, then the cell rects and mask by axis)."""
    dtype = floes.verts.dtype
    wx = cx0[:, None] + offs[None, :]      # [N, cap]
    wy = cy0[:, None] + offs[None, :]
    if domain.ew_periodic:
        wxs = torch.remainder(wx, grid.Nx)
        wx_ok = torch.ones_like(wx, dtype=torch.bool)
    else:
        wxs = torch.clamp(wx, 0, grid.Nx)
        wx_ok = (wx >= 0) & (wx <= grid.Nx)
    if domain.ns_periodic:
        wys = torch.remainder(wy, grid.Ny)
        wy_ok = torch.ones_like(wy, dtype=torch.bool)
    else:
        wys = torch.clamp(wy, 0, grid.Ny)
        wy_ok = (wy >= 0) & (wy <= grid.Ny)

    # only cells within the floe's bounding circle need clipping; the
    # window's mask is separable, a cell (i, j) kept where okx[i] & oky[j]
    wxf = wx.to(dtype)
    wyf = wy.to(dtype)
    cell_x = grid.x0 + wxf * grid.dx       # unshifted cell center x
    cell_y = grid.y0 + wyf * grid.dy
    rcell = 0.5 * math.sqrt(grid.dx**2 + grid.dy**2)
    near_x = torch.abs(cell_x - floes.centroid[:, 0:1]) <= floes.rmax[:, None] + rcell
    near_y = torch.abs(cell_y - floes.centroid[:, 1:2]) <= floes.rmax[:, None] + rcell
    okx = floes.active[:, None] & wx_ok & near_x    # [N, cap]
    oky = wy_ok & near_y

    # cell rects by axis (line-centered, trimmed at non-periodic boundaries:
    # center_cell_coords + check_cell_bounds, coupling.jl:931-1140)
    xmin = (wxf - 0.5) * grid.dx + grid.x0
    xmax = xmin + grid.dx
    ymin = (wyf - 0.5) * grid.dy + grid.y0
    ymax = ymin + grid.dy
    if not domain.ew_periodic:
        xmin = torch.clamp(xmin, grid.x0, grid.xf)
        xmax = torch.clamp(xmax, grid.x0, grid.xf)
    if not domain.ns_periodic:
        ymin = torch.clamp(ymin, grid.y0, grid.yf)
        ymax = torch.clamp(ymax, grid.y0, grid.yf)

    # the full ring width always: the JAX package clips on the first 16
    # slots when every live ring fits (a lax.cond); which width serves is
    # known only on the device, and the padded slots add exact zeros, so
    # both widths give the same bits (tests/test_torch_step_graph.py)
    return ((wx, wy, wxs, wys),
            (floes.verts, floes.nverts, xmin, xmax, ymin, ymax, okx, oky))


def _cell_areas(verts, nverts, xmin, xmax, ymin, ymax, okx, oky, window_cells=None):
    """Area of each ring in each cell of its window [N, A, B], 0 in a cell
    that the mask drops: the cell (i, j) of ring n is the rect [xmin[n, i],
    xmax[n, i]] x [ymin[n, j], ymax[n, j]], kept where okx[n, i] and
    oky[n, j] (rects and mask [N, A] by column, [N, B] by row).
    ``window_cells``: a 0-d int64 tensor that the kept cells are added to,
    or None.  On the card one launch of the cell clip's kernel
    (``cell_clip.py``, B6), which equals the plain version on the card to
    the bit; on the CPU the plain version (``_cell_areas_plain``:
    ``_clip_area_to_rects`` over the window's [N, A, B] rects)."""
    if verts.is_cuda:
        return _cell_clip.cell_areas_cuda(verts, nverts, xmin, xmax, ymin, ymax, okx,
                                          oky, window_cells)
    return _cell_areas_plain(verts, nverts, xmin, xmax, ymin, ymax, okx, oky,
                             window_cells)


def _cell_areas_plain(verts, nverts, xmin, xmax, ymin, ymax, okx, oky,
                      window_cells=None):
    """``_cell_areas`` in plain PyTorch, on any device."""
    N, A, B = okx.shape[0], okx.shape[1], oky.shape[1]
    pair_ok = okx[:, :, None] & oky[:, None, :]
    area = _clip_area_to_rects(
        verts, nverts, xmin[:, :, None].expand(N, A, B), xmax[:, :, None].expand(N, A, B),
        ymin[:, None, :].expand(N, A, B), ymax[:, None, :].expand(N, A, B), pair_ok,
    )
    if window_cells is not None:
        window_cells += pair_ok.sum()
    return torch.where(pair_ok & (area > 0), area, 0.0)


def calc_eulerian_oa_coupling(
    floes: FloeState,
    grid: RegRectilinearGrid,
    domain: Domain,
    ocean: OceanState,
    atmos: AtmosState,
    consts: Constants,
    cell_cap: int,
    window_cells=None,
):
    """Eulerian (grid-cell) OA forcing (floe_OA_forcings!,
    eulerian_OA_code.jl:121-179): instead of sub-floe quadrature points,
    each floe integrates drag over the grid cells it covers, weighted by the
    exact ice area in each cell.

    Atmosphere drag uses the raw atmosphere velocity (not relative to ice),
    ocean drag is relative with the turning-angle rotation, pressure-gradient
    and Coriolis terms use mass/area, torque arms run to the cell centers,
    and the floe heatflux factor is the mean over covered cells.  Returns
    the floe pool with fx_oa/fy_oa/trq_oa/hflx_factor filled in.
    ``window_cells``: see ``_floe_cell_areas``."""
    N = floes.capacity
    dtype = floes.verts.dtype
    cx0, cy0, offs = _window_origin(floes, grid, cell_cap)
    wx, wy, wxs, wys, w_area = _floe_cell_areas(
        floes, grid, domain, cx0, cy0, offs, window_cells
    )
    covered = w_area > 0                                   # [N, cap, cap]

    # field values at the (shifted) cell centers: flat 1-D gathers
    NCy = grid.Ny + 1
    flat = (wxs[:, :, None] * NCy + wys[:, None, :]).reshape(N, -1)

    def at_cells(f):
        return f.reshape(-1)[flat].reshape(N, cell_cap, cell_cap).to(dtype)

    uo = at_cells(ocean.u)
    vo = at_cells(ocean.v)
    ua = at_cells(atmos.u)
    va = at_cells(atmos.v)
    hflx = at_cells(ocean.hflx_factor)

    # torque arms to UNSHIFTED cell centers (periodic images stay on the
    # floe's side of the seam)
    lx = grid.x0 + wx.to(dtype)[:, :, None] * grid.dx - floes.centroid[:, 0, None, None]
    ly = grid.y0 + wy.to(dtype)[:, None, :] * grid.dy - floes.centroid[:, 1, None, None]

    # ice velocity at each cell center (rigid body)
    uice = floes.u[:, None, None] - ly * floes.xi[:, None, None]
    vice = floes.v[:, None, None] + lx * floes.xi[:, None, None]

    area_safe = torch.where(floes.area > 0, floes.area, 1.0)
    ma_ratio = torch.where(floes.area > 0, floes.mass / area_safe, 0.0)[:, None, None]

    # atmosphere drag (raw atmosphere velocity - eulerian_OA_code.jl:141-143)
    na = torch.sqrt(ua * ua + va * va)
    fx = consts.rho_a * consts.Cd_ia * na * ua * w_area
    fy = consts.rho_a * consts.Cd_ia * na * va * w_area

    # pressure gradient (:146-147)
    fx = fx - ma_ratio * consts.f * vo * w_area
    fy = fy + ma_ratio * consts.f * uo * w_area

    # ocean drag with turning angle (:150-155)
    du = uo - uice
    dv = vo - vice
    nn = torch.sqrt(du * du + dv * dv)
    ct, st = math.cos(consts.turn_angle), math.sin(consts.turn_angle)
    tau_x = consts.rho_o * consts.Cd_io * nn * (ct * du - st * dv)
    tau_y = consts.rho_o * consts.Cd_io * nn * (st * du + ct * dv)
    fx = fx + tau_x * w_area
    fy = fy + tau_y * w_area

    # torque BEFORE Coriolis (:159-160; Coriolis acts at the centroid)
    trq = lx * fy - ly * fx

    # Coriolis (:163-164)
    fx = fx + ma_ratio * consts.f * floes.v[:, None, None] * w_area
    fy = fy - ma_ratio * consts.f * floes.u[:, None, None] * w_area

    def csum(x):
        return torch.sum(torch.where(covered, x, 0.0), dim=(1, 2))

    ncov = torch.sum(covered.to(dtype), dim=(1, 2))
    hflx_floe = csum(hflx) / torch.where(ncov > 0, ncov, 1.0)

    act = floes.active
    return floes._replace(
        fx_oa=torch.where(act, csum(fx), 0.0),
        fy_oa=torch.where(act, csum(fy), 0.0),
        trq_oa=torch.where(act, csum(trq), 0.0),
        hflx_factor=torch.where(act, hflx_floe, 0.0),
    )


def calc_two_way_coupling(
    one_way: OneWayResult,
    grid: RegRectilinearGrid,
    domain: Domain,
    ocean: OceanState,
    atmos: AtmosState,
    consts: Constants,
    floe_settings: FloeSettings,
    dt: float,
    cell_cap: int,
    reduce_sums=None,
    window_cells=None,
):
    """Ice/atmosphere effect on the ocean (coupling.jl:1617-1680).

    ``reduce_sums``: where the pool is one rank's block of a domain
    decomposition, a callable that takes this rank's per-cell sums [C, 3]
    and returns their sum over every rank (parallel/decomp.py); it runs
    before the area-weighted division, which is not linear in the sums.
    ``window_cells``: see ``_floe_cell_areas``.

    Returns (ocean, overflow): ``overflow`` fires when a valid sub-floe
    point falls outside its floe's cell_cap x cell_cap window, so that its
    stress deposition would be lost."""
    floes = one_way.floes
    N, P = one_way.pt_x.shape
    NCx, NCy = grid.Nx + 1, grid.Ny + 1
    dev = one_way.pt_x.device
    dtypef = one_way.pt_x.dtype

    cx0, cy0, offs = _window_origin(floes, grid, cell_cap)
    half = cell_cap // 2
    ar = torch.arange(cell_cap, device=dev)

    # per-(floe, window-cell) sums of -tau_ocn and point counts
    # (CellStresses' add_point!, coupling.jl:1329-1384): separable per-axis
    # one-hots, contracted over the points
    pxi = torch.floor((one_way.pt_x - grid.x0) / grid.dx + 0.5).long()
    pyi = torch.floor((one_way.pt_y - grid.y0) / grid.dy + 0.5).long()
    kx = pxi - (cx0[:, None] - half)
    ky = pyi - (cy0[:, None] - half)
    in_win = (kx >= 0) & (kx < cell_cap) & (ky >= 0) & (ky < cell_cap)
    win_overflow = torch.any(one_way.pt_mask & ~in_win)
    wmask = one_way.pt_mask & in_win
    ohx = (
        (kx[:, None, :] == ar[None, :, None]) & wmask[:, None, :]
    ).to(dtypef)                                 # [N, cap, P]
    ohy = (ky[:, None, :] == ar[None, :, None]).to(dtypef)
    payload = torch.stack(
        [-one_way.pt_tau_x_ocn, -one_way.pt_tau_y_ocn,
         torch.ones_like(one_way.pt_x)],
        dim=1,
    )  # [N, 3, P]; masked points drop out through the ohx zero rows
    z = (ohy[:, :, None, :] * payload[:, None, :, :]).reshape(N, cell_cap * 3, P)
    sums = torch.bmm(ohx, z.transpose(1, 2)).reshape(N, cell_cap, cell_cap, 3)
    tx_pair = sums[..., 0]
    ty_pair = sums[..., 1]
    np_pair = sums[..., 2]
    np_pair_safe = torch.where(np_pair > 0, np_pair, 1.0)
    wx, wy, wxs, wys, w_area = _floe_cell_areas(
        floes, grid, domain, cx0, cy0, offs, window_cells
    )
    cell_pay = torch.stack(
        [tx_pair / np_pair_safe * w_area, ty_pair / np_pair_safe * w_area, w_area],
        dim=-1,
    )  # [N, cap, cap, 3]; invalid window cells carry w_area == 0
    # separable one-hot products onto the grid, x axis then y axis
    A = (wxs[:, :, None] == torch.arange(NCx, device=dev)).to(dtypef)  # [N, cap, NCx]
    step1 = torch.bmm(
        cell_pay.reshape(N, cell_cap, cell_cap * 3).transpose(1, 2), A
    )  # [N, cap*3, NCx]
    B = (wys[:, :, None] == torch.arange(NCy, device=dev)).to(dtypef)  # [N, cap, NCy]
    cell_sums = torch.einsum(
        "ncfg,nch->ghf", step1.reshape(N, cell_cap, 3, NCx), B
    ).reshape(NCx * NCy, 3)
    if reduce_sums is not None:
        cell_sums = reduce_sums(cell_sums)
    tau_x_cell = cell_sums[:, 0]
    tau_y_cell = cell_sums[:, 1]
    ice_area_cell = cell_sums[:, 2]

    has_ice = ice_area_cell > 0
    ice_safe = torch.where(has_ice, ice_area_cell, 1.0)
    tau_x = torch.where(has_ice, tau_x_cell / ice_safe, 0.0)
    tau_y = torch.where(has_ice, tau_y_cell / ice_safe, 0.0)
    si_frac = (ice_area_cell / (grid.dx * grid.dy)).reshape(NCx, NCy)
    tau_x = tau_x.reshape(NCx, NCy)
    tau_y = tau_y.reshape(NCx, NCy)

    # atmosphere-on-open-water drag (coupling.jl:1669-1674)
    du_ao = atmos.u - ocean.u
    dv_ao = atmos.v - ocean.v
    nrm = torch.sqrt(du_ao * du_ao + dv_ao * dv_ao)
    ocn_frac = 1.0 - si_frac
    tau_x = tau_x + consts.rho_a * consts.Cd_ao * ocn_frac * nrm * du_ao
    tau_y = tau_y + consts.rho_a * consts.Cd_ao * ocn_frac * nrm * dv_ao

    # heatflux factor (coupling.jl:1676-1677)
    hflx = dt * consts.k / (floe_settings.rho_i * consts.L) * (ocean.temp - atmos.temp)

    ocean = ocean._replace(
        tau_x=tau_x.to(ocean.tau_x.dtype),
        tau_y=tau_y.to(ocean.tau_y.dtype),
        si_frac=si_frac.to(ocean.si_frac.dtype),
        hflx_factor=hflx.to(ocean.hflx_factor.dtype),
    )
    return ocean, win_overflow


def _clip_area_to_rects(verts, nverts, xmin, xmax, ymin, ymax, ok):
    """Area of each floe polygon inside each axis-aligned rect.

    verts [N, V, 2], nverts [N]; rect bounds and ok mask are [N, a, b].
    Closed-form clamped-image shoelace: the ring's image under the
    retraction (x, y) -> (clamp(x, x0, x1), clamp(y, y0, y1)) traverses the
    boundary of P intersect B plus zero-area runs along the box edges, so
    its signed area is area(P intersect B).  Each edge's image is a
    polyline bent where x(t)/y(t) cross the four box lines; inserting the
    four sorted, [0, 1]-clamped crossing parameters as vertices is exact.
    """
    N, A, B = xmin.shape
    terms = _clip_edge_terms(verts, nverts, xmin, xmax, ymin, ymax)
    area = (0.5 * torch.sum(terms, dim=1)).reshape(N, A, B)
    return torch.where(ok, torch.abs(area), 0.0)


def _clip_edge_terms(verts, nverts, xmin, xmax, ymin, ymax):
    """``_clip_area_to_rects``' shoelace terms [N, V, a * b]: each edge's
    clamped image's cross products against each rect, 0 on a padded edge;
    twice the area is their sum over the edges."""
    N, V, _ = verts.shape
    A, B = xmin.shape[1], xmin.shape[2]
    C = A * B
    dtype = verts.dtype

    ex1 = verts[..., 0]
    ey1 = verts[..., 1]
    idx = torch.arange(V, device=verts.device)
    nsafe = torch.clamp(nverts, min=1)
    wrap = idx[None, :] == (nsafe[:, None] - 1)
    ex2 = torch.where(wrap, ex1[:, 0:1], torch.roll(ex1, -1, 1))
    ey2 = torch.where(wrap, ey1[:, 0:1], torch.roll(ey1, -1, 1))
    em = (idx[None, :] < nverts[:, None]).to(dtype)

    # [N, V, C]: edges x cells
    x1 = ex1[:, :, None]
    y1 = ey1[:, :, None]
    x2 = ex2[:, :, None]
    y2 = ey2[:, :, None]
    x0c = xmin.reshape(N, 1, C)
    x1c = xmax.reshape(N, 1, C)
    y0c = ymin.reshape(N, 1, C)
    y1c = ymax.reshape(N, 1, C)

    dx = x2 - x1
    dy = y2 - y1
    dxs = torch.where(dx == 0, 1.0, dx)
    dys = torch.where(dy == 0, 1.0, dy)
    ta = torch.clamp((x0c - x1) / dxs, 0.0, 1.0)
    tb = torch.clamp((x1c - x1) / dxs, 0.0, 1.0)
    tc = torch.clamp((y0c - y1) / dys, 0.0, 1.0)
    td = torch.clamp((y1c - y1) / dys, 0.0, 1.0)
    # 4-value sort network
    lo1, hi1 = torch.minimum(ta, tb), torch.maximum(ta, tb)
    lo2, hi2 = torch.minimum(tc, td), torch.maximum(tc, td)
    t1 = torch.minimum(lo1, lo2)
    t4 = torch.maximum(hi1, hi2)
    m1, m2 = torch.maximum(lo1, lo2), torch.minimum(hi1, hi2)
    t2 = torch.minimum(m1, m2)
    t3 = torch.maximum(m1, m2)

    def pt(t):
        px = torch.minimum(torch.maximum(x1 + t * dx, x0c), x1c)
        py = torch.minimum(torch.maximum(y1 + t * dy, y0c), y1c)
        return px, py

    acc = None
    prev = pt(torch.zeros_like(t1))
    for t in (t1, t2, t3, t4, torch.ones_like(t1)):
        cur = pt(t)
        cr = prev[0] * cur[1] - cur[0] * prev[1]
        acc = cr if acc is None else acc + cr
        prev = cur
    return acc * em[:, :, None]


def timestep_coupling(
    floes: FloeState,
    grid: RegRectilinearGrid,
    domain: Domain,
    ocean: OceanState,
    atmos: AtmosState,
    consts: Constants,
    coupling_settings: CouplingSettings,
    floe_settings: FloeSettings,
    dt: float,
    cell_cap: int = 16,
    reduce_sums=None,
    window_cells=None,
):
    """timestep_coupling! (coupling.jl:1705-1738).  ``reduce_sums``: see
    calc_two_way_coupling; ``window_cells``: see ``_floe_cell_areas``.

    Returns (floes, ocean, overflow); overflow fires when the interpolation
    window or the two-way cell window lost a point."""
    if coupling_settings.eulerian:
        # Eulerian OA mode: grid-cell forcing instead of sub-floe quadrature
        # points.  The two-way deposition needs points, so it stays a
        # point-path feature.
        floes = calc_eulerian_oa_coupling(
            floes, grid, domain, ocean, atmos, consts, cell_cap, window_cells
        )
        overflow = torch.zeros((), dtype=torch.bool, device=floes.verts.device)
        return floes, ocean, overflow
    # the interpolation node window reuses the two-way cell window's
    # floe-coverage guarantee; +1 node because W nodes bound W-1 cells.
    # Floes spanning a large share of the grid have no window (and no flag)
    W = cell_cap + 1
    ow = calc_one_way_coupling(
        floes, grid, domain, ocean, atmos, consts, window=W if W <= 32 else None,
    )
    overflow = ow.window_ovf
    if coupling_settings.two_way_coupling_on:
        ocean, ovf2 = calc_two_way_coupling(
            ow, grid, domain, ocean, atmos, consts, floe_settings, dt, cell_cap,
            reduce_sums, window_cells,
        )
        overflow = overflow | ovf2
    return ow.floes, ocean, overflow
