"""Floe time integration, stress and strain (port of
``subzero_tpu/physics/update_floe.py``).

The reference integrator (update_floe.jl:469-551): a semi-implicit
Adams-Bashforth-style update with the reference's warn-and-clamp semantics
(factor-of-10 force reduction, velocity caps at h/(2 dt), maximum-xi clamp),
batched over the floe pool.
"""

from __future__ import annotations

import torch

from ..core.domain import Domain, EAST, NORTH, SOUTH, WEST
from ..core.floes import FloeState
from ..geometry.polygon import rotate_about
from ..settings import DecayAreaScaledCalculator, FloeSettings


def update_stress_accum(floes: FloeState, stress_instant, floe_settings: FloeSettings):
    """calc_stress! (update_floe.jl:392-414): EMA accumulation via the
    configured stress calculator (stress_calculators.jl:118-122)."""
    calc = floe_settings.stress_calculator
    if not isinstance(calc, DecayAreaScaledCalculator):
        raise NotImplementedError(type(calc))
    lam = calc.lam
    accum = (1.0 - lam) * floes.stress_accum + lam * stress_instant
    return floes._replace(stress_accum=accum, stress_instant=stress_instant)


def calc_strain(floes: FloeState):
    """calc_strain! (update_floe.jl:425-453), including the reference's
    quirk of using ``u`` for the v-components (lines 441-442, PARITY.md).

    strain = (1/2A) * sym(line integral of velocity differences)."""
    c = floes.centroid
    v = floes.verts - c[:, None, :]
    V = floes.max_verts
    idx = torch.arange(V, device=v.device)
    nv = floes.nverts.long()[:, None]
    last = torch.clamp(nv - 1, min=0)
    nxt = torch.where(idx[None, :] >= nv - 1, 0, idx[None, :] + 1)
    nxt = torch.minimum(nxt, last)
    p1 = v
    p2 = torch.gather(v, 1, nxt[..., None].expand(-1, -1, 2))
    mask = idx[None, :] < nv
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    xdiff, ydiff = x2 - x1, y2 - y1
    u = floes.u[:, None]
    xi = floes.xi[:, None]
    # point velocities (with the v := u quirk)
    u1 = u - xi * y1
    u2 = u - xi * y2
    v1 = u + xi * x1
    v2 = u + xi * x2
    udiff, vdiff = u2 - u1, v2 - v1

    def m(x):
        return torch.sum(torch.where(mask, x, 0.0), dim=1)

    s11 = m(udiff * ydiff)
    s12 = 0.5 * m(udiff * xdiff + vdiff * ydiff)
    s22 = m(vdiff * xdiff)
    denom = 2.0 * torch.where(floes.area > 0, floes.area, 1.0)
    strain = torch.stack(
        [torch.stack([s11, s12], dim=-1), torch.stack([s12, s22], dim=-1)],
        dim=-2,
    ) / denom[:, None, None]
    return floes._replace(strain=strain)


def timestep_floe_properties(
    floes: FloeState,
    dt: float,
    floe_settings: FloeSettings,
    stress_instant=None,
) -> FloeState:
    """The time integrator (update_floe.jl:469-551), batched."""
    act = floes.active
    if stress_instant is None:
        stress_instant = torch.zeros_like(floes.stress_accum)
    floes = update_stress_accum(floes, stress_instant, floe_settings)

    # height cap (:482-485)
    height = torch.clamp(floes.height, max=floe_settings.max_floe_height)

    # collision-force reduction loop (:487-491): F /= 10 until
    # max|F| <= mass/(5 dt); closed form of the while loop
    cforce = floes.collision_force
    ctrq = floes.collision_trq
    mass_safe = torch.where(floes.mass > 0, floes.mass, 1.0)
    peak = torch.amax(torch.abs(cforce), dim=-1)
    limit = mass_safe / (5.0 * dt)
    ratio = peak / limit
    k = torch.where(
        ratio > 1.0,
        torch.ceil(torch.log10(torch.clamp(ratio, min=1.0 + 1e-300))),
        0.0,
    )
    # exact-boundary guard: after k-1 divisions the loop would stop if
    # peak/10^(k-1) == limit exactly (condition is strict >)
    km1 = torch.clamp(k - 1, min=0.0)
    k = torch.where(ratio / torch.pow(10.0, km1) <= 1.0, km1, k)
    scale = torch.pow(10.0, -k)
    cforce = cforce * scale[:, None]
    ctrq = ctrq * scale

    # thermodynamic height change (:493-500)
    h_safe = torch.where(height > 0, height, 1.0)
    dh = floes.hflx_factor / h_safe
    hfrac = (height + dh) / h_safe
    mass = floes.mass * torch.where(act, hfrac, 1.0)
    moment = floes.moment * torch.where(act, hfrac, 1.0)
    height = torch.where(act, height - dh, height)
    h = height

    # move floes (:503-511)
    dx = 1.5 * dt * floes.u - 0.5 * dt * floes.p_dxdt
    dy = 1.5 * dt * floes.v - 0.5 * dt * floes.p_dydt
    dalpha = 1.5 * dt * floes.xi - 0.5 * dt * floes.p_dalphadt
    dx = torch.where(act, dx, 0.0)
    dy = torch.where(act, dy, 0.0)
    dalpha = torch.where(act, dalpha, 0.0)
    alpha = floes.alpha + dalpha
    verts = rotate_about(floes.verts, floes.centroid, dalpha)
    shift = torch.stack([dx, dy], dim=-1)
    verts = verts + shift[:, None, :]
    centroid = floes.centroid + shift
    p_dxdt = floes.u
    p_dydt = floes.v
    p_dalphadt = floes.xi

    # acceleration with velocity caps (:513-531)
    mass_safe = torch.where(mass > 0, mass, 1.0)
    dudt = (floes.fx_oa + cforce[:, 0]) / mass_safe
    dvdt = (floes.fy_oa + cforce[:, 1]) / mass_safe
    cap = h / (2.0 * dt)
    exceed_u = torch.abs(dt * dudt) > h / 2
    exceed_v = torch.abs(dt * dvdt) > h / 2
    dudt_safe = torch.where(dudt == 0, 1.0, dudt)
    dvdt_safe = torch.where(dvdt == 0, 1.0, dvdt)
    frac1 = torch.sign(dudt) * cap / dudt_safe
    frac2 = torch.sign(dvdt) * cap / dvdt_safe
    frac = torch.where(
        exceed_u & exceed_v,
        torch.minimum(frac1, frac2),
        torch.where(exceed_u, frac1, torch.where(exceed_v, frac2, 1.0)),
    )
    dudt = frac * dudt
    dvdt = frac * dvdt
    u = floes.u + 1.5 * dt * dudt - 0.5 * dt * floes.p_dudt
    v = floes.v + 1.5 * dt * dvdt - 0.5 * dt * floes.p_dvdt

    # angular acceleration (:537-545)
    moment_safe = torch.where(moment > 0, moment, 1.0)
    dxidt = (floes.trq_oa + ctrq) / moment_safe
    dxidt = frac * dxidt
    xi = floes.xi + 1.5 * dt * dxidt - 0.5 * dt * floes.p_dxidt
    xi = torch.clamp(xi, -floe_settings.maximum_xi, floe_settings.maximum_xi)

    def keep(new, old):
        return torch.where(act.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

    floes = floes._replace(
        verts=keep(verts, floes.verts),
        centroid=keep(centroid, floes.centroid),
        height=keep(height, floes.height),
        mass=keep(mass, floes.mass),
        moment=keep(moment, floes.moment),
        alpha=keep(alpha, floes.alpha),
        u=keep(u, floes.u),
        v=keep(v, floes.v),
        xi=keep(xi, floes.xi),
        p_dxdt=keep(p_dxdt, floes.p_dxdt),
        p_dydt=keep(p_dydt, floes.p_dydt),
        p_dalphadt=keep(p_dalphadt, floes.p_dalphadt),
        p_dudt=keep(dudt, floes.p_dudt),
        p_dvdt=keep(dvdt, floes.p_dvdt),
        p_dxidt=keep(dxidt, floes.p_dxidt),
    )
    return calc_strain(floes)


def wrap_periodic(floes: FloeState, domain: Domain) -> FloeState:
    """Translate floes whose centroid left the domain through a periodic
    boundary back inside (replaces the reference's parent/ghost swap,
    collisions.jl:925-1003)."""
    cx = floes.centroid[:, 0]
    cy = floes.centroid[:, 1]
    n, s, e, w = domain.vals[NORTH], domain.vals[SOUTH], domain.vals[EAST], domain.vals[WEST]
    shift_x = torch.zeros_like(cx)
    shift_y = torch.zeros_like(cy)
    if domain.ew_periodic:
        Lx = e - w
        shift_x = torch.where(cx < w, Lx, torch.where(cx > e, -Lx, 0.0))
    if domain.ns_periodic:
        Ly = n - s
        shift_y = torch.where(cy < s, Ly, torch.where(cy > n, -Ly, 0.0))
    shift = torch.stack([shift_x, shift_y], dim=-1)
    shift = torch.where(floes.active[:, None], shift, 0.0)
    return floes._replace(
        verts=floes.verts + shift[:, None, :],
        centroid=floes.centroid + shift,
    )
