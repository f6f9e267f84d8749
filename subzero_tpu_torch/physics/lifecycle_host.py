"""Host-orchestrated floe life-cycle processes: fracture, fusing/welding,
smoothing, ridging/rafting.

Port of ``subzero_tpu/physics/lifecycle_host.py``: numpy on the host, the
same formulas, branch structure and order of random draws.  These processes
change floe *topology* (polygons split, merge, lose vertices) at low cadence
(every 20-150 steps in the example configs), so they run as host passes
between device steps: the pool is pulled to numpy in one pass
(``HostFloes``), modified with the exact polygon booleans of
geometry/host_clip, and pushed back to the pool's own device and dtypes.

Semantics follow the Julia model's files (formulas and branch structure):
  * fracture    - physical_processes/fractures.jl
  * fuse/smooth - physical_processes/simplification.jl
  * welding     - physical_processes/welding.jl
  * ridge/raft  - physical_processes/ridge_raft.jl
  * momentum bookkeeping - update_floe.jl:102-342
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..geometry import host_clip
from ..geometry.host_clip import poly_area_np, poly_centroid_np
from ..core.domain import Domain, BoundaryKind, NORTH, SOUTH, EAST, WEST
from ..core.floes import (
    FloeState,
    subfloe_points_for_ring,
)
from ..core.init import voronoi_cells_in_box
from ..settings import (
    FloeSettings,
    FractureSettings,
    HiblerYieldCurve,
    MohrsCone,
    MonteCarloPointsGenerator,
    RidgeRaftSettings,
    SimplificationSettings,
    SubGridPointsGenerator,
    WeldSettings,
)


# ---------------------------------------------------------------------------
# host pool wrapper
# ---------------------------------------------------------------------------

class HostFloes:
    """Mutable numpy mirror of a FloeState pool.  Its build from the
    device's pool is the host span ``pool.pull``, and ``to_state``, the
    copy back, is ``pool.push`` (``tracing.span``)."""

    def __init__(self, floes: FloeState):
        with tracing.span("pool.pull"):
            self._pull(floes)

    def _pull(self, floes: FloeState) -> None:
        self.device = floes.verts.device
        items = floes._asdict()
        self.torch_dtypes = {k: v.dtype for k, v in items.items()}
        # one pass over the pool: the fields of one dtype cross to the host
        # as one flat tensor (three transfers instead of one a field), and
        # each field gets its own array, so edits never reach the tensors
        # the pool came from
        self.fields = {}
        for dtype in dict.fromkeys(self.torch_dtypes.values()):
            keys = [k for k, d in self.torch_dtypes.items() if d == dtype]
            flat = torch.cat([items[k].detach().reshape(-1) for k in keys]).cpu().numpy()
            sizes = np.cumsum([items[k].numel() for k in keys])[:-1]
            for k, part in zip(keys, np.split(flat, sizes)):
                self.fields[k] = part.reshape(tuple(items[k].shape)).copy()
        self.fields = {k: self.fields[k] for k in items}  # the pool's field order
        self.dtype = self.fields["verts"].dtype
        self.V = floes.max_verts
        self.P = floes.max_sub

    def __getattr__(self, k):
        f = self.__dict__.get("fields")
        if f is not None and k in f:
            return f[k]
        raise AttributeError(k)

    def ring(self, i):
        return self.fields["verts"][i, : self.fields["nverts"][i]].astype(float)

    def free_slot(self) -> Optional[int]:
        idx = np.nonzero(~self.fields["active"])[0]
        return int(idx[0]) if len(idx) else None

    def to_state(self) -> FloeState:
        """The pool back on its device in its dtypes, one transfer a dtype."""
        with tracing.span("pool.push"):
            return self._push()

    def _push(self) -> FloeState:
        out = {}
        for dtype in dict.fromkeys(self.torch_dtypes.values()):
            keys = [k for k, d in self.torch_dtypes.items() if d == dtype]
            parts = [np.ascontiguousarray(self.fields[k]).reshape(-1) for k in keys]
            flat = torch.as_tensor(np.concatenate(parts), dtype=dtype).to(self.device)
            for k, part in zip(keys, torch.split(flat, [p.size for p in parts])):
                # its own storage (the narrow phase wants aligned pools)
                out[k] = part.reshape(self.fields[k].shape).clone()
        return FloeState(**out)

    # -- reference: replace_floe! (update_floe.jl:26-68) -------------------
    def replace_floe(self, i, ring, new_mass, fs: FloeSettings, rng):
        ring = host_clip._clean_ring(np.asarray(ring, float))
        if len(ring) > self.V:
            ring = _decimate_ring(ring, self.V)
        f = self.fields
        area = poly_area_np(ring)
        cent = poly_centroid_np(ring)
        height = new_mass / (area * fs.rho_i)
        f["verts"][i] = np.concatenate(
            [ring, np.repeat(ring[-1:], self.V - len(ring), axis=0)]
        )
        f["nverts"][i] = len(ring)
        f["centroid"][i] = cent
        f["area"][i] = area
        f["height"][i] = height
        f["mass"][i] = new_mass
        f["moment"][i] = _moment_inertia_np(ring, cent, height, fs.rho_i)
        f["rmax"][i] = np.sqrt(((ring - cent) ** 2).sum(axis=1).max())
        f["alpha"][i] = 0.0
        ok = self._regen_subfloe_points(i, ring, cent, area, fs, rng)
        if not ok:
            f["remove"][i] = True

    def _regen_subfloe_points(self, i, ring, cent, area, fs, rng):
        body = ring - cent
        gen = fs.subfloe_point_generator
        mx, my = subfloe_points_for_ring(body, area, gen, rng)
        if mx is None:
            return False
        if len(mx) > self.P:
            sel = rng.choice(len(mx), self.P, replace=False)
            mx, my = mx[sel], my[sel]
        f = self.fields
        f["sub_x"][i] = 0.0
        f["sub_y"][i] = 0.0
        f["sub_x"][i, : len(mx)] = mx
        f["sub_y"][i, : len(my)] = my
        f["nsub"][i] = len(mx)
        return True

    def add_floe(self, ring, fs: FloeSettings, rng, mass=None, **kw):
        """Create a floe in a free slot; returns slot index or None if the
        pool is full (caller should warn)."""
        slot = self.free_slot()
        if slot is None:
            return None
        f = self.fields
        # zero the slot
        for k, v in f.items():
            v[slot] = 0 if v.dtype != bool else False
        f["fuse_with"][slot] = -1
        ring = host_clip._clean_ring(np.asarray(ring, float))
        if mass is None:
            mass = poly_area_np(ring) * kw.get("height", 0.25) * fs.rho_i
        self.replace_floe(slot, ring, mass, fs, rng)
        f["active"][slot] = True
        for k, v in kw.items():
            if k in f:
                f[k][slot] = v
        return slot


def _decimate_ring(ring, max_v):
    """Greedy smallest-deviation vertex removal until ring fits capacity."""
    ring = list(map(np.asarray, ring))
    while len(ring) > max_v:
        n = len(ring)
        best, bestd = 0, np.inf
        for k in range(n):
            p0, p1, p2 = ring[k - 1], ring[k], ring[(k + 1) % n]
            seg = p2 - p0
            rel = p1 - p0
            d = abs(seg[0] * rel[1] - seg[1] * rel[0]) / max(
                np.linalg.norm(seg), 1e-12
            )
            if d < bestd:
                best, bestd = k, d
        ring.pop(best)
    return np.asarray(ring)


def _moment_inertia_np(ring, cent, height, rho_i):
    """Reference _calc_moment_inertia (floe_utils.jl:273-298), incl. its
    double-centroid-shift quirk."""
    xc, yc = cent
    pts = np.concatenate([ring, ring[:1]], axis=0) - cent
    x1, y1 = pts[:-1, 0], pts[:-1, 1]
    x2, y2 = pts[1:, 0], pts[1:, 1]
    w = (x1 - xc) * (y2 - yc) - (x2 - xc) * (y1 - yc)
    Ixx = np.sum(w * (y1 * y1 + y1 * y2 + y2 * y2)) / 12.0
    Iyy = np.sum(w * (x1 * x1 + x1 * x2 + x2 * x2)) / 12.0
    return abs(Ixx + Iyy) * height * rho_i


# ---------------------------------------------------------------------------
# momentum bookkeeping (update_floe.jl:102-342)
# ---------------------------------------------------------------------------

def conserve_momentum_change_floe_shape(
    mass_tmp, moment_tmp, x_tmp, y_tmp, dt, hf: HostFloes, keep, combine=None
):
    f = hf.fields
    new_u = f["u"][keep] * mass_tmp
    new_v = f["v"][keep] * mass_tmp
    new_dxdt = f["p_dxdt"][keep] * mass_tmp
    new_dydt = f["p_dydt"][keep] * mass_tmp
    if combine is not None:
        cm = f["mass"][combine]
        new_u += f["u"][combine] * cm
        new_v += f["v"][combine] * cm
        new_dxdt += f["p_dxdt"][combine] * cm
        new_dydt += f["p_dydt"][combine] * cm
    m_new = f["mass"][keep]
    new_u /= m_new
    new_v /= m_new
    new_dxdt /= m_new
    new_dydt /= m_new
    p_x = x_tmp - dt * f["p_dxdt"][keep]
    p_y = y_tmp - dt * f["p_dydt"][keep]
    new_xi = f["xi"][keep] * moment_tmp + mass_tmp * (
        x_tmp * f["v"][keep] - y_tmp * f["u"][keep]
    )
    new_dadt = f["p_dalphadt"][keep] * moment_tmp + mass_tmp * (
        p_x * f["p_dydt"][keep] - p_y * f["p_dxdt"][keep]
    )
    if combine is not None:
        cm = f["mass"][combine]
        cx, cy = f["centroid"][combine]
        p_x = cx - dt * f["p_dxdt"][combine]
        p_y = cy - dt * f["p_dydt"][combine]
        new_xi += f["xi"][combine] * f["moment"][combine] + cm * (
            cx * f["v"][combine] - cy * f["u"][combine]
        )
        new_dadt += f["p_dalphadt"][combine] * f["moment"][combine] + cm * (
            p_x * f["p_dydt"][combine] - p_y * f["p_dxdt"][combine]
        )
    kx, ky = f["centroid"][keep]
    p_x = kx - dt * new_dxdt
    p_y = ky - dt * new_dydt
    new_xi -= m_new * (kx * new_v - ky * new_u)
    new_dadt -= m_new * (p_x * new_dydt - p_y * new_dxdt)
    new_xi /= f["moment"][keep]
    new_dadt /= f["moment"][keep]
    f["u"][keep] = new_u
    f["v"][keep] = new_v
    f["xi"][keep] = new_xi
    f["p_dxdt"][keep] = new_dxdt
    f["p_dydt"][keep] = new_dydt
    f["p_dalphadt"][keep] = new_dadt
    f["p_dudt"][keep] = (new_u - new_dxdt) / dt
    f["p_dvdt"][keep] = (new_v - new_dydt) / dt
    f["p_dxidt"][keep] = (new_xi - new_dadt) / dt


def conserve_momentum_transfer_mass(hf: HostFloes, i1, i2, m1, m2, dt, extra=()):
    """update_floe.jl:305-342: mass-weighted common linear velocity."""
    f = hf.fields
    tot = m1 + m2
    new_u = (m1 * f["u"][i1] + m2 * f["u"][i2]) / tot
    new_v = (m1 * f["v"][i1] + m2 * f["v"][i2]) / tot
    new_pdx = (m1 * f["p_dxdt"][i1] + m2 * f["p_dxdt"][i2]) / tot
    new_pdy = (m1 * f["p_dydt"][i1] + m2 * f["p_dydt"][i2]) / tot
    new_pdu = (f["u"][i1] - f["p_dxdt"][i1]) / dt
    new_pdv = (f["v"][i1] - f["p_dydt"][i1]) / dt
    for idx in (i1, i2, *extra):
        f["u"][idx] = new_u
        f["v"][idx] = new_v
        f["p_dxdt"][idx] = new_pdx
        f["p_dydt"][idx] = new_pdy
        f["p_dudt"][idx] = new_pdu
        f["p_dvdt"][idx] = new_pdv
        f["p_dalphadt"][idx] = 0.0


def update_new_rotation_conserve(
    hf: HostFloes, i1, i2, x, y,
    init_rot_momentum, init_p_rot_momentum,
    diff_orbital, diff_p_orbital, dt,
):
    """update_new_rotation_conserve! (update_floe.jl:205-233): solve the
    pair's rotational velocities so angular momentum is conserved and the
    shared point (x, y) is stationary (equal and opposite tangential
    velocities, with radius-ratio weighting)."""
    f = hf.fields
    rad1 = np.hypot(f["centroid"][i1][0] - x, f["centroid"][i1][1] - y)
    rad2 = np.hypot(f["centroid"][i2][0] - x, f["centroid"][i2][1] - y)
    rr = rad1 / rad2
    denom = f["moment"][i1] - f["moment"][i2] * rr
    f["xi"][i1] = (diff_orbital + init_rot_momentum) / denom
    f["xi"][i2] = -f["xi"][i1] * rr
    f["p_dalphadt"][i1] = (diff_p_orbital + init_p_rot_momentum) / denom
    f["p_dalphadt"][i2] = -f["p_dalphadt"][i1] * rr
    f["p_dxidt"][i1] = (f["xi"][i1] - f["p_dalphadt"][i1]) / dt
    f["p_dxidt"][i2] = (f["xi"][i2] - f["p_dalphadt"][i2]) / dt


# ---------------------------------------------------------------------------
# fracture (fractures.jl)
# ---------------------------------------------------------------------------

def hibler_yield_ellipse(mean_height, pstar, c, npts=100):
    """_calculate_hibler (fractures.jl:83-94): ellipse in principal-stress
    space, rotated 45 deg and shifted to (-p/2, -p/2)."""
    compactness = 1.0
    p = pstar * mean_height * math.exp(-c * (1 - compactness))
    alphas = np.linspace(0, 2 * np.pi, npts)
    a = p * math.sqrt(2) / 2
    b = a / 2
    x = a * np.cos(alphas)
    y = b * np.sin(alphas)
    ca, sa = math.cos(np.pi / 4), math.sin(np.pi / 4)
    xr = ca * x - sa * y - p / 2
    yr = sa * x + ca * y - p / 2
    return np.stack([xr, yr], axis=-1)[:-1]


def mohrs_cone_vertices(q=5.2, sigma_c=2.5e5, sigma_11=-3.375e4):
    """_calculate_mohrs (fractures.jl:170-214)."""
    s1 = ((1 / q) + 1) * sigma_c / ((1 / q) - q)
    s2 = q * s1 + sigma_c
    s22 = q * sigma_11 + sigma_c
    return np.array([[-s1, -s2], [-sigma_11, -s22], [-s22, -sigma_11]])


def criteria_polygon(criteria, heights):
    if isinstance(criteria, HiblerYieldCurve):
        return hibler_yield_ellipse(float(np.mean(heights)), criteria.pstar, criteria.c)
    if isinstance(criteria, MohrsCone):
        return mohrs_cone_vertices(criteria.q, criteria.sigma_c, criteria.sigma_11)
    raise NotImplementedError(type(criteria))


def _points_in_ring(pts, ring):
    """Vectorized even-odd ray cast: [K, 2] points vs one ring.  Same
    semantics as host_clip._point_in (exclusive of the edge), batched -
    the per-floe Python loop dominated a fracture pass at N >= 2k."""
    pts = np.asarray(pts, float)
    ring = np.asarray(ring, float)
    x1, y1 = ring[:, 0], ring[:, 1]
    x2 = np.roll(x1, -1)
    y2 = np.roll(y1, -1)
    x = pts[:, 0][:, None]
    y = pts[:, 1][:, None]
    straddle = (y1[None, :] > y) != (y2[None, :] > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xin = x1[None, :] + (y - y1[None, :]) / (y2 - y1)[None, :] * (
            x2 - x1
        )[None, :]
    hits = straddle & (x < xin)
    return np.sum(hits, axis=1) % 2 == 1


def determine_fractures(hf: HostFloes, criteria, fs: FloeSettings):
    """fractures.jl:269-288: floes whose accumulated-stress eigenvalues fall
    outside the criteria polygon (and that are big enough)."""
    f = hf.fields
    act = f["active"] & ~f["remove"]
    idxs = np.nonzero(act)[0]
    if len(idxs) == 0:
        return []
    poly = criteria_polygon(criteria, f["height"][idxs])
    # principal-stress area scaling (_scale_principal_stress!,
    # stress_calculators.jl:127-132): sigma_vals *= (area/min_area)^alpha;
    # equivalent to scaling the fracture criteria, cheaper to apply here
    alpha = getattr(fs.stress_calculator, "alpha", 0.0)
    big = np.asarray(f["area"])[idxs] >= fs.min_floe_area
    evals = np.linalg.eigvalsh(
        np.asarray(f["stress_accum"], float)[idxs]
    )  # [K, 2] ascending
    if alpha != 0.0:
        evals = evals * (
            (np.asarray(f["area"], float)[idxs] / fs.min_floe_area) ** alpha
        )[:, None]
    inside = _points_in_ring(evals, poly)
    return [int(i) for i in idxs[big & ~inside]]


def split_floe(hf: HostFloes, i, rng, frac_settings, fs: FloeSettings, dt):
    """fractures.jl:379-438: Voronoi split of a floe, conserving mass and
    (linear) momentum. Returns list of new rings + per-ring heights."""
    f = hf.fields
    ring = hf.ring(i)
    rmax = f["rmax"][i]
    cx, cy = f["centroid"][i]
    lo = np.array([cx - rmax, cy - rmax])
    scale = 2 * rmax
    # rejection-sample seeds inside the floe (generate_voronoi_coords analog)
    seeds = []
    for _ in range(10):
        pts = lo + rng.random((frac_settings.npieces * 10, 2)) * scale
        for p in pts:
            if host_clip._point_in(p, ring):
                seeds.append(p)
            if len(seeds) >= frac_settings.npieces:
                break
        if len(seeds) >= frac_settings.npieces:
            break
    if len(seeds) < 2:
        return []
    seeds = np.asarray(seeds[: frac_settings.npieces])
    cells = voronoi_cells_in_box(seeds, lo, lo + scale)
    pieces = []
    for cell in cells:
        try:
            pieces.extend(host_clip.intersect(ring, cell))
        except RuntimeError as e:
            # unresolvable clip degeneracy (every perturbation retry
            # failed): drop this Voronoi cell rather than kill the run -
            # mass stays conserved because the parent's mass is split
            # proportionally over the pieces that DID resolve (same
            # skip-and-warn policy as the ridge/raft overlap removal)
            warnings.warn(f"fracture piece clip skipped: {e}")
    areas = [poly_area_np(p) for p in pieces]
    total = sum(areas)
    if total <= 0:
        return []
    out = []
    for p, a in zip(pieces, areas):
        if a <= 0:
            continue
        mass = f["mass"][i] * (a / total)
        height = mass / (fs.rho_i * a)
        if a >= fs.min_floe_area and a > 0:
            out.append((p, mass))
    return out


def deform_floe(
    hf: HostFloes, i, deformer_ring, fs: FloeSettings, dt, rng, forces=None,
):
    """deform_floe! (fractures.jl:310-357): carve the largest-overlap
    collision site out of a fracturing floe before splitting it.

    ``forces`` is the recorded contact force (fx, fy) on floe i from the
    deformer (the reference's ``deforming_forces``,
    interactions[max_overlap_idx, xforce:yforce]); the deformer is displaced
    |signed_distance| / 2 along it before the difference is taken.  Without
    a force row the centroid-to-centroid axis (same orientation) stands in.
    """
    f = hf.fields
    ring = hf.ring(i)
    regions = host_clip.intersect(ring, deformer_ring)
    if not regions:
        return
    areas = [poly_area_np(r) for r in regions]
    region = regions[int(np.argmax(areas))]
    if max(areas) <= 0:
        return
    rc = poly_centroid_np(region)
    # distance from region centroid to region boundary
    dmin = np.inf
    n = len(region)
    for k in range(n):
        a, b = region[k], region[(k + 1) % n]
        seg = b - a
        L2 = seg @ seg
        t = np.clip(((rc - a) @ seg) / max(L2, 1e-30), 0, 1)
        dmin = min(dmin, np.linalg.norm(rc - (a + t * seg)))
    if forces is not None:
        dc = np.asarray(forces, float)
    else:
        dc = poly_centroid_np(ring) - poly_centroid_np(deformer_ring)
    nrm = np.linalg.norm(dc)
    if nrm == 0:
        return
    delta = abs(dmin) * dc / (2 * nrm)
    moved = deformer_ring + delta
    pieces = host_clip.difference(ring, moved)
    if not pieces:
        return
    p_areas = [poly_area_np(p) for p in pieces]
    best = int(np.argmax(p_areas))
    if p_areas[best] > 0 and p_areas[best] / f["area"][i] > 0.9:
        moment_tmp = f["moment"][i]
        x_tmp, y_tmp = f["centroid"][i]
        hf.replace_floe(i, pieces[best], f["mass"][i], fs, rng)
        conserve_momentum_change_floe_shape(
            f["mass"][i], moment_tmp, x_tmp, y_tmp, dt, hf, i
        )


def fracture_floes(
    floes: FloeState,
    max_floe_id: int,
    rng,
    frac_settings: FractureSettings,
    fs: FloeSettings,
    dt,
    overlaps=None,
):
    """fracture_floes! (fractures.jl:461-532). Returns (FloeState, max_id).

    ``overlaps``: optional list of interaction rows from the collision
    step, used to pick each fracturing floe's largest-overlap deformer when
    ``deform_on`` is set: either (i, j, area) triples (deformer direction
    falls back to the centroid axis) or (i, j, area, fx, fy) rows carrying
    the recorded contact force on floe i, which then drives the deformer
    displacement direction exactly like the reference (fractures.jl:482-507
    passes interactions[max_overlap_idx, xforce:yforce] to deform_floe!).
    """
    hf = HostFloes(floes)
    frac_idx = determine_fractures(hf, frac_settings.criteria, fs)
    if not frac_idx:
        return floes, max_floe_id
    f = hf.fields
    deformer_of = {}
    if frac_settings.deform_on and overlaps:
        best = {}
        for row in overlaps:
            i, j, a = row[0], row[1], row[2]
            force = (float(row[3]), float(row[4])) if len(row) >= 5 else None
            if j >= 0 and a > best.get(i, (0.0, -1, None))[0]:
                best[int(i)] = (float(a), int(j), force)
        deformer_of = {i: (j, fo) for i, (a, j, fo) in best.items()}
    for i in frac_idx:
        if frac_settings.deform_on and i in deformer_of:
            j, force = deformer_of[i]
            deform_floe(hf, i, hf.ring(j), fs, dt, rng, forces=force)
        pieces = split_floe(hf, i, rng, frac_settings, fs, dt)
        if not pieces:
            continue
        parent = {
            k: np.copy(f[k][i])
            for k in (
                "u", "v", "xi", "p_dxdt", "p_dydt", "p_dudt", "p_dvdt",
                "p_dxidt", "strain", "id",
            )
        }
        # remove parent, then add pieces inheriting parent kinematics
        f["active"][i] = False
        for ring, mass in pieces:
            slot = hf.add_floe(ring, fs, rng, mass=mass)
            if slot is None:
                warnings.warn("floe pool full during fracture; piece dropped")
                break
            max_floe_id += 1
            f["id"][slot] = max_floe_id
            f["parent_id"][slot] = parent["id"]
            # conserve_momentum_fracture_floe! (update_floe.jl:254-274)
            for k in ("u", "v", "xi", "p_dxdt", "p_dydt", "p_dudt", "p_dvdt"):
                f[k][slot] = parent[k]
            f["p_dalphadt"][slot] = 0.0
            f["p_dxidt"][slot] = parent["p_dxidt"]
            f["strain"][slot] = parent["strain"]
    return hf.to_state(), max_floe_id


# ---------------------------------------------------------------------------
# fuse + smooth + welding (simplification.jl, welding.jl)
# ---------------------------------------------------------------------------

def fuse_two_floes(hf: HostFloes, keep, rem, dt, fs, prefuse_max_id, rng):
    """fuse_two_floes! (simplification.jl:146-204)."""
    f = hf.fields
    merged = host_clip.union(hf.ring(keep), hf.ring(rem))
    if len(merged) != 1:
        return False
    mass_tmp = f["mass"][keep]
    moment_tmp = f["moment"][keep]
    x_tmp, y_tmp = f["centroid"][keep]
    new_mass = f["mass"][keep] + f["mass"][rem]
    self_stress_a = np.copy(f["stress_accum"][keep])
    self_stress_i = np.copy(f["stress_instant"][keep])
    hf.replace_floe(keep, merged[0], new_mass, fs, rng)
    conserve_momentum_change_floe_shape(
        mass_tmp, moment_tmp, x_tmp, y_tmp, dt, hf, keep, rem
    )
    f["stress_accum"][keep] = (
        self_stress_a * mass_tmp + f["stress_accum"][rem] * f["mass"][rem]
    ) / f["mass"][keep]
    f["stress_instant"][keep] = (
        self_stress_i * mass_tmp + f["stress_instant"][rem] * f["mass"][rem]
    ) / f["mass"][keep]
    f["remove"][rem] = True
    f["active"][rem] = False
    if 0 < f["id"][keep] <= prefuse_max_id:
        f["parent_id"][keep] = f["id"][keep]
    return True


def fuse_floes(floes: FloeState, max_floe_id, fs, dt, rng):
    """fuse_floes! (simplification.jl:226-256): fuse pairs marked by the
    collision step (fuse_with). Keep the larger floe."""
    if not bool(torch.any(floes.fuse_with >= 0)):
        return floes, max_floe_id
    hf = HostFloes(floes)
    f = hf.fields
    prefuse = max_floe_id
    for i in np.nonzero(f["fuse_with"] >= 0)[0]:
        j = int(f["fuse_with"][i])
        if not f["active"][i] or not f["active"][j]:
            continue
        keep, rem = (j, i) if f["area"][i] < f["area"][j] else (i, j)
        if fuse_two_floes(hf, keep, rem, dt, fs, prefuse, rng):
            max_floe_id += 1
            f["id"][keep] = max_floe_id
        f["fuse_with"][i] = -1
        f["fuse_with"][j] = -1
    f["fuse_with"][:] = -1
    return hf.to_state(), max_floe_id


def smooth_floes(
    floes: FloeState,
    simp_settings: SimplificationSettings,
    fs: FloeSettings,
    dt,
    rng,
    max_overlap_frac: float = 0.55,
):
    """smooth_floes! (simplification.jl:56-121): Douglas-Peucker style vertex
    reduction for floes over max_vertices, conserving mass and momentum.
    If the smoothed shape overlaps a neighbor by more than
    ``max_overlap_frac`` of the neighbor's area, the pair is marked for
    fusion (simplification.jl:99-118)."""
    nv = floes.nverts.cpu().numpy()
    act = floes.active.cpu().numpy()
    over = act & (nv > simp_settings.max_vertices)
    if not over.any():
        return floes
    hf = HostFloes(floes)
    f = hf.fields
    for i in np.nonzero(over)[0]:
        ring = hf.ring(i)
        simp = _rdp(ring, simp_settings.tol)
        if len(simp) < 3:
            continue
        moment_tmp = f["moment"][i]
        x_tmp, y_tmp = f["centroid"][i]
        hf.replace_floe(i, simp, f["mass"][i], fs, rng)
        conserve_momentum_change_floe_shape(
            f["mass"][i], moment_tmp, x_tmp, y_tmp, dt, hf, i
        )
        # post-smoothing overlap check against bounding-circle neighbors:
        # numpy circle prefilter + one batched native boolean call per
        # smoothed floe (simplification.jl:99-118) - no O(N) Python loop
        cand = f["active"] & ~f["remove"]
        cand[i] = False
        dc = f["centroid"] - f["centroid"][i]
        cand &= (dc * dc).sum(axis=1) < (f["rmax"] + f["rmax"][i]) ** 2
        js = np.nonzero(cand)[0]
        if len(js):
            inter = _pair_inter_areas(hf, np.full(len(js), i), js)
            over_j = np.nonzero(inter / f["area"][js] > max_overlap_frac)[0]
            if len(over_j):
                f["fuse_with"][i] = js[over_j[-1]]  # last partner wins
    return hf.to_state()


def _pair_inter_areas(hf: HostFloes, ia, ja):
    """Intersection areas for floe index pairs of a host pool.

    One batched call into the native C++ kernel
    (native.pairwise_intersect_area) when available; pairs the native kernel
    flags as unresolvably degenerate (-1), and the whole batch when the
    library is absent, fall back to the per-pair host booleans.  This is
    what keeps the welding / smooth-overlap host passes free of per-pair
    Python boolean calls (welding.jl:136-142, simplification.jl:99-118)."""
    ia = np.asarray(ia, np.int32)
    ja = np.asarray(ja, np.int32)
    if len(ia) == 0:
        return np.zeros((0,), float)
    from .. import native

    res = native.pairwise_intersect_area(
        hf.fields["verts"], hf.fields["nverts"], ia, ja
    )
    if res is not None:
        out = np.asarray(res, float)
        bad = out < 0
    else:
        out = np.full((len(ia),), -1.0)
        bad = np.ones((len(ia),), bool)
    for k in np.nonzero(bad)[0]:
        out[k] = sum(
            poly_area_np(p)
            for p in host_clip.intersect(hf.ring(int(ia[k])), hf.ring(int(ja[k])))
        )
    return out


def _rdp(ring, tol):
    """Ramer-Douglas-Peucker on a closed ring (split at two extremes)."""
    pts = np.asarray(ring, float)
    n = len(pts)
    # split at the two farthest-apart vertices
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    a, b = np.unravel_index(np.argmax(d2), d2.shape)
    if a > b:
        a, b = b, a
    chain1 = pts[a : b + 1]
    chain2 = np.concatenate([pts[b:], pts[: a + 1]], axis=0)

    def rdp_open(chain):
        if len(chain) <= 2:
            return chain
        p0, p1 = chain[0], chain[-1]
        seg = p1 - p0
        L = np.linalg.norm(seg)
        if L == 0:
            d = np.linalg.norm(chain - p0, axis=1)
        else:
            rel = chain - p0
            d = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / L
        k = int(np.argmax(d))
        if d[k] > tol:
            left = rdp_open(chain[: k + 1])
            right = rdp_open(chain[k:])
            return np.concatenate([left[:-1], right], axis=0)
        return np.stack([p0, p1])

    c1 = rdp_open(chain1)
    c2 = rdp_open(chain2)
    return np.concatenate([c1[:-1], c2[:-1]], axis=0)


def timestep_welding(
    floes: FloeState,
    max_floe_id,
    grid,
    domain,
    weld_settings: WeldSettings,
    fs: FloeSettings,
    weld_idx: int,
    dt,
    rng,
):
    """timestep_welding! (welding.jl:91-182)."""
    hf = HostFloes(floes)
    f = hf.fields
    Nx = weld_settings.nxs[weld_idx]
    Ny = weld_settings.nys[weld_idx]
    dx = (grid.xf - grid.x0) / Nx
    dy = (grid.yf - grid.y0) / Ny
    act = np.nonzero(f["active"])[0]
    bins = {}
    for i in act:
        x, y = f["centroid"][i]
        xi_ = int(np.clip((x - grid.x0) // dx, 0, Nx - 1))
        yi_ = int(np.clip((y - grid.y0) // dy, 0, Ny - 1))
        bins.setdefault((xi_, yi_), []).append(int(i))
    prefuse = max_floe_id
    gainers = []  # deferred id assignment (welding.jl:169-180)
    for _, bin_list in bins.items():
        # Batched precompute of candidate-pair intersection areas: one
        # native boolean call per bin instead of one Python boolean per pair
        # (welding.jl:136-142).  Pairs touched by a weld since the precompute
        # ("dirty") are recomputed individually so results are identical to
        # the lazy per-pair evaluation.
        bl = np.asarray(bin_list, dtype=np.int64)
        pre_ok = f["active"][bl] & (f["area"][bl] < weld_settings.max_weld_area)
        blv = bl[pre_ok]
        cache = {}
        if len(blv) >= 2:
            ci = f["centroid"][blv]
            rr = f["rmax"][blv]
            d2 = ((ci[:, None, :] - ci[None, :, :]) ** 2).sum(-1)
            near = np.triu(d2 < (rr[:, None] + rr[None, :]) ** 2, k=1)
            ii, jj = np.nonzero(near)
            if len(ii):
                vals = _pair_inter_areas(hf, blv[ii], blv[jj])
                cache = {
                    (int(a), int(b)): float(v)
                    for a, b, v in zip(blv[ii], blv[jj], vals)
                }
        dirty = set()

        def get_inter(a, b):
            if a in dirty or b in dirty or (a, b) not in cache:
                return float(_pair_inter_areas(hf, [a], [b])[0])
            return cache[(a, b)]

        for i in bin_list:
            if not f["active"][i] or f["area"][i] >= weld_settings.max_weld_area:
                continue
            group = []
            for j in bin_list:
                if (
                    i != j
                    and i < j
                    and f["active"][j]
                    and f["area"][j] < weld_settings.max_weld_area
                ):
                    dc = f["centroid"][i] - f["centroid"][j]
                    if (dc @ dc) >= (f["rmax"][i] + f["rmax"][j]) ** 2:
                        continue
                    inter = get_inter(i, j)
                    weld_prob = weld_settings.welding_coeff * inter / f["area"][i]
                    union_area = f["area"][i] + f["area"][j] - inter
                    if (
                        inter > 0
                        and weld_prob > rng.random()
                        and weld_settings.min_weld_area < union_area < weld_settings.max_weld_area
                    ):
                        group.append((j, inter))
            group.sort(key=lambda t: -t[1])
            welded_any = False
            for j, inter in group:
                if not f["active"][j]:
                    continue
                new_area = f["area"][i] + f["area"][j] - inter
                if new_area > weld_settings.max_weld_area:
                    break
                if fuse_two_floes(hf, i, j, dt, fs, prefuse, rng):
                    welded_any = True
                    dirty.add(i)
                    dirty.add(j)
            if welded_any:
                gainers.append(i)
    # one new id per gaining floe, assigned after all welds complete
    for i in sorted(gainers):
        max_floe_id += 1
        f["id"][i] = max_floe_id
    return hf.to_state(), max_floe_id


# ---------------------------------------------------------------------------
# ridging / rafting (ridge_raft.jl)
# ---------------------------------------------------------------------------

def _wall_ring(domain_vals, which):
    n, s, e, w = domain_vals
    hx = (e - w) / 2
    hy = (n - s) / 2
    if which == NORTH:
        return np.array([[w - hx, n], [e + hx, n], [e + hx, n + hy], [w - hx, n + hy]])
    if which == SOUTH:
        return np.array([[w - hx, s - hy], [e + hx, s - hy], [e + hx, s], [w - hx, s]])
    if which == EAST:
        return np.array([[e, s - hy], [e + hx, s - hy], [e + hx, n + hy], [e, n + hy]])
    return np.array([[w - hx, s - hy], [w, s - hy], [w, n + hy], [w - hx, n + hy]])


def _remove_floe_overlap(
    hf, shrink_idx, grow_ring, rr: RidgeRaftSettings, fs, simp: SimplificationSettings, rng
):
    """remove_floe_overlap! (ridge_raft.jl:78-197), ghost-free version.

    Returns (transfer_vol, new_piece_slots, nregions, removed)."""
    f = hf.fields
    try:
        regions = host_clip.difference(hf.ring(shrink_idx), grow_ring)
    except RuntimeError as e:
        # unresolvable clip degeneracy (every perturbation retry failed):
        # skip this overlap removal for the cadence instead of killing the
        # run - the floes move before the next ridge/raft pass and the
        # overlap is then re-detected in a non-degenerate configuration
        warnings.warn(f"ridge/raft overlap removal skipped: {e}")
        return 0.0, [], 1, False
    regions = [_rdp(r, simp.tol) if len(r) > 3 else r for r in regions]
    regions = [r for r in regions if len(r) >= 3 and poly_area_np(r) > 0]
    total_area = sum(poly_area_np(r) for r in regions)
    transfer_area = f["area"][shrink_idx] - total_area
    if transfer_area <= rr.min_overlap_frac * f["area"][shrink_idx]:
        return 0.0, [], len(regions), False
    transfer_vol = f["area"][shrink_idx] * f["height"][shrink_idx]
    height = f["height"][shrink_idx]
    floe_num = 0
    new_slots = []
    nregions = len(regions)
    for region in regions:
        a = poly_area_np(region)
        xmin, ymin = region.min(0)
        xmax, ymax = region.max(0)
        ddx, ddy = xmax - xmin, ymax - ymin
        aspect = (ddy / ddx) if ddx > ddy else (ddx / ddy)
        if a > fs.min_floe_area and aspect > fs.min_aspect_ratio:
            floe_num += 1
            vol = a * height
            transfer_vol -= vol
            if floe_num == 1:
                hf.replace_floe(shrink_idx, region, vol * fs.rho_i, fs, rng)
            else:
                slot = hf.add_floe(region, fs, rng, mass=vol * fs.rho_i)
                if slot is None:
                    warnings.warn("floe pool full during ridging; piece dropped")
                    continue
                # copy kinematics from parent
                for k in (
                    "u", "v", "xi", "p_dxdt", "p_dydt", "p_dudt", "p_dvdt",
                    "p_dxidt", "p_dalphadt", "strain",
                ):
                    hf.fields[k][slot] = hf.fields[k][shrink_idx]
                new_slots.append(slot)
    removed = False
    if floe_num == 0:
        f["remove"][shrink_idx] = True
        f["active"][shrink_idx] = False
        removed = True
    return transfer_vol, new_slots, nregions, removed


def _add_floe_volume(hf, idx, vol, fs):
    """add_floe_volume! (ridge_raft.jl:21-42)."""
    f = hf.fields
    init_h = f["height"][idx]
    f["height"][idx] = min(init_h + vol / f["area"][idx], fs.max_floe_height)
    f["mass"][idx] += vol * fs.rho_i
    f["moment"][idx] *= f["height"][idx] / init_h


def timestep_ridging_rafting(
    floes: FloeState,
    domain: Domain,
    overlaps,
    max_floe_id,
    rr: RidgeRaftSettings,
    fs: FloeSettings,
    simp: SimplificationSettings,
    dt,
    rng,
):
    """timestep_ridging_rafting! (ridge_raft.jl:676-837).

    ``overlaps``: list of (i, j, overlap_area) pairs from this step's
    collision pass; j >= 0 is a floe index, j < 0 encodes walls (-1..-4) and
    topography (<= -5), matching the reference's interaction indices.
    """
    hf = HostFloes(floes)
    f = hf.fields
    vals = domain.vals.cpu().numpy().astype(float)
    broken = np.zeros(len(f["active"]), bool)
    max_id = max_floe_id
    # Group overlaps by the smaller floe index and process floes in index
    # order with partners ordered (floes ascending, then walls N,S,E,W, then
    # topography) - the reference's per-floe interaction-list walk order
    # (ridge_raft.jl:690-760, i < j gating), which decides which pair ridges
    # first when one floe touches several others.
    by_floe = {}
    for (i, j, ov) in overlaps:
        i, j = int(i), int(j)
        if j >= 0 and j < i:
            i, j = j, i
        by_floe.setdefault(i, []).append((j, float(ov)))
    for i in sorted(by_floe):
        inters = sorted(by_floe[i], key=lambda t: (t[0] < 0, abs(t[0])))
        if not f["active"][i] or broken[i]:
            continue
        ridge = (
            f["height"][i] <= rr.max_floe_ridge_height
            and rng.random() <= rr.ridge_probability
        )
        raft = (
            f["height"][i] <= rr.max_floe_raft_height
            and rng.random() <= rr.raft_probability
        )
        if not (ridge or raft):
            continue
        seen = set()
        for j, ov in inters:
            if j in seen:
                continue
            seen.add(j)
            min_area = min(f["area"][i], f["area"][j]) if j >= 0 else f["area"][i]
            if not (1e-6 < ov / min_area < 0.95):
                continue
            if j >= 0 and not broken[i] and not broken[j] and f["active"][j]:
                if (
                    ridge
                    and f["height"][i] <= rr.max_floe_ridge_height
                    and f["height"][j] <= rr.max_floe_ridge_height
                ):
                    max_id = _floe_floe_ridge(
                        hf, i, j, broken, max_id, rr, fs, simp, dt, rng
                    )
                elif (
                    raft
                    and f["height"][i] <= rr.max_floe_raft_height
                    and f["height"][j] <= rr.max_floe_raft_height
                ):
                    max_id = _floe_floe_ridge(
                        hf, i, j, broken, max_id, rr, fs, simp, dt, rng,
                        raft=True,
                    )
            elif j < 0 and not broken[i]:
                if -4 <= j <= -1:
                    grow_ring = _wall_ring(vals, -j - 1)
                else:
                    t = -(j + 5)
                    tv = domain.topography.verts[t].cpu().numpy().astype(float)
                    tn = int(domain.topography.nverts[t])
                    grow_ring = tv[:tn]
                if ridge and f["height"][i] <= rr.max_domain_ridge_height:
                    max_id = _floe_domain_ridge(
                        hf, i, grow_ring, broken, max_id, rr, fs, simp, dt, rng
                    )
                elif raft and f["height"][i] <= rr.max_domain_raft_height:
                    max_id = _floe_domain_ridge(
                        hf, i, grow_ring, broken, max_id, rr, fs, simp, dt, rng
                    )
    return hf.to_state(), max_id


def _floe_floe_ridge(hf, i, j, broken, max_id, rr, fs, simp, dt, rng, raft=False):
    """floe_floe_ridge!/raft! (ridge_raft.jl:233-342, 497-583)."""
    f = hf.fields
    min_h = rr.min_ridge_height if not raft else 0.0
    f1_h = f["height"][i] >= min_h
    f2_h = f["height"][j] >= min_h
    gain, lose = 0, 0
    if raft:
        # rafting: random chance weighted by height ratio (ridge_raft.jl:497+)
        if rng.random() >= 1 / (1 + f["height"][i] / f["height"][j]):
            gain, lose = i, j
        else:
            gain, lose = j, i
    else:
        if (f1_h and f2_h and rng.random() >= 1 / (1 + f["height"][i] / f["height"][j])) or (
            f1_h and not f2_h
        ):
            gain, lose = i, j
        elif (f1_h and f2_h) or (not f1_h and f2_h):
            gain, lose = j, i
        else:
            return max_id
    ml, mg = f["mass"][lose], f["mass"][gain]
    Ig = f["moment"][gain]
    xg, yg = f["centroid"][gain]
    vol, new_slots, nregions, removed = _remove_floe_overlap(
        hf, lose, hf.ring(gain), rr, fs, simp, rng
    )
    if vol > 0:
        _add_floe_volume(hf, gain, vol, fs)
        if removed:
            conserve_momentum_change_floe_shape(
                mg, Ig, xg, yg, dt, hf, gain, lose
            )
        elif nregions == 1:
            conserve_momentum_transfer_mass(hf, lose, gain, ml, mg, dt)
        else:
            conserve_momentum_transfer_mass(
                hf, lose, gain, ml, mg, dt, extra=tuple(new_slots)
            )
            broken[lose] = True
            for s in new_slots:
                max_id += 1
                f["id"][s] = max_id
            f["parent_id"][lose] = f["id"][lose]
            max_id += 1
            f["id"][lose] = max_id
    return max_id


def _floe_domain_ridge(hf, i, grow_ring, broken, max_id, rr, fs, simp, dt, rng):
    """floe_domain_ridge! (ridge_raft.jl:380-459)."""
    f = hf.fields
    mass_tmp = f["mass"][i]
    moment_tmp = f["moment"][i]
    x_tmp, y_tmp = f["centroid"][i]
    vol, new_slots, nregions, removed = _remove_floe_overlap(
        hf, i, grow_ring, rr, fs, simp, rng
    )
    if vol > 0 and not removed:
        if rng.random() > rr.domain_gain_probability:
            tot_area = f["area"][i] + sum(f["area"][s] for s in new_slots)
            _add_floe_volume(hf, i, vol * f["area"][i] / tot_area, fs)
            for s in new_slots:
                _add_floe_volume(hf, s, vol * f["area"][s] / tot_area, fs)
        if nregions == 1:
            conserve_momentum_change_floe_shape(
                mass_tmp, moment_tmp, x_tmp, y_tmp, dt, hf, i
            )
        else:
            broken[i] = True
            for s in new_slots:
                max_id += 1
                f["id"][s] = max_id
            max_id += 1
            f["id"][i] = max_id
    return max_id
