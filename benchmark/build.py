"""A configuration's Simulation, built through a package's public
constructors from the benchmark's inputs.  The same function builds the
program's (``subzero_tpu_torch``) and the reference's
(``benchmark.reference``): each is handed as a ``Package`` of its modules,
so this file imports neither."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Package:
    core: ModuleType
    settings: ModuleType
    constants: ModuleType
    simulation: ModuleType


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``: a configuration or a cell."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def modulus(area: np.ndarray) -> float:
    """The examples' Young's modulus from the active floes' areas, in
    their own dtype: 1.5e3 (mean sqrt(area) + min sqrt(area)) (Subzero.jl's
    examples)."""
    r = np.sqrt(np.asarray(area))
    return float(1.5e3 * (np.mean(r) + np.min(r)))


def build_sim(pkg: Package, cfg: dict, inp, device, modulus_of):
    """The configuration's Simulation on ``device`` at the configuration's
    dtype.  ``modulus_of(floes)`` gives E from the built floes (the program
    side takes the port's example helper, the reference its own)."""
    core, st = pkg.core, pkg.settings
    kw = dict(dtype=getattr(torch, cfg["dtype"]), device=device)
    (x0, x1), (y0, y1) = cfg["domain"]["x"], cfg["domain"]["y"]
    grid = core.make_grid(x0, x1, y0, y1, dx=cfg["grid"]["dx"], dy=cfg["grid"]["dy"])
    oc, at = cfg["ocean"], cfg["atmos"]
    ocean = core.make_ocean(grid, u=inp.u_ocean, v=oc["v"], temp=oc["temp"], **kw)
    atmos = core.make_atmos(grid, u=at["u"], v=at["v"], temp=at["temp"], **kw)
    kinds = [getattr(core.BoundaryKind, b.upper()) for b in cfg["domain"]["boundaries"]]
    domain = core.make_domain(grid, *kinds, **kw)
    fl = cfg["floes"]
    fs = st.FloeSettings(min_floe_area=fl["min_area"],
                         subfloe_point_generator=st.SubGridPointsGenerator.from_grid(
                             grid, fl["subfloe_points_per_cell"]))
    extra = {} if fl["pool"] is None else {"N": fl["pool"]}
    floes = core.initialize_floe_field_coords(
        inp.coords, domain, fl["hmean"], fl["dh"], fs,
        rng=np.random.default_rng(inp.floe_seed), **extra, **kw)
    settings = dict(
        consts=pkg.constants.Constants(E=modulus_of(floes)),
        dt=cfg["dt"],
        n_dt=cfg["n_dt"],
        cell_cap=cfg["cell_cap"],
        verbose=cfg["verbose"],
        seed=inp.lifecycle_seed,
        floe_settings=fs,
        coupling_settings=st.CouplingSettings(
            two_way_coupling_on=cfg["coupling"]["two_way"], dt=cfg["coupling"]["dt"]),
        simp_settings=st.SimplificationSettings(dt_smooth=cfg["smooth_dt"]),
    )
    fr = cfg["fracture"]
    if fr is not None:
        if fr["criteria"] != "hibler":
            raise ValueError(f"unknown fracture criteria {fr['criteria']!r}")
        settings["fracture_settings"] = st.FractureSettings(
            fractures_on=True, criteria=st.HiblerYieldCurve(), dt=fr["dt"],
            npieces=fr["npieces"])
    if cfg["ridge_raft"] is not None:
        settings["ridgeraft_settings"] = st.RidgeRaftSettings(
            ridge_raft_on=True, dt=cfg["ridge_raft"]["dt"])
    wd = cfg["weld"]
    if wd is not None:
        settings["weld_settings"] = st.WeldSettings(
            weld_on=True, dts=tuple(wd["dts"]), nxs=tuple(wd["nxs"]), nys=tuple(wd["nys"]))
    model = core.make_model(grid, ocean, atmos, domain, floes)
    return pkg.simulation.Simulation(model=model, **settings)
