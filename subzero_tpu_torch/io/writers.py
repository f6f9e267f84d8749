"""Output writers and checkpoint/restart (port of ``subzero_tpu/io/writers.py``).

The reference's four writers (src/output.jl of Subzero.jl):

  * InitialStateOutputWriter - whole simulation config + initial state
    (output.jl:21-74)
  * FloeOutputWriter(interval) - selected floe fields per timestep group
    (output.jl:161-225)
  * GridOutputWriter(interval, (Nx, Ny)) - floe data re-gridded to a coarse
    Eulerian grid (output.jl:239-404, calc_eulerian_data! :794-919)
  * CheckpointOutputWriter(interval) - floes + ocean + atmos (+ RNG state)
    for restart (output.jl:85-148)

Each writer has a device half and a file half.  The device half turns the
port's state into numpy arrays by field name (``floe_arrays``,
``interaction_arrays``, ``eulerian_data``, ``initial_state_arrays``,
``checkpoint_arrays``); the file half (``write_arrays``) writes them with
h5py, in the JAX package's file layout, so a file written by either package
is read by the other.  ``restart`` is split the same way: ``read_restart``
reads the datasets, ``restore_simulation`` rebuilds the ``Simulation`` from
the arrays on a device.  h5py is imported inside the file halves only, so
the device halves and ``import subzero_tpu_torch.io`` need no h5py.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..convert import _tensor
from ..core.floes import FloeState

DEFAULT_FLOE_FIELDS = (
    "centroid", "height", "area", "mass", "rmax", "moment", "alpha",
    "u", "v", "xi", "id", "parent_id", "fx_oa", "fy_oa", "trq_oa",
    "hflx_factor", "overarea", "collision_force", "collision_trq",
    "stress_accum", "stress_instant", "strain", "nverts", "verts",
)

GRID_OUTPUTS = (
    "u_grid", "v_grid", "dudt_grid", "dvdt_grid", "overarea_grid",
    "mass_grid", "area_grid", "height_grid", "si_frac_grid",
    "stress_xx_grid", "stress_yx_grid", "stress_xy_grid", "stress_yy_grid",
    "stress_eig_grid", "strain_ux_grid", "strain_vx_grid", "strain_uy_grid",
    "strain_vy_grid",
)

# units + comments metadata for the 18 gridded outputs, ported from the
# reference's getattrs (output.jl:933-1000)
GRID_ATTRS = {
    "u_grid": ("m/s", "Average floe x-direction velocity in grid cell"),
    "v_grid": ("m/s", "Average floe y-direction velocity in grid cell"),
    "dudt_grid": ("m/s^2", "Average floe x-direction acceleration in grid cell"),
    "dvdt_grid": ("m/s^2", "Average floe y-direction acceleration in grid cell"),
    "overarea_grid": ("m", "Average overlap area of floe with other floes in grid cell"),
    "mass_grid": ("kg", "Average mass of floes in grid cell"),
    "area_grid": ("m^2", "Average area of floes in grid cell"),
    "height_grid": ("m", "Average height of floes in grid cell"),
    "si_frac_grid": ("unitless", "Fraction of grid cell covered by floes"),
    "stress_xx_grid": ("N/m^2", "Average xx stress on floes in a given grid cell"),
    "stress_yx_grid": ("N/m^2", "Average yx stress on floes in a given grid cell"),
    "stress_xy_grid": ("N/m^2", "Average xy stress on floes in a given grid cell"),
    "stress_yy_grid": ("N/m^2", "Average yy stress on floes in a given grid cell"),
    "stress_eig_grid": ("N/m^2", "Maximum eigenvalue of the stress matricies [xx yx; xy yy]"),
    "strain_ux_grid": ("unitless", "Average ux strain on floes in a grid cell"),
    "strain_vx_grid": ("unitless", "Average vx strain on floes in a grid cell"),
    "strain_uy_grid": ("unitless", "Average uy strain on floes in a grid cell"),
    "strain_vy_grid": ("unitless", "Average vy strain on floes in a grid cell"),
}

INTERACTION_COLUMNS = ("i", "j", "fx", "fy", "px", "py", "torque", "overlap")


# ---------------------------------------------------------------------------
# device halves: the port's state -> numpy arrays by field name
# ---------------------------------------------------------------------------

def tree_arrays(tree) -> dict:
    """Every field of a state NamedTuple, whole, as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in tree._asdict().items()}


def floe_arrays(floes: FloeState, fields: Sequence[str] = DEFAULT_FLOE_FIELDS) -> dict:
    """The active rows of the named floe fields, as numpy arrays."""
    rows = torch.nonzero(floes.active).squeeze(1)
    return {k: getattr(floes, k).index_select(0, rows).cpu().numpy() for k in fields}


def interaction_arrays(interactions: dict, floes: FloeState) -> dict:
    """The reference FloeOutputWriter's per-floe n x 7 interaction matrices
    (output.jl:558-572), stored flat with an extra leading i column:
    ``interactions`` [K, 8] = [i, j, fx, fy, px, py, torque, overlap] over
    the valid rows of ``pair_interactions``, and ``num_inters``, the rows of
    each active floe."""
    v = interactions["valid"].cpu().numpy()
    cols = {k: interactions[k].cpu().numpy()[v] for k in INTERACTION_COLUMNS}
    counts = np.bincount(cols["i"].astype(int), minlength=floes.capacity)
    return {
        "interactions": np.stack([cols[k] for k in INTERACTION_COLUMNS], axis=1),
        "num_inters": counts[floes.active.cpu().numpy()],
    }


def _sim_json(sim) -> str:
    meta = {
        "name": sim.name,
        "dt": sim.dt,
        "n_dt": sim.n_dt,
        "consts": dataclasses.asdict(sim.consts),
        "grid": dataclasses.asdict(sim.model.grid),
        "domain_kinds": list(sim.model.domain.kinds),
    }
    return json.dumps(meta)


def initial_state_arrays(sim) -> dict:
    """What InitialStateOutputWriter writes: ``sim_json`` (name, dt, n_dt,
    constants, grid and wall kinds as JSON) and the groups ``floes`` (the
    default fields' active rows), ``ocean``, ``atmos`` and ``domain``
    (``vals``, ``velocities``, ``topography``)."""
    m = sim.model
    return {
        "sim_json": _sim_json(sim),
        "floes": floe_arrays(m.floes),
        "ocean": tree_arrays(m.ocean),
        "atmos": tree_arrays(m.atmos),
        "domain": {
            "vals": m.domain.vals.cpu().numpy(),
            "velocities": m.domain.velocities.cpu().numpy(),
            "topography": tree_arrays(m.domain.topography),
        },
    }


def checkpoint_arrays(floes: FloeState, ocean, atmos, rng_state=None) -> dict:
    """What CheckpointOutputWriter writes at one step: the full pool
    (inactive slots too, so that restart is exact), ocean, atmos and the
    generator state as JSON (None when not given)."""
    return {
        "floes": tree_arrays(floes),
        "ocean": tree_arrays(ocean),
        "atmos": tree_arrays(atmos),
        "rng": None if rng_state is None else json.dumps(rng_state),
    }


def eulerian_data(floes: FloeState, ocean, grid, dims, outputs=GRID_OUTPUTS) -> dict:
    """calc_eulerian_data! (output.jl:794-919): per coarse cell, area-ratio
    weighted averages of floe quantities over the floes covering the cell.

    The ``[N, nx, ny]`` floe-by-cell clip (``coupling._cell_areas``: the
    cell clip's kernel on the card, its plain version on the CPU) and the
    weighted sums run on the pool's device, in float64 whatever the pool's
    dtype (the JAX package's cell bounds are float64 arrays, so under x64
    its clip runs in float64 too); only the ``[nx, ny]`` results come to
    the host."""
    from ..physics.coupling import _cell_areas

    ny, nx = dims
    xs = np.linspace(grid.x0, grid.xf, nx + 1)
    ys = np.linspace(grid.y0, grid.yf, ny + 1)
    N = floes.capacity
    dev, f64 = floes.verts.device, torch.float64

    def bounds(edges):
        return torch.as_tensor(edges, dtype=f64, device=dev).expand(N, len(edges))

    # rect bounds by axis, every floe against every coarse cell of an
    # active floe (the cells' rects and mask are separable)
    area = _cell_areas(floes.verts.to(f64), floes.nverts,
                       bounds(xs[:-1]), bounds(xs[1:]), bounds(ys[:-1]), bounds(ys[1:]),
                       floes.active[:, None].expand(N, nx),
                       torch.ones((N, ny), dtype=torch.bool, device=dev))
    tot = area.sum(dim=0)  # [nx, ny]
    w = torch.where(tot > 0, area / torch.where(tot > 0, tot, 1.0), 0.0)

    def avg(q):
        return torch.einsum("n,nxy->xy", q.to(f64), w)

    cell_area = (xs[1] - xs[0]) * (ys[1] - ys[0])
    stress, strain = floes.stress_accum.to(f64), floes.strain.to(f64)
    known = {
        "u_grid": lambda: avg(floes.u),
        "v_grid": lambda: avg(floes.v),
        "dudt_grid": lambda: avg(floes.p_dudt),
        "dvdt_grid": lambda: avg(floes.p_dvdt),
        "overarea_grid": lambda: avg(floes.overarea),
        "mass_grid": lambda: avg(floes.mass),
        "area_grid": lambda: tot,
        "height_grid": lambda: avg(floes.height),
        "si_frac_grid": lambda: tot / cell_area,
        "stress_xx_grid": lambda: avg(stress[:, 0, 0]),
        "stress_yx_grid": lambda: avg(stress[:, 1, 0]),
        "stress_xy_grid": lambda: avg(stress[:, 0, 1]),
        "stress_yy_grid": lambda: avg(stress[:, 1, 1]),
        "stress_eig_grid": lambda: avg(torch.linalg.eigvalsh(stress)[..., -1]),
        "strain_ux_grid": lambda: avg(strain[:, 0, 0]),
        "strain_vx_grid": lambda: avg(strain[:, 1, 0]),
        "strain_uy_grid": lambda: avg(strain[:, 0, 1]),
        "strain_vy_grid": lambda: avg(strain[:, 1, 1]),
    }
    names = [k for k in outputs if k in known]
    if not names:
        return {}
    host = torch.stack([known[k]() for k in names]).cpu().numpy()
    return dict(zip(names, host))


# ---------------------------------------------------------------------------
# file halves (h5py)
# ---------------------------------------------------------------------------

def _open(dir: str, filename: str, overwrite: bool):
    import h5py

    os.makedirs(dir, exist_ok=True)
    return h5py.File(os.path.join(dir, filename), "w" if overwrite else "x")


def _write_tree(group, tree: dict):
    """Arrays as datasets of ``group``; a nested dict as a subgroup."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _write_tree(group.create_group(k), v)
        else:
            group.create_dataset(k, data=v)


def _read_tree(group) -> dict:
    import h5py

    return {k: _read_tree(v) if isinstance(v, h5py.Group) else v[()]
            for k, v in group.items()}


@dataclasses.dataclass
class InitialStateOutputWriter:
    dir: str = "."
    filename: str = "initial_state.h5"
    overwrite: bool = False

    def path(self):
        return os.path.join(self.dir, self.filename)

    def write(self, sim):
        self.write_arrays(initial_state_arrays(sim))

    def write_arrays(self, arrays: dict):
        arrays = dict(arrays)
        with _open(self.dir, self.filename, self.overwrite) as f:
            f.attrs["sim_json"] = arrays.pop("sim_json")
            _write_tree(f, arrays)


@dataclasses.dataclass
class FloeOutputWriter:
    interval: int
    dir: str = "."
    filename: str = "floes.h5"
    overwrite: bool = False
    outputs: Sequence[str] = DEFAULT_FLOE_FIELDS

    _file: Any = None

    def open(self):
        self._file = _open(self.dir, self.filename, self.overwrite)

    def write(self, tstep, floes: FloeState, interactions=None):
        fields = [k for k in self.outputs if k != "interactions"]
        arrays = floe_arrays(floes, fields)
        if interactions is not None:
            arrays.update(interaction_arrays(interactions, floes))
        self.write_arrays(tstep, arrays)

    def write_arrays(self, tstep, arrays: dict):
        if self._file is None:
            self.open()
        _write_tree(self._file.create_group(str(tstep)), arrays)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


@dataclasses.dataclass
class CheckpointOutputWriter:
    interval: int
    dir: str = "."
    filename: str = "checkpoint.h5"
    overwrite: bool = False

    _file: Any = None

    def open(self):
        self._file = _open(self.dir, self.filename, self.overwrite)

    def write(self, tstep, floes, ocean, atmos, rng_state=None):
        self.write_arrays(tstep, checkpoint_arrays(floes, ocean, atmos, rng_state))

    def write_arrays(self, tstep, arrays: dict):
        if self._file is None:
            self.open()
        for k in ("floes", "ocean", "atmos"):
            _write_tree(self._file.create_group(f"{k}/{tstep}"), arrays[k])
        if arrays["rng"] is not None:
            self._file[f"rng/{tstep}"] = arrays["rng"]

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


@dataclasses.dataclass
class GridOutputWriter:
    """Re-grids floe data onto a coarse (nx, ny) Eulerian grid.

    The file follows the netCDF4-over-HDF5 layout the reference's
    GridOutputWriter produces with NCDatasets (output.jl:681-752): an
    unlimited ``time`` dimension, ``x``/``y`` coordinate variables as HDF5
    dimension scales, every output stored as a ``(time, x, y)`` variable with
    scales attached (netCDF DIMENSION_LIST), and ``units``/``comments``
    attributes from getattrs (output.jl:933-1000).
    """

    interval: int
    dims: tuple = (10, 10)
    dir: str = "."
    filename: str = "gridded_data.nc"
    overwrite: bool = False
    outputs: Sequence[str] = GRID_OUTPUTS
    dt: Optional[float] = None  # sim timestep (s); stamps the time units

    _file: Any = None

    def open(self, grid):
        f = _open(self.dir, self.filename, self.overwrite)
        self._file = f
        # netCDF-c recognizes files carrying _NCProperties as netCDF4-native;
        # readers fall back to HDF5-interop mode without it, so write it.
        f.attrs["_NCProperties"] = np.bytes_(
            b"version=2,netcdf=4.9.2,hdf5=1.12.2"
        )
        f.attrs["type"] = (
            "Floe data averaged on the grid. The grid is broken down into "
            "user provided dimensions."
        )
        ny, nx = self.dims
        xs = np.linspace(grid.x0, grid.xf, nx + 1)
        ys = np.linspace(grid.y0, grid.yf, ny + 1)
        t = f.create_dataset("time", shape=(0,), maxshape=(None,), dtype="f8")
        t.make_scale("time")
        t.attrs["units"] = (
            "timesteps" if self.dt is None else f"{self.dt:g} seconds"
        )
        t.attrs["_Netcdf4Dimid"] = np.int32(0)
        x = f.create_dataset("x", data=0.5 * (xs[:-1] + xs[1:]))
        x.make_scale("x")
        x.attrs["units"] = "meters"
        x.attrs["_Netcdf4Dimid"] = np.int32(1)
        y = f.create_dataset("y", data=0.5 * (ys[:-1] + ys[1:]))
        y.make_scale("y")
        y.attrs["units"] = "meters"
        y.attrs["_Netcdf4Dimid"] = np.int32(2)
        for name in self.outputs:
            v = f.create_dataset(
                name, shape=(0, nx, ny), maxshape=(None, nx, ny), dtype="f8"
            )
            v.dims[0].attach_scale(t)
            v.dims[1].attach_scale(x)
            v.dims[2].attach_scale(y)
            unit, comment = GRID_ATTRS.get(name, ("", ""))
            v.attrs["units"] = unit
            v.attrs["comments"] = comment

    def write(self, tstep, floes, ocean, grid):
        self.write_arrays(
            tstep, eulerian_data(floes, ocean, grid, self.dims, self.outputs), grid
        )

    def write_arrays(self, tstep, data: dict, grid):
        if self._file is None:
            self.open(grid)
        t = self._file["time"]
        i = t.shape[0]
        t.resize((i + 1,))
        t[i] = float(tstep)
        for k, v in data.items():
            d = self._file[k]
            d.resize((i + 1,) + d.shape[1:])
            d[i] = v

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


@dataclasses.dataclass
class OutputWriters:
    """Container + dispatcher (output.jl:415-499)."""

    initial_state: Optional[InitialStateOutputWriter] = None
    floes: Optional[FloeOutputWriter] = None
    grid: Optional[GridOutputWriter] = None
    checkpoint: Optional[CheckpointOutputWriter] = None

    def write_data(self, sim, tstep, floes, ocean, domain, rng_state=None):
        if tstep == 0 and self.initial_state is not None:
            self.initial_state.write(sim)
        if self.floes is not None and tstep % self.floes.interval == 0:
            inters = None
            if "interactions" in self.floes.outputs:
                from ..physics.collisions import pair_interactions

                inters = pair_interactions(
                    floes, domain, sim.consts, float(sim.dt), sim.pair_cap,
                    sim.clip_cap, sim.bins,
                )
            self.floes.write(tstep, floes, interactions=inters)
        if self.grid is not None and tstep % self.grid.interval == 0:
            if self.grid.dt is None:
                self.grid.dt = float(sim.dt)
            self.grid.write(tstep, floes, ocean, sim.model.grid)
        if (
            self.checkpoint is not None
            and tstep % self.checkpoint.interval == 0
        ):
            self.checkpoint.write(
                tstep, floes, ocean, sim.model.atmos, rng_state
            )

    def close(self):
        for w in (self.floes, self.grid, self.checkpoint):
            if w is not None:
                w.close()


# ---------------------------------------------------------------------------
# restart
# ---------------------------------------------------------------------------

def read_restart(initial_state_path: str, checkpoint_path: str):
    """File half of ``restart``: (initial, checkpoint, last), where
    ``initial`` holds ``sim_json`` and the ``domain`` arrays of the
    initial-state file and ``checkpoint`` the checkpoint's last step as
    ``checkpoint_arrays`` gives it."""
    import h5py

    with h5py.File(initial_state_path, "r") as f:
        initial = {"sim_json": f.attrs["sim_json"], "domain": _read_tree(f["domain"])}
    with h5py.File(checkpoint_path, "r") as f:
        last = max(int(k) for k in f["floes"].keys())
        ckpt = {k: _read_tree(f[f"{k}/{last}"]) for k in ("floes", "ocean", "atmos")}
        ckpt["rng"] = None
        if "rng" in f and str(last) in f["rng"]:
            ckpt["rng"] = f[f"rng/{last}"][()]
    return initial, ckpt, last


def _state(cls, arrays: dict, device, dtype):
    """A state NamedTuple from a file's arrays, as the port keeps it:
    floats in ``dtype``, booleans as bool, every integer field as int32
    (whatever width the writing package gave it)."""
    return cls(*(_tensor(arrays[k], device, dtype) for k in cls._fields))


def restore_simulation(initial: dict, checkpoint: dict, new_n_dt: int,
                       writers=None, device=None, **sim_kwargs):
    """Device half of ``restart``: a ``Simulation`` on ``device`` (None: the
    card) from the arrays of an initial state and of one checkpoint step."""
    from ..constants import Constants
    from ..core.domain import Domain, TopographyField
    from ..core.fields import AtmosState, OceanState
    from ..core.grid import RegRectilinearGrid
    from ..core.model import Model
    from ..device import resolve_device
    from ..simulation import Simulation

    device = resolve_device(device)
    meta = json.loads(initial["sim_json"])
    dom = initial["domain"]
    # the pool's float width is the model's
    dtype = torch.from_numpy(np.asarray(checkpoint["floes"]["verts"])).dtype
    domain = Domain(
        kinds=tuple(int(k) for k in meta["domain_kinds"]),
        vals=_tensor(dom["vals"], device, dtype),
        velocities=_tensor(dom["velocities"], device, dtype),
        topography=_state(TopographyField, dom["topography"], device, dtype),
    )
    model = Model(
        grid=RegRectilinearGrid(**meta["grid"]),
        ocean=_state(OceanState, checkpoint["ocean"], device, dtype),
        atmos=_state(AtmosState, checkpoint["atmos"], device, dtype),
        domain=domain,
        floes=_state(FloeState, checkpoint["floes"], device, dtype),
    )
    rng = checkpoint.get("rng")
    kwargs = dict(consts=Constants(**meta["consts"]), dt=meta["dt"], name=meta["name"])
    kwargs.update(sim_kwargs)  # caller-passed settings win over file metadata
    return Simulation(
        model=model,
        n_dt=new_n_dt,
        writers=writers,
        rng_state=None if rng is None else json.loads(rng),
        **kwargs,
    )


def restart(
    initial_state_path: str,
    checkpoint_path: str,
    new_n_dt: int,
    writers: Optional[OutputWriters] = None,
    start_tstep: int = 0,
    device=None,
    **sim_kwargs,
):
    """restart! (simulation.jl:310-340): rebuild a Simulation on ``device``
    (None: the card) from the initial-state and checkpoint files and return
    (sim, the checkpoint's last step), ready to run from that step.

    Process settings are not serialized (they can hold callables/criteria
    objects); pass the original settings through ``sim_kwargs`` to resume a
    run exactly - with the same settings, resume is bit-exact including the
    RNG stream (saved per checkpoint and restored here; the reference's
    restart! is documented as approximate, simulation.jl:306-308).
    """
    from ..device import resolve_device

    device = resolve_device(device)
    initial, ckpt, last = read_restart(initial_state_path, checkpoint_path)
    sim = restore_simulation(initial, ckpt, new_n_dt, writers=writers,
                             device=device, **sim_kwargs)
    return sim, last
