"""MATLAB SubZero .mat <-> FloeState converters (port of
``subzero_tpu/tools/mat_convert.py``).

The reference ships matfloe2julfloes / julfloe2matfloe
(src/tools/file_convert.jl:21-99) for interchanging floe state with the
original MATLAB SubZero model (Manucharyan & Montemuro,
doi:10.1029/2022MS003247); that code is partially broken (duplicated
blocks, references to undefined variables).  This is a WORKING equivalent
over the same field-name conventions, built on scipy.io:

  * ``matfloes_to_floes(path, ...)`` - read a .mat holding a ``floe``
    struct (scalar or struct array) with MATLAB SubZero's field names
    (``c_alpha`` body-frame vertices, ``Xi/Yi`` centroid, ``h`` height,
    ``Ui/Vi/ksi_ice`` velocities, ``alpha_i`` rotation, ...) into a padded
    FloeState pool on ``device`` (None: the card).
  * ``floes_to_mat(floes, path)`` - write the active floes back out with
    the julfloe2matfloe field names so MATLAB-side tooling can read them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.floes import FloeState, build_floes
from ..settings import FloeSettings

__all__ = ["matfloes_to_floes", "floes_to_mat"]


def _unwrap(x):
    """Peel the object-array wrappers scipy.io puts around struct fields."""
    while isinstance(x, np.ndarray) and x.dtype == object and x.size == 1:
        x = x.reshape(-1)[0]
    return x


def _field(rec, name, default=None):
    """Fetch a field from a scipy.io mat_struct / structured void / dict."""
    if isinstance(rec, dict):
        if name in rec:
            return _unwrap(rec[name])
    elif hasattr(rec, "dtype") and rec.dtype.names and name in rec.dtype.names:
        return _unwrap(rec[name])
    elif hasattr(rec, name):
        return _unwrap(getattr(rec, name))
    if default is not None:
        return default
    raise KeyError(name)


def _scalar(x):
    return float(np.asarray(x).reshape(-1)[0])


def matfloes_to_floes(
    path: str,
    floe_settings: FloeSettings = FloeSettings(),
    rng=None,
    device=None,
    **build_kwargs,
) -> FloeState:
    """Read MATLAB SubZero floes from ``path`` into a FloeState pool on
    ``device`` (None: the card; ``build_kwargs`` go to ``build_floes``, which
    wants ``dtype``).

    Mirrors matfloe2julfloes (file_convert.jl:21-52): each floe's world
    polygon is ``c_alpha`` (2 x V body-frame vertices) translated by its
    centroid ``(Xi, Yi)``; height ``h`` seeds the mass; kinematics
    ``Ui/Vi/ksi_ice`` and rotation ``alpha_i`` carry over.  Remaining Floe
    fields (subfloe points, moment, rmax, ...) are recomputed by the
    normal constructor path - they are derived quantities.
    """
    from scipy.io import loadmat

    if rng is None:
        rng = np.random.default_rng(0)
    vars_ = loadmat(path, squeeze_me=True, struct_as_record=True)
    if "floe" not in vars_:
        raise KeyError(f"{path} holds no 'floe' struct")
    fstruct = vars_["floe"]
    recs = np.atleast_1d(fstruct)

    rings, heights, us, vs, xis, alphas = [], [], [], [], [], []
    for rec in recs:
        c_alpha = np.asarray(_field(rec, "c_alpha"), float)
        if c_alpha.shape[0] != 2:
            c_alpha = c_alpha.T
        xi_c = _scalar(_field(rec, "Xi"))
        yi_c = _scalar(_field(rec, "Yi"))
        ring = np.stack(
            [c_alpha[0] + xi_c, c_alpha[1] + yi_c], axis=-1
        )
        rings.append(ring)
        heights.append(_scalar(_field(rec, "h")))
        us.append(_scalar(_field(rec, "Ui", 0.0)))
        vs.append(_scalar(_field(rec, "Vi", 0.0)))
        xis.append(_scalar(_field(rec, "ksi_ice", 0.0)))
        alphas.append(_scalar(_field(rec, "alpha_i", 0.0)))

    # one pool at the mean height (dh = 0), then each floe's exact height
    floes = build_floes(
        rings, float(np.mean(heights)), 0.0, floe_settings, rng,
        device=device, **build_kwargs,
    )
    host = {k: getattr(floes, k).cpu().numpy().copy()
            for k in ("active", "height", "mass", "moment", "u", "v", "xi", "alpha")}
    rows = np.flatnonzero(host["active"])[: len(rings)]
    for k, r in enumerate(rows):
        # exact per-floe height: rescale mass/moment from the hmean draw
        ratio = heights[k] / host["height"][r]
        host["height"][r] = heights[k]
        host["mass"][r] *= ratio
        host["moment"][r] *= ratio
        host["u"][r] = us[k]
        host["v"][r] = vs[k]
        host["xi"][r] = xis[k]
        host["alpha"][r] = alphas[k]
    dev = floes.verts.device
    return floes._replace(**{k: torch.as_tensor(host[k], device=dev)
                             for k in ("height", "mass", "moment", "u", "v", "xi", "alpha")})


def floes_to_mat(floes: FloeState, path: str) -> None:
    """Write the active floes of a pool to ``path`` with julfloe2matfloe's
    field names (file_convert.jl:77-99): per-floe cell-style vertex arrays
    plus the kinematic/force columns."""
    from scipy.io import savemat

    f = {k: v.cpu().numpy() for k, v in floes._asdict().items()}
    rows = np.flatnonzero(f["active"])
    nv, verts = f["nverts"], f["verts"]
    xcoords = np.empty(len(rows), object)
    ycoords = np.empty(len(rows), object)
    for k, r in enumerate(rows):
        ring = verts[r, : nv[r]]
        xcoords[k] = ring[:, 0].reshape(1, -1)
        ycoords[k] = ring[:, 1].reshape(1, -1)
    nsub = f["nsub"]
    xs = np.empty(len(rows), object)
    ys = np.empty(len(rows), object)
    for k, r in enumerate(rows):
        xs[k] = f["sub_x"][r, : nsub[r]]
        ys[k] = f["sub_y"][r, : nsub[r]]
    savemat(
        path,
        {
            "xcoords": xcoords,
            "ycoords": ycoords,
            "x_subfloe_points": xs,
            "y_subfloe_points": ys,
            "u": f["u"][rows],
            "v": f["v"][rows],
            "ksi_ice": f["xi"][rows],
            "alpha_i": f["alpha"][rows],
            "h": f["height"][rows],
            "fxOA": f["fx_oa"][rows],
            "fyOA": f["fy_oa"][rows],
            "torqueOA": f["trq_oa"][rows],
            "collision_force": f["collision_force"][rows],
            "collision_torque": f["collision_trq"][rows],
            "stress": f["stress_accum"][rows],
            "strain": f["strain"][rows],
        },
    )
