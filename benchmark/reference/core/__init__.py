"""State containers and host setup of the PyTorch port."""

from .domain import (  # noqa: F401
    BoundaryKind,
    Domain,
    TopographyField,
    empty_topography,
    make_domain,
    make_topography,
    topography_from_polys,
    wall_rect,
)
from .fields import AtmosState, OceanState, make_atmos, make_ocean  # noqa: F401
from .floes import FloeState, build_floes, empty_floes  # noqa: F401
from .grid import RegRectilinearGrid, make_grid  # noqa: F401
from .init import initialize_floe_field, initialize_floe_field_coords  # noqa: F401
from .model import Model, make_model  # noqa: F401
