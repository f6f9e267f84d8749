"""Diagnostics and file tools of the PyTorch port (port of ``subzero_tpu/tools``)."""

from .conservation import drift_percent, floe_energy_momentum  # noqa: F401
