"""Logging for ``simulation.run`` (the output writers are not ported yet)."""

from .logger import SimulationLogger  # noqa: F401
