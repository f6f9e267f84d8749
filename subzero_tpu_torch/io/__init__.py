"""Logging, output writers and checkpoint/restart for ``simulation.run``.

The writers' file halves import h5py when they write or read; importing
this package needs none.
"""

from .logger import SimulationLogger  # noqa: F401
from .writers import (  # noqa: F401
    CheckpointOutputWriter,
    FloeOutputWriter,
    GridOutputWriter,
    InitialStateOutputWriter,
    OutputWriters,
    eulerian_data,
    restart,
)
