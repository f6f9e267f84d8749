"""The domain decomposition on ``torch.distributed`` (port of
``subzero_tpu/parallel``): one process per rank.  The JAX package's
``parallel/mesh.py`` (sharding propagation by XLA's SPMD partitioner) has no
counterpart: the decomposition gives the same ability."""

from . import multihost  # noqa: F401
from .decomp import (  # noqa: F401
    Decomp,
    Decomp2D,
    build_decomp_segment,
    build_decomp_step,
    build_decomp_step_2d,
    build_decomp_step_halves,
    distribute,
    distribute_2d,
    gather,
    make_decomp,
    make_decomp_2d,
    measure_decomp_scaling,
    run_decomp,
)
