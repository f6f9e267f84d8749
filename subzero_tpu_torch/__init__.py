"""subzero_tpu_torch: the PyTorch/CUDA port of the subzero_tpu sea-ice model.

A second package beside the JAX reference ``subzero_tpu``.  It imports
``torch``, never ``jax`` and nothing of ``subzero_tpu``: ``settings`` and
``constants`` are its own copies of the reference's dataclasses.  Its
constructors put tensors on the card unless the caller names the CPU
(``device.resolve_device``).  The device step (collide, couple, integrate,
remove) runs through ``simulation.run_scan``, and ``simulation.run`` adds the
host life cycle (``physics/lifecycle_host.py``: fracture, ridge/raft, weld,
smooth, fuse) at its cadences; the narrow phase goes through a hand-written
CUDA kernel on CUDA tensors (``geometry/two_cross.py``,
``csrc/two_cross.cu``) and through its plain PyTorch version on CPU
tensors.
"""

__version__ = "0.1.0"
