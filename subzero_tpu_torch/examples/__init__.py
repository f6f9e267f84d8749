"""The single-device example scripts of the PyTorch port, one module each
(port of the repository's ``examples/``)::

    python -m subzero_tpu_torch.examples.uniform_flow

Each module's ``build()`` takes the JAX example's arguments and defaults,
with ``dtype`` a torch dtype and ``device=None`` (the card).  Output goes
under ``output/`` of the working directory.
"""
