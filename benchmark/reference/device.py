"""Where the port's entry points put their tensors.

Every constructor takes ``device=None``, meaning the card.  Only a caller that
names the CPU (``device="cpu"``, as the CPU tests do) gets CPU tensors;
nothing falls back to the CPU when no card is there.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``, raising when no CUDA device is
    available; anything else -> ``torch.device(device)`` as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "subzero_tpu_torch runs on an NVIDIA GPU unless the caller asks "
            "for the CPU: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device=\"cpu\" to "
            "build CPU tensors"
        )
    return torch.device("cuda")
