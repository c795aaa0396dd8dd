"""Device choice (the counterpart of `hyperspace_tpu/ops/backend.py`).

The port runs on the CUDA card unless the caller names another device. A
missing card with the default device is an error: nothing moves to the CPU
on its own.
"""

from __future__ import annotations

import torch

from ..exceptions import HyperspaceException


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `cuda`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HyperspaceException(
            "hyperspace_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run on "
            "the CPU."
        )
    return dev
