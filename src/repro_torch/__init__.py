"""``repro_torch`` — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``src/repro/`` module by module and imports only
``torch`` and numpy. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no device given and no card present they raise
(``resolve_device``). On CUDA tensors the kernel wrappers launch the
hand-written ``sm_90a`` kernels in ``csrc/``; on CPU tensors they run the
plain PyTorch version of the same function.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the card.

    Never drops to the CPU on its own: with no device given and no CUDA
    device present this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return torch.device("cuda")


__all__ = ["DeviceLike", "resolve_device"]
