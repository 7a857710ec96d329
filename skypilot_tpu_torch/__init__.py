"""PyTorch / CUDA port of the skypilot_tpu compute path for NVIDIA Hopper.

Module paths mirror ``skypilot_tpu`` (``models/llama.py``, ``ops/...``,
``infer/...``) so each module's counterpart is easy to find. The package
imports torch, numpy and the standard library only: never jax and never
``skypilot_tpu``. Host-only pieces it needs from the JAX package are
copied here.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking
for nothing on a machine without a card raises (:func:`resolve_device`).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    first CUDA card. Never falls back to the CPU silently. A card named
    without an index gets the current card's, so the device compares
    equal to its tensors' (``cuda:0``, not ``cuda``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

