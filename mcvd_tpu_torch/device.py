"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device, caller: str) -> torch.device:
    """`torch.device(device)`; raises when it names CUDA and there is no CUDA
    device, so an entry point never falls back to the CPU on its own."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device; it runs on the card unless "
                           "called with device='cpu'")
    return d
