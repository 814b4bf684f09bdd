from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import blocks, layers, resample
from .layers import init_weights
from .ncsnpp import NCSNpp, UNetMoreDDPM


def get_model(config, *, generator: Optional[torch.Generator] = None,
              device=DEFAULT_DEVICE) -> torch.nn.Module:
    """Build the model for `config.model.arch`, draw its weights from
    `generator` (a CPU generator seeded 0 when None) and move it to `device`
    (the card unless `device="cpu"`; raises without CUDA) with 4-D weights
    channels_last. Only `unetmore` (2D) is ported."""
    device = resolve_device(device, "get_model")
    arch = getattr(config.model, "arch", "unetmore")
    if arch != "unetmore":
        raise NotImplementedError(
            f"arch {arch!r} not ported yet (ROADMAP Queue 1 item 13: model variants)")
    model = UNetMoreDDPM(config)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device=device, memory_format=torch.channels_last)


__all__ = ["NCSNpp", "UNetMoreDDPM", "get_model", "blocks", "layers", "resample"]
