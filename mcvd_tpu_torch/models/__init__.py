from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import blocks, layers, resample
from .layers import init_weights
from .ncsnpp import ARCHS, NCSNpp, UNetMoreDDPM
from .ncsnv2 import (CondRefineNetDilated, NCSNv2, NCSNv2Deeper, NCSNv2Deepest,
                     get_ncsn_model)
from .unet import UNetLegacy


def build(config) -> torch.nn.Module:
    """The module of `config.model.arch`, built with zeros (nothing drawn, on
    the current default device): `unetmore`, `unetmore3d` and
    `unetmorepseudo3d` build `UNetMoreDDPM`, `unet` the legacy `UNetLegacy`,
    `ncsn` NCSNv1 and `ncsnv2` the NCSNv2 of the image size
    (`ncsnv2.get_ncsn_model`)."""
    arch = getattr(config.model, "arch", "unetmore")
    if arch in ARCHS:
        return UNetMoreDDPM(config)
    if arch == "unet":
        return UNetLegacy(config)
    if arch in ("ncsn", "ncsnv2"):
        return get_ncsn_model(config)
    raise ValueError(f"arch not valid: {arch} (expected unet/unetmore/unetmore3d/"
                     f"unetmorepseudo3d/ncsn/ncsnv2)")


def get_model(config, *, generator: Optional[torch.Generator] = None,
              device=DEFAULT_DEVICE) -> torch.nn.Module:
    """Build the model for `config.model.arch`, draw its weights from
    `generator` (a CPU generator seeded 0 when None) and move it to `device`
    (the card unless `device="cpu"`; raises without CUDA) with 4-D weights
    channels_last (`build` says which archs are ported)."""
    device = resolve_device(device, "get_model")
    model = build(config)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    model.to(device=device)
    for p in model.parameters():   # the 3D family's 5-D conv weights stay as they are
        if p.ndim == 4:
            p.data = p.data.contiguous(memory_format=torch.channels_last)
    return model


__all__ = ["CondRefineNetDilated", "NCSNpp", "NCSNv2", "NCSNv2Deeper", "NCSNv2Deepest",
           "UNetLegacy", "UNetMoreDDPM", "build", "get_model", "blocks", "layers",
           "resample"]
