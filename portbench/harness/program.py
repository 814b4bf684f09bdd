"""What the benchmark takes from the program under test (`mcvd_tpu_torch`):
its configuration object, its model with the benchmark's weights in it."""

from __future__ import annotations

import argparse
import copy
from typing import Dict

import torch


def namespace(d: dict) -> argparse.Namespace:
    """A configuration dict as the program's nested Namespace."""
    ns = argparse.Namespace()
    for k, v in d.items():
        setattr(ns, k, namespace(v) if isinstance(v, dict) else copy.deepcopy(v))
    return ns


def build_model(config: argparse.Namespace, weights: Dict[str, torch.Tensor], device):
    """The program's model for `config` on `device` holding copies of
    `weights`, laid out as `models.get_model` lays its own out (4-D
    weights channels_last). Every parameter must have its weight, of its
    shape."""
    from mcvd_tpu_torch.models import build

    model = build(config).to(device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the program's parameters differ from the reference's: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        w = weights[name]
        if tuple(p.shape) != tuple(w.shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, reference {tuple(w.shape)}")
        fmt = torch.channels_last if p.ndim == 4 else torch.contiguous_format
        p.data = w.to(device).clone(memory_format=fmt)
    return model
