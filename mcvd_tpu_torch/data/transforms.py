"""Data transforms (counterpart of `mcvd_tpu/data/transforms.py`;
upstream datasets/__init__.py:228-261).

Dequantization draws its noise from an explicit tensor of X's shape
(`uniform` in [0, 1), `normal` N(0, 1)) or, where none is given, from
`generator` on X's device: the tests replay the JAX draws this way.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import draws as rng


def logit_transform(image: torch.Tensor, lam: float = 1e-6) -> torch.Tensor:
    image = lam + (1 - 2 * lam) * image
    return torch.log(image) - torch.log1p(-image)


def _draw(explicit, X, generator, sample):
    if explicit is not None:
        if explicit.shape != X.shape:
            raise ValueError(f"dequantization noise {tuple(explicit.shape)} is not X's "
                             f"{tuple(X.shape)}")
        return explicit.to(device=X.device, dtype=X.dtype)
    return sample(X.shape, generator, device=X.device, dtype=X.dtype)


def data_transform(config, X: torch.Tensor, *, uniform: Optional[torch.Tensor] = None,
                   normal: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    data = config.data
    if getattr(data, "uniform_dequantization", False):
        X = X / 256.0 * 255.0 + _draw(uniform, X, generator, rng.rand) / 256.0
    if getattr(data, "gaussian_dequantization", False):
        X = X + _draw(normal, X, generator, rng.randn) * 0.01
    if getattr(data, "rescaled", False):
        return 2 * X - 1.0
    if getattr(data, "logit_transform", False):
        return logit_transform(X)
    return X


def inverse_data_transform(config, X: torch.Tensor) -> torch.Tensor:
    data = config.data
    if getattr(data, "logit_transform", False):
        X = torch.sigmoid(X)
    elif getattr(data, "rescaled", False):
        X = (X + 1.0) / 2.0
    return X.clamp(0.0, 1.0)
