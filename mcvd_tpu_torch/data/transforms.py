"""Data transforms (counterpart of `mcvd_tpu/data/transforms.py`;
upstream datasets/__init__.py:228-261). Dequantization is not ported yet
(ROADMAP Queue 1 item 8: training)."""

from __future__ import annotations

import torch


def logit_transform(image: torch.Tensor, lam: float = 1e-6) -> torch.Tensor:
    image = lam + (1 - 2 * lam) * image
    return torch.log(image) - torch.log1p(-image)


def data_transform(config, X: torch.Tensor) -> torch.Tensor:
    data = config.data
    if getattr(data, "uniform_dequantization", False) or getattr(
            data, "gaussian_dequantization", False):
        raise NotImplementedError(
            "dequantization: not ported yet (ROADMAP Queue 1 item 8: training)")
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
