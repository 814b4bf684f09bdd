"""Masked conditioning (counterpart of `mcvd_tpu/data/conditioning.py`;
upstream runners/ncsn_runner.py:104-147).

Splits a clip into predicted / past-cond / future-cond frames, folds frames
into channels frame-major, and Bernoulli-masks past and future per example
(independently, or the future with the past's mask under `prob_mask_sync`).

Layouts: the clip X is (B, T, H, W, C), as in the JAX package. A folded
tensor is the port's NCHW (B, F*C, H, W) stored channels_last: its memory is
the JAX package's (B, H, W, F*C) fold, channel f*C + c holding frame f.

The keep masks come from explicit uniform draws of shape (B,)
(`mask_draws["cond"]`, `mask_draws["future"]`, kept where u > p, as the JAX
package's `uniform > p`) or, where none is given, from `generator`.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from ..parallel import draws as rng


def fold_frames(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T*C, H, W) channels_last, frame-major."""
    B, T, H, W, C = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(B, H, W, T * C).permute(0, 3, 1, 2)


def unfold_frames(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, T*C, H, W) -> (B, T, H, W, C)."""
    B, TC, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H, W, n_frames, TC // n_frames).permute(
        0, 3, 1, 2, 4)


def _keep(name, draws, B, p, X, generator):
    u = None if draws is None else draws.get(name)
    if u is None:
        u = rng.rand((B,), generator, device=X.device)
    elif u.shape != (B,):
        raise ValueError(f"mask draw {name!r} must be ({B},), got {tuple(u.shape)}")
    return u.to(X.device) > p


def conditioning_fn(config, X: torch.Tensor, *, num_frames_pred: int = 0,
                    prob_mask_cond: float = 0.0, prob_mask_future: float = 0.0,
                    conditional: bool = True,
                    mask_draws: Optional[Mapping[str, torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None,
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(pred_frames, cond_frames, cond_mask): pred (B, pred*C, H, W); cond the
    past[+future] frames folded, or None if not `conditional`; cond_mask
    (B,) int32 in {0, 1}, only when prob_mask_cond > 0 (it feeds
    `model.cond_emb`), else None."""
    B = X.shape[0]
    if not conditional:
        return fold_frames(X), None, None
    cond = config.data.num_frames_cond
    pred = num_frames_pred
    train = config.data.num_frames
    future = getattr(config.data, "num_frames_future", 0)

    pred_frames = fold_frames(X[:, cond:cond + pred])
    cond_frames = fold_frames(X[:, :cond])

    cond_mask = None
    if prob_mask_cond > 0.0:
        keep = _keep("cond", mask_draws, B, prob_mask_cond, X, generator)
        cond_frames = keep.to(cond_frames.dtype)[:, None, None, None] * cond_frames
        cond_mask = keep.to(torch.int32)

    if future > 0:
        if prob_mask_future == 1.0:
            H, W = cond_frames.shape[2:]
            future_frames = fold_frames(X.new_zeros(B, future, H, W, config.data.channels))
        else:
            future_frames = fold_frames(X[:, cond + train:cond + train + future])
            if prob_mask_future > 0.0:
                if getattr(config.data, "prob_mask_sync", False):
                    keep_f = cond_mask.bool()
                else:
                    keep_f = _keep("future", mask_draws, B, prob_mask_future, X, generator)
                future_frames = keep_f.to(future_frames.dtype)[:, None, None, None] * \
                    future_frames
        cond_frames = torch.cat([cond_frames, future_frames], dim=1)
    return pred_frames, cond_frames, cond_mask


def get_mode(config):
    """Task-taxonomy switch (upstream ncsn_runner.py:207-227): (mode_pred,
    mode_interp, mode_gen) from the masking config."""
    condp = getattr(config.data, "prob_mask_cond", 0.0)
    futrf = getattr(config.data, "num_frames_future", 0)
    futrp = getattr(config.data, "prob_mask_future", 0.0)
    sync = getattr(config.data, "prob_mask_sync", False)
    if not getattr(config.sampling, "ssim", False):
        if getattr(config.sampling, "fvd", False):
            return None, None, "three"
        return None, None, None
    if condp == 0.0 and futrf == 0:
        return "one", None, None                 # prediction
    if condp == 0.0 and futrf > 0 and futrp == 0.0:
        return None, "one", None                 # interpolation
    if condp == 0.0 and futrf > 0 and futrp > 0.0:
        return "two", "one", None                # interp + pred
    if condp > 0.0 and futrf == 0:
        return "one", None, "three"              # pred + gen
    if condp > 0.0 and futrf > 0 and futrp > 0.0 and not sync:
        return "two", "one", "three"             # interp + pred + gen
    if condp > 0.0 and futrf > 0 and futrp > 0.0 and sync:
        return None, "one", "three"              # interp + gen
    return None, None, None
