"""Denoising score-matching training loss (counterpart of
`mcvd_tpu/diffusion/loss.py`; upstream losses/dsm.py:7-52).

Tensors are the port's NCHW folds (B, F*C, H, W). The noise level `labels`
(B,) and the noise `z` (x's shape) are explicit arguments or, where not
given, drawn from `generator` on x's device: the tests replay the JAX draws.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .schedules import DiffusionSchedule


def dsm_loss(model_fn: Callable[..., torch.Tensor], x: torch.Tensor,
             sched: DiffusionSchedule, *, labels: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None, cond: Optional[torch.Tensor] = None,
             cond_mask: Optional[torch.Tensor] = None, gamma: bool = False,
             L1: bool = False, all_frames: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean over the batch of the per-example sum of 0.5*(z - model(x_t, t))^2
    (|.| if L1), a 0-dim fp32 tensor.

    `model_fn(x_t, labels, cond, cond_mask)` returns the predicted noise.
    DDPM family: x_t = sqrt(abar_t) x + sqrt(1 - abar_t) z, t ~ U{0..T-1};
    SMLD: x_t = x + sigma_t z. `all_frames` concatenates cond into the
    target along the channels (dim 1 here) and drops the conditioning."""
    if gamma:
        raise NotImplementedError(
            "gamma noise: not ported yet (ROADMAP Queue 1 item 5: sampling options)")
    B = x.shape[0]
    if all_frames and cond is not None:
        x = torch.cat([x, cond], dim=1)
        cond = None
    table = sched.sigmas if sched.version == "SMLD" else sched.alphas
    if labels is None:
        labels = torch.randint(0, len(table), (B,), generator=generator, device=x.device)
    labels = labels.to(device=x.device, dtype=torch.long)
    used = torch.as_tensor(table, device=x.device)[labels].view((B,) + (1,) * (x.ndim - 1))
    if z is None:
        z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    elif z.shape != x.shape:
        raise ValueError(f"dsm_loss: z {tuple(z.shape)} is not x's {tuple(x.shape)}")
    if sched.version == "SMLD":
        perturbed = x + used * z
    else:
        perturbed = torch.sqrt(used) * x + torch.sqrt(1.0 - used) * z

    pred = model_fn(perturbed, labels, cond, cond_mask)
    diff = (z - pred).reshape(B, -1)
    if L1:
        per_example = diff.abs().sum(dim=-1)
    else:
        per_example = 0.5 * diff.square().sum(dim=-1)
    return per_example.mean()
