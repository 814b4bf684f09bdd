"""Denoising score-matching training loss (counterpart of
`mcvd_tpu/diffusion/loss.py`; upstream losses/dsm.py:7-52).

Tensors are the port's NCHW folds (B, F*C, H, W). The noise level `labels`
(B,) and the noise draw `z` (x's shape) are explicit arguments or, where not
given, drawn from `generator` on x's device: the tests replay the JAX draws.
With gamma noise the draw is the Gamma(k_cum[labels], 1) sample, which the
loss centres and scales into the noise, as the samplers do.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel import draws as rng
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
    with `gamma` (DDPM family), z = (g - k) theta / sqrt(1 - abar_t) from the
    draw g ~ Gamma(k_cum[t], 1), theta = theta_t[t]; SMLD: x_t = x +
    sigma_t z. `all_frames` concatenates cond into the target along the
    channels (dim 1 here) and drops the conditioning."""
    B = x.shape[0]
    if all_frames and cond is not None:
        x = torch.cat([x, cond], dim=1)
        cond = None
    table = sched.sigmas if sched.version == "SMLD" else sched.alphas
    if labels is None:
        labels = rng.randint(len(table), (B,), generator, device=x.device)
    labels = labels.to(device=x.device, dtype=torch.long)
    bshape = (B,) + (1,) * (x.ndim - 1)
    used = torch.as_tensor(table, device=x.device)[labels].view(bshape)
    gamma = gamma and sched.version != "SMLD"
    if gamma:
        k = torch.as_tensor(sched.k_cum, device=x.device)[labels].view(bshape)
        theta = torch.as_tensor(sched.theta_t, device=x.device)[labels].view(bshape)
    if z is None and gamma:
        z = rng.standard_gamma(k.expand(x.shape).contiguous(), generator)
    elif z is None:
        z = rng.randn(x.shape, generator, device=x.device, dtype=x.dtype)
    elif z.shape != x.shape:
        raise ValueError(f"dsm_loss: z {tuple(z.shape)} is not x's {tuple(x.shape)}")
    if gamma:
        z = (z * theta - k * theta) / torch.sqrt(1.0 - used)
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
