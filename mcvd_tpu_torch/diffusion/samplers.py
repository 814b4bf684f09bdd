"""DDPM reverse-diffusion sampler (counterpart of
`mcvd_tpu/diffusion/samplers.py`).

`eps_fn(x, labels) -> eps` is the score network bound to its weights and
cond, returning predicted noise. The JAX `lax.scan` becomes a Python loop.
Random draws come either explicitly (`inj_noise`, `step_noise`: the tests
replay the JAX draws through them) or from a `torch.Generator`.

Quirks kept for parity with upstream (models/__init__.py:206-340):
  * subsampled betas are re-derived as 1 - alpha/alpha_prev;
  * the final `denoise` step feeds label L-1, an index in the SUBSAMPLED
    table, while using the subsampled table's last alpha;
  * the last step adds no noise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .schedules import DiffusionSchedule, subsample_schedule

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class _Tables(NamedTuple):
    steps: np.ndarray        # original-schedule indices fed as labels
    alphas: np.ndarray
    alphas_prev: np.ndarray
    betas: np.ndarray
    k_cum: Optional[np.ndarray]
    theta_t: Optional[np.ndarray]
    noise_injected: bool     # t_min > 0: x is noised to alphas[0] first


def _prepare_tables(sched: DiffusionSchedule, subsample_steps: Optional[int],
                    frac_steps: Optional[float], t_min: float) -> _Tables:
    steps, alphas, alphas_prev, betas, k_cum, theta_t = subsample_schedule(
        sched, subsample_steps)
    if frac_steps is not None:
        # upstream indexes with original step ids here, only well-formed
        # without subsampling
        if subsample_steps is not None and subsample_steps < sched.T:
            raise ValueError("frac_steps cannot be combined with subsample_steps")
        i0 = int((1 - frac_steps) * len(steps))
        sl = slice(i0, None)
        steps, alphas, alphas_prev, betas = steps[sl], alphas[sl], alphas_prev[sl], betas[sl]
        k_cum = k_cum[sl] if k_cum is not None else None
        theta_t = theta_t[sl] if theta_t is not None else None

    noise_injected = False
    if t_min > 0:
        # skip steps with original index < t_min * len(table), then noise the
        # input to the first executed level
        keep = steps >= t_min * len(alphas)
        if not keep.any():
            raise ValueError(f"t_min={t_min} skips every step")
        sl = slice(int(np.argmax(keep)), None)
        steps, alphas, alphas_prev, betas = steps[sl], alphas[sl], alphas_prev[sl], betas[sl]
        k_cum = k_cum[sl] if k_cum is not None else None
        theta_t = theta_t[sl] if theta_t is not None else None
        noise_injected = True
    return _Tables(steps, alphas, alphas_prev, betas, k_cum, theta_t, noise_injected)


def _draw(generator: Optional[torch.Generator], like: torch.Tensor) -> torch.Tensor:
    if generator is None:
        raise ValueError("ddpm_sampler needs a torch.Generator or explicit draws")
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def ddpm_sampler(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sched: DiffusionSchedule,
    *,
    subsample_steps: Optional[int] = None,
    final_only: bool = True,
    denoise: bool = True,
    clip_before: bool = True,
    just_beta: bool = False,
    frac_steps: Optional[float] = None,
    t_min: float = -1.0,
    gamma: bool = False,
    same_noise: bool = False,
    noise_val: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    inj_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    **_: object,
) -> torch.Tensor:
    """DDPM ancestral sampler. Per step i (label = original index steps[i]):
        x0 = (x - sqrt(1-a)*eps) / sqrt(a)            [clipped to [-1,1]]
        x  = sqrt(a_prev)*b/(1-a) * x0 + sqrt(1-b)*(1-a_prev)/(1-a) * x
        x += sqrt((1-a_prev)/(1-a)*b) * z             [sqrt(b) if just_beta]
    with no noise on the last step; `denoise` then subtracts sqrt(1-a_L)*eps.

    Draws: `inj_noise` (x's shape) for the t_min noise injection; `step_noise`
    (L, *x.shape), entry i for step i (entry L-1 is never read, as the last
    step adds no noise); otherwise each is drawn from `generator` when
    needed. The chain math runs in x_init's dtype (fp32), whatever eps_fn's
    compute dtype. Returns x[None] if final_only, else the trajectory
    (L[+1], *x.shape).
    """
    if gamma:
        raise NotImplementedError(
            "gamma noise: not ported yet (ROADMAP Queue 1 item 5: sampling options)")
    t = _prepare_tables(sched, subsample_steps, frac_steps, t_min)
    L = len(t.steps)
    f32 = np.float32
    a, ap, b = t.alphas.astype(f32), t.alphas_prev.astype(f32), t.betas.astype(f32)
    one = f32(1.0)
    sq1ma = np.sqrt(one - a)
    sqa = np.sqrt(a)
    c_x0 = np.sqrt(ap) * b / (one - a)
    c_x = np.sqrt(one - b) * (one - ap) / (one - a)
    std = np.sqrt(b) if just_beta else np.sqrt((one - ap) / (one - a) * b)

    x = x_init
    if t.noise_injected:
        z = inj_noise if inj_noise is not None else _draw(generator, x)
        x = float(np.sqrt(a[0])) * x + float(np.sqrt(one - a[0])) * z
    if same_noise and noise_val is None:
        noise_val = x_init
    if step_noise is not None and len(step_noise) < L - 1:
        raise ValueError(f"step_noise holds {len(step_noise)} draws, {L} steps need {L - 1}")

    B = x.shape[0]
    traj = []
    for i in range(L):
        labels = torch.full((B,), int(t.steps[i]), dtype=torch.long, device=x.device)
        eps = eps_fn(x, labels).to(x.dtype)
        x0 = (x - float(sq1ma[i]) * eps) / float(sqa[i])
        if clip_before:
            x0 = x0.clamp(-1.0, 1.0)
        x = float(c_x0[i]) * x0 + float(c_x[i]) * x
        if i < L - 1:
            if same_noise:
                noise = noise_val
            elif step_noise is not None:
                noise = step_noise[i]
            else:
                noise = _draw(generator, x)
            x = x + float(std[i]) * noise
        if not final_only:
            traj.append(x)

    if denoise:
        labels = torch.full((B,), L - 1, dtype=torch.long, device=x.device)
        x = x - float(sq1ma[-1]) * eps_fn(x, labels).to(x.dtype)
        if not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)


SAMPLERS = {"DDPM": ddpm_sampler}


def get_sampler(version: str):
    """Sampler for `model.version`; only DDPM is ported."""
    version = version.upper()
    if version not in SAMPLERS:
        raise NotImplementedError(
            f"sampler {version}: not ported yet (ROADMAP Queue 1 item 12: other samplers)")
    return SAMPLERS[version]
