"""Noise schedules (counterpart of `mcvd_tpu/diffusion/schedules.py`).

Plain numpy, re-implemented because importing `mcvd_tpu.diffusion` loads jax.
Quirks kept for checkpoint parity with the upstream code:
  * index 0 is the MOST-noised level: alphas = cumprod(1 - betas[::-1])[::-1],
    alphas_prev = concat([alphas[1:], [1]]);
  * a subsampled beta is re-derived as 1 - alpha/alpha_prev.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def get_sigmas(config) -> np.ndarray:
    """Beta/sigma ladder large->small (linear/geometric); alpha-bar ladder
    for cosine."""
    model = config.model
    T = int(model.num_classes)
    dist = model.sigma_dist
    if dist == "geometric":
        return np.logspace(
            np.log10(model.sigma_begin), np.log10(model.sigma_end), T
        ).astype(np.float32)
    if dist == "linear":
        return np.linspace(model.sigma_begin, model.sigma_end, T, dtype=np.float32)
    if dist == "cosine":
        t = np.linspace(T, 0, T + 1, dtype=np.float32) / T
        s = 0.008
        f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
        return (f[:-1] / f[-1]).astype(np.float32)
    raise NotImplementedError(f"sigma distribution {dist} not supported")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Immutable float32 tables of length T (DDPM family: betas, alphas,
    alphas_prev; SMLD: sigmas; gamma noise: k_cum, theta_t)."""

    version: str
    schedule: str
    sigmas: Optional[np.ndarray] = None
    betas: Optional[np.ndarray] = None
    alphas: Optional[np.ndarray] = None
    alphas_prev: Optional[np.ndarray] = None
    k_cum: Optional[np.ndarray] = None
    theta_t: Optional[np.ndarray] = None

    @property
    def T(self) -> int:
        arr = self.alphas if self.alphas is not None else self.sigmas
        return len(arr)


def make_schedule(config) -> DiffusionSchedule:
    version = getattr(config.model, "version", "SMLD").upper()
    dist = config.model.sigma_dist
    ladder = get_sigmas(config)

    if version == "SMLD":
        return DiffusionSchedule(version=version, schedule=dist, sigmas=ladder)

    if dist == "linear":
        betas = ladder
        alphas = np.cumprod(1.0 - betas[::-1], dtype=np.float32)[::-1].copy()
        alphas_prev = np.concatenate([alphas[1:], np.float32([1.0])])
    elif dist == "cosine":
        alphas = ladder
        alphas_prev = np.concatenate([alphas[1:], np.float32([1.0])])
        betas = 1.0 - alphas / alphas_prev
    else:
        raise NotImplementedError(f"{dist} schedule unsupported for {version}")

    k_cum = theta_t = None
    if getattr(config.model, "gamma", False):
        theta_0 = 0.001
        k = betas / (alphas * theta_0**2)
        k_cum = np.cumsum(k[::-1], dtype=np.float32)[::-1].copy()
        theta_t = np.sqrt(alphas) * theta_0

    return DiffusionSchedule(
        version=version,
        schedule=dist,
        betas=betas.astype(np.float32),
        alphas=alphas.astype(np.float32),
        alphas_prev=alphas_prev.astype(np.float32),
        k_cum=None if k_cum is None else k_cum.astype(np.float32),
        theta_t=None if theta_t is None else theta_t.astype(np.float32),
    )


def subsample_schedule(sched: DiffusionSchedule, subsample_steps: Optional[int]):
    """(steps, alphas, alphas_prev, betas, k_cum, theta_t): `steps` are the
    ORIGINAL indices fed to the model as labels; alphas are gathered,
    alphas_prev shifts within the subsampled table, betas are re-derived."""
    if sched.alphas is None:
        raise ValueError("subsample_schedule needs a DDPM-family schedule")
    T = len(sched.alphas)
    if subsample_steps is None or subsample_steps >= T:
        return (np.arange(T), sched.alphas, sched.alphas_prev, sched.betas,
                sched.k_cum, sched.theta_t)
    skip = T // subsample_steps
    steps = np.arange(0, T, skip)
    alphas = sched.alphas[steps]
    alphas_prev = np.concatenate([alphas[1:], np.float32([1.0])])
    betas = 1.0 - alphas / alphas_prev
    k_cum = sched.k_cum[steps] if sched.k_cum is not None else None
    theta_t = sched.theta_t[steps] if sched.theta_t is not None else None
    return steps, alphas, alphas_prev, betas, k_cum, theta_t
