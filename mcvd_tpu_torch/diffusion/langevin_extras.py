"""The specialty SMLD Langevin samplers: inpainting, interpolation, sparse and
sparse-consistent (counterpart of `mcvd_tpu/diffusion/langevin_extras.py`;
upstream models/__init__.py:413-483, :581-677, :680-716, :719-771).

Tensors are the JAX package's layout, (B, H, W, C) with C the folded frames,
as the port's other samplers take them. Upstream's conventions are kept
literally, as the JAX package keeps them: inpainting and interpolation step
`x + step * grad` (ncsnv1's score convention), sparse `x - step / sigma *
grad` (ncsnv2's), sparse-consistent treats the output as a score, `x + eta
sigma^2 grad`; and each function's trajectory quirk (which state it
records, and when) is the JAX function's, pinned there against runs of the
upstream functions (`tests/golden/langevin_extras.npz`).

Every function takes `noises`, the exact draws in the JAX functions' shapes
(the golden-parity seam); without them the draws come from `generator`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .samplers import _draw, check_n_steps_each, consistent_ladder
from .schedules import DiffusionSchedule

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _labels(B: int, c: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((B,), c, dtype=torch.long, device=like.device)


def _level_steps(sched: DiffusionSchedule, step_lr: float):
    """(sigma, step) of each level in fp32: step = step_lr (sigma / sigma_L)^2."""
    f32 = np.float32
    sigmas = np.asarray(sched.sigmas, f32)
    return [(s, f32(step_lr) * (s / sigmas[-1]) ** 2) for s in sigmas]


def anneal_langevin_inpainting(
    x_mod: torch.Tensor,
    refer_image: torch.Tensor,
    eps_fn: EpsFn,
    sched: DiffusionSchedule,
    *,
    n_steps_each: int = 100,
    step_lr: float = 0.000008,
    final_only: bool = True,
    noises=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Left-half-known inpainting (upstream :680-716): each inner step
    overwrites the left W//2 columns with the reference plus sigma * noise,
    then steps x + step * eps + sqrt(2 step) * noise. `noises` is (corrupt
    (L, n, B, H, W//2, C), step (L, n, B, H, W, C)). final_only=False gives
    upstream's trajectory: state t after its overwrite, before its update
    (L*n states; the last update is not in it)."""
    n_steps_each = check_n_steps_each(n_steps_each)
    cols = x_mod.shape[2] // 2
    B = x_mod.shape[0]
    half = refer_image[:, :, :cols]
    x = x_mod
    traj = []
    for c, (sigma, step) in enumerate(_level_steps(sched, step_lr)):
        labels = _labels(B, c, x)
        for j in range(n_steps_each):
            if noises is None:
                n_corrupt, n_step = _draw(generator, half), _draw(generator, x)
            else:
                n_corrupt, n_step = noises[0][c, j], noises[1][c, j]
            x = x.clone()
            x[:, :, :cols] = half + n_corrupt * float(sigma)
            if not final_only:
                traj.append(x)
            noise = n_step * float(np.sqrt(step * np.float32(2.0)))
            x = x + float(step) * eps_fn(x, labels).to(x.dtype) + noise
    return x if final_only else torch.stack(traj)


def anneal_langevin_interpolation(
    x_mod: torch.Tensor,
    eps_fn: EpsFn,
    sched: DiffusionSchedule,
    n_interpolations: int,
    *,
    n_steps_each: int = 200,
    step_lr: float = 0.000008,
    final_only: bool = True,
    noises=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Slerp-noise interpolation (upstream :719-771): each of the B rows is
    repeated n_interpolations times, and row (b, k) is driven by noise
    p_b cos(a_k) + q_b sin(a_k), a_k = linspace(0, pi/2, n); each step is x +
    step * eps + sqrt(2 step) * noise. `noises` is (L, n, 2, B, H, W, C), the
    (p, q) of each step. final_only=False records the state after each
    update."""
    n_steps_each = check_n_steps_each(n_steps_each)
    B, H, W, C = x_mod.shape
    x = x_mod[:, None].expand(B, n_interpolations, H, W, C).reshape(-1, H, W, C)
    angles = np.linspace(0, np.pi / 2.0, n_interpolations).astype(np.float32)
    cos = torch.as_tensor(np.cos(angles), device=x.device).view(1, -1, 1, 1, 1)
    sin = torch.as_tensor(np.sin(angles), device=x.device).view(1, -1, 1, 1, 1)
    traj = []
    for c, (sigma, step) in enumerate(_level_steps(sched, step_lr)):
        labels = _labels(x.shape[0], c, x)
        for j in range(n_steps_each):
            if noises is None:
                p, q = _draw(generator, x_mod), _draw(generator, x_mod)
            else:
                p, q = noises[c, j, 0], noises[c, j, 1]
            noise = (p[:, None] * cos + q[:, None] * sin).reshape(-1, H, W, C)
            grad = eps_fn(x, labels).to(x.dtype)
            x = x + float(step) * grad + noise * float(np.sqrt(step * np.float32(2.0)))
            if not final_only:
                traj.append(x)
    return x if final_only else torch.stack(traj)


def sparse_anneal_langevin(
    x_mod_sparse: torch.Tensor,
    sparsity: float,
    eps_fn: EpsFn,
    sched: DiffusionSchedule,
    *,
    n_steps_each: int = 200,
    step_lr: float = 0.000008,
    denoise: bool = True,
    final_only: bool = True,
    noises=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sparse Langevin (upstream :413-483): a dense chain x steps x - step /
    sigma * eps(x) + sqrt(2 step) noise, while the sparse iterate takes
    eps / sparsity and sparsity * noise; `denoise` ends xs - sigma_L *
    sparsity * eps(x, L-1). `noises` is (L, n, B, H, W, C).
    final_only=False records the sparse iterate after each step (and the
    denoised one)."""
    n_steps_each = check_n_steps_each(n_steps_each)
    B = x_mod_sparse.shape[0]
    x = xs = x_mod_sparse
    traj = []
    levels = _level_steps(sched, step_lr)
    for c, (sigma, step) in enumerate(levels):
        labels = _labels(B, c, x)
        c_grad, c_noise = float(step / sigma), float(np.sqrt(step * np.float32(2.0)))
        for j in range(n_steps_each):
            grad = eps_fn(x, labels).to(x.dtype)
            noise = _draw(generator, x) if noises is None else noises[c, j]
            x = x - c_grad * grad + c_noise * noise
            xs = xs - c_grad * (grad / sparsity) + c_noise * (sparsity * noise)
            if not final_only:
                traj.append(xs)
    if denoise:
        labels = _labels(B, len(levels) - 1, x)
        xs = xs - float(levels[-1][0]) * sparsity * eps_fn(x, labels).to(x.dtype)
        if not final_only:
            traj.append(xs)
    return xs if final_only else torch.stack(traj)


def sparse_anneal_langevin_consistent(
    x_mod_sparse: torch.Tensor,
    sparsity: float,
    score_fn_sigma: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: DiffusionSchedule,
    *,
    n_steps_each: int = 200,
    step_lr: float = 0.000008,
    denoise: bool = True,
    final_only: bool = True,
    score_fn_label: Optional[EpsFn] = None,
    noises=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sparse consistent sampling (upstream :581-677) on
    `samplers.consistent_ladder`, with upstream's quirks: the dense chain x
    steps x + eta sigma^2 score(x, sigma), then + beta sigma_next noise; the
    sparse iterate gets only sparsity * that noise in the loop, and one
    denoise step xs + sigma_L / sparsity * score(x, L-1) taken at the
    denoised dense state. `score_fn_sigma` takes raw sigma values,
    `score_fn_label` (labels) the denoise where given. `noises` is
    (T-1, B, H, W, C). final_only=False records the DENSE iterates before
    their noise (and the denoised dense state); final_only returns xs."""
    n_steps_each = check_n_steps_each(n_steps_each)
    ladder, nxt, beta, eta = consistent_ladder(sched, n_steps_each, step_lr)
    f32 = np.float32
    T = len(ladder)
    B = x_mod_sparse.shape[0]
    x = xs = x_mod_sparse
    traj = []
    for i in range(T):
        used = torch.full((B,), float(ladder[i]), dtype=x.dtype, device=x.device)
        grad = score_fn_sigma(x, used).to(x.dtype)
        x = x + float(f32(eta) * ladder[i] ** 2) * grad
        if not final_only:
            traj.append(x)
        if i < T - 1:
            noise = _draw(generator, x) if noises is None else noises[i]
            x = x + float(nxt[i] * beta[i]) * noise
            xs = xs + float(nxt[i] * beta[i] * f32(sparsity)) * noise
    if denoise:
        sigma_L = float(f32(sched.sigmas[-1]))
        if score_fn_label is not None:
            labels = _labels(B, len(sched.sigmas) - 1, x)
            x = x + sigma_L * score_fn_label(x, labels).to(x.dtype)
            xs = xs + sigma_L * (1.0 / sparsity) * score_fn_label(x, labels).to(x.dtype)
        else:
            used = torch.full((B,), float(ladder[-1]), dtype=x.dtype, device=x.device)
            x = x + sigma_L * score_fn_sigma(x, used).to(x.dtype)
            xs = xs + sigma_L * (1.0 / sparsity) * score_fn_sigma(x, used).to(x.dtype)
        if not final_only:
            traj.append(x)
    return xs if final_only else torch.stack(traj)
