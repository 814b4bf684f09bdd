"""The reverse-diffusion samplers: the DDPM family's DDPM, DDIM (eta 0) and
F-PNDM, and SMLD's annealed Langevin dynamics and its consistent form
(counterpart of `mcvd_tpu/diffusion/samplers.py`).

`eps_fn(x, labels) -> eps` is the score network bound to its weights and
cond, returning predicted noise. The JAX `lax.scan`s become Python loops.
Random draws come either explicitly (`inj_noise`, `step_noise`: the tests
replay the JAX draws through them) or from a `torch.Generator`. With gamma
noise a draw is the standard Gamma(k, 1) sample, which the sampler centres
and scales (`_gamma_noise`). All samplers share one call surface,
`(x_init, eps_fn, sched, *, generator, inj_noise, step_noise, ...)`; what a
sampler does not use it ignores.

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


def _draw(generator: Optional[torch.Generator], like: torch.Tensor,
          k: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) in like's shape, or with `k` the standard Gamma(k, 1)."""
    if generator is None:
        raise ValueError("the sampler needs a torch.Generator or explicit draws")
    if k is None:
        return torch.randn(like.shape, generator=generator, device=like.device,
                           dtype=like.dtype)
    conc = torch.full(like.shape, float(k), device=like.device, dtype=torch.float32)
    return torch._standard_gamma(conc, generator=generator).to(like.dtype)


def _gamma_noise(g: torch.Tensor, k, theta, alpha) -> torch.Tensor:
    """Centred and scaled Gamma noise from the Gamma(k, 1) draw g (upstream
    models/__init__.py:272-279): (g theta - k theta) / sqrt(1 - alpha)."""
    f32 = np.float32
    z = g * float(f32(theta))
    return (z - float(f32(k) * f32(theta))) / float(np.sqrt(f32(1.0) - f32(alpha)))


def _maybe_inject_noise(x, t: _Tables, gamma: bool, generator, inj_noise):
    """The t_min warm start: x noised to the first executed level, with
    `inj_noise` (N(0, 1), or Gamma(k_cum[0], 1) with gamma) or a draw."""
    if not t.noise_injected:
        return x
    a0 = np.float32(t.alphas[0])
    z = inj_noise if inj_noise is not None else _draw(
        generator, x, t.k_cum[0] if gamma else None)
    if gamma:
        z = _gamma_noise(z, t.k_cum[0], t.theta_t[0], a0)
    return float(np.sqrt(a0)) * x + float(np.sqrt(np.float32(1.0) - a0)) * z


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
    With `gamma`, z is centred Gamma noise: (g - k_i) theta_i / sqrt(1-a) from
    a Gamma(k_cum[i], 1) draw g.

    Draws: `inj_noise` (x's shape) for the t_min noise injection; `step_noise`
    (L, *x.shape), entry i for step i (entry L-1 is never read, as the last
    step adds no noise); N(0, 1), or Gamma(k, 1) with gamma; otherwise each
    is drawn from `generator` when needed. The chain math runs in x_init's
    dtype (fp32), whatever eps_fn's compute dtype. Returns x[None] if
    final_only, else the trajectory (L[+1], *x.shape).
    """
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

    x = _maybe_inject_noise(x_init, t, gamma, generator, inj_noise)
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
            else:
                noise = step_noise[i] if step_noise is not None else _draw(
                    generator, x, t.k_cum[i] if gamma else None)
                if gamma:
                    noise = _gamma_noise(noise, t.k_cum[i], t.theta_t[i], a[i])
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


def ddim_sampler(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sched: DiffusionSchedule,
    *,
    subsample_steps: Optional[int] = None,
    final_only: bool = True,
    denoise: bool = True,
    clip_before: bool = True,
    frac_steps: Optional[float] = None,
    t_min: float = -1.0,
    gamma: bool = False,
    generator: Optional[torch.Generator] = None,
    inj_noise: Optional[torch.Tensor] = None,
    **_: object,
) -> torch.Tensor:
    """DDIM with eta 0 (upstream models/__init__.py:102-203). Per step i:
        x0 = (x - sqrt(1-a)*eps) / sqrt(a)            [clipped to [-1,1]]
        x  = sqrt(a_prev)*x0 + sqrt(1-a_prev)*eps
    then `denoise` as `ddpm_sampler`'s (label L-1). Only the t_min noise
    injection draws (`inj_noise` or `generator`)."""
    t = _prepare_tables(sched, subsample_steps, frac_steps, t_min)
    L = len(t.steps)
    f32 = np.float32
    a, ap = t.alphas.astype(f32), t.alphas_prev.astype(f32)
    one = f32(1.0)
    sq1ma, sqa = np.sqrt(one - a), np.sqrt(a)
    sqap, sq1map = np.sqrt(ap), np.sqrt(one - ap)

    x = _maybe_inject_noise(x_init, t, gamma, generator, inj_noise)
    B = x.shape[0]
    traj = []
    for i in range(L):
        labels = torch.full((B,), int(t.steps[i]), dtype=torch.long, device=x.device)
        eps = eps_fn(x, labels).to(x.dtype)
        x0 = (x - float(sq1ma[i]) * eps) / float(sqa[i])
        if clip_before:
            x0 = x0.clamp(-1.0, 1.0)
        x = float(sqap[i]) * x0 + float(sq1map[i]) * eps
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


def _pndm_transfer(x, at, at_next, et, clip_before: bool):
    """PNDM transfer rule (upstream models/pndm.py:19-33), its coefficients
    in fp32 from the scalars at, at_next:
    x + (at_next - at) * (x / (sqrt(at) (sqrt(at) + sqrt(at_next)))
        - et / (sqrt(at) (sqrt((1 - at_next) at) + sqrt((1 - at) at_next))))."""
    f32 = np.float32
    at, at_next = f32(at), f32(at_next)
    sa, sn = np.sqrt(at), np.sqrt(at_next)
    one = f32(1.0)
    d = at_next - at
    cx = one / (sa * (sa + sn))
    ce = one / (sa * (np.sqrt((one - at_next) * at) + np.sqrt((one - at) * at_next)))
    x_next = x + float(d) * (float(cx) * x - float(ce) * et)
    if clip_before:
        x_next = x_next.clamp(-1.0, 1.0)
    return x_next


def fpndm_sampler(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sched: DiffusionSchedule,
    *,
    subsample_steps: Optional[int] = None,
    final_only: bool = True,
    clip_before: bool = True,
    **_: object,
) -> torch.Tensor:
    """F-PNDM, 4th order (upstream models/__init__.py:38-99 and
    models/pndm.py): a Runge-Kutta warm-up on the first 3 steps (4
    evaluations each), then Adams-Bashforth (55 e1 - 59 e2 + 37 e3 - 9 e4)/24
    (1 evaluation each); no denoise and no draws, so L steps make 4*min(L, 3)
    + max(L - 3, 0) evaluations (109 at subsample 100).

    Steps are range(0, T, T // subsample_steps), each taken with its
    predecessor t_next (-1 for the first); alphas come from the
    time-ascending table alphas[::-1] at t + 1; the Runge-Kutta midpoint is
    int((t + t_next) / 2), truncated toward zero (0 for t=0, t_next=-1), as
    upstream casts its labels."""
    if sched.alphas is None:
        raise ValueError("fpndm_sampler needs a DDPM-family schedule")
    if not subsample_steps:
        raise ValueError("fpndm_sampler needs subsample_steps")
    T = sched.T
    alphas_old = np.ascontiguousarray(sched.alphas[::-1]).astype(np.float32)
    skip = T // subsample_steps
    steps = list(range(0, T, skip))
    steps_next = [-1] + steps[:-1]

    def at_of(t):
        return alphas_old[t + 1]

    B = x_init.shape[0]

    def model(x, t):
        return eps_fn(x, torch.full((B,), t, dtype=torch.long, device=x.device)).to(x.dtype)

    x = x_init
    traj, ets = [], []
    for i, (t, t_next) in enumerate(zip(steps, steps_next)):
        if i < 3:   # Runge-Kutta (upstream models/pndm.py:3-17)
            t_mid = int((t + t_next) / 2)
            e_1 = model(x, t)
            ets.append(e_1)
            x_2 = _pndm_transfer(x, at_of(t), at_of(t_mid), e_1, clip_before)
            e_2 = model(x_2, t_mid)
            x_3 = _pndm_transfer(x, at_of(t), at_of(t_mid), e_2, clip_before)
            e_3 = model(x_3, t_mid)
            x_4 = _pndm_transfer(x, at_of(t), at_of(t_next), e_3, clip_before)
            e_4 = model(x_4, t_next)
            noise = (1.0 / 6) * (e_1 + 2 * e_2 + 2 * e_3 + e_4)
        else:       # Adams-Bashforth (upstream models/pndm.py:47)
            e = model(x, t)
            noise = (1.0 / 24) * (55.0 * e - 59.0 * ets[-1] + 37.0 * ets[-2] - 9.0 * ets[-3])
            ets = ets[-2:] + [e]
        x = _pndm_transfer(x, at_of(t), at_of(t_next), noise, clip_before)
        if not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)


def check_n_steps_each(n_steps_each: int) -> int:
    """The Langevin samplers need at least one inner step a noise level; the
    DDPM-family ymls carry `sampling.n_steps_each: 0`, a dead knob there,
    which would otherwise fail deep inside a reshape."""
    if int(n_steps_each) < 1:
        raise ValueError(
            f"sampling.n_steps_each={n_steps_each}: SMLD/Langevin samplers "
            "need at least 1 inner step per noise level (DDPM-schema "
            "configs set it to 0 — set sampling.n_steps_each and "
            "sampling.step_lr for Langevin sampling)")
    return int(n_steps_each)


def _step_draws(step_noise, n: int, shape, what: str):
    """`step_noise` as n per-step draws: (levels, n_steps_each, *shape) or
    (n, *shape); None stays None."""
    if step_noise is None:
        return None
    draws = step_noise.reshape(-1, *shape)
    if len(draws) < n:
        raise ValueError(f"{what}: step_noise holds {len(draws)} draws, {n} steps need {n}")
    return draws


def anneal_langevin_dynamics(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sched: DiffusionSchedule,
    *,
    n_steps_each: int = 200,
    step_lr: float = 0.000008,
    final_only: bool = True,
    denoise: bool = True,
    harm_mean: bool = False,
    frac_steps: Optional[float] = None,
    same_noise: bool = False,
    noise_val: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[torch.Tensor] = None,
    **_: object,
) -> torch.Tensor:
    """SMLD annealed Langevin dynamics (upstream models/__init__.py:343-410).
    The network gives z, the score is -z/sigma, so at level c (label c, of
    the ladder cut by `frac_steps`) each of the n_steps_each steps is
        x = x - step/sigma * eps(x, c) + sqrt(2 step) * noise,
        step = step_lr * (sigma / sigma_L)^2
    (eps * hm / sigma with `harm_mean`, hm the ladder's harmonic mean);
    `denoise` then subtracts sigma_L * eps(x, L-1). Draws: `same_noise`
    reuses `noise_val` (x_init when None) at every step; else `step_noise`,
    (L, n_steps_each, *x.shape) or (L * n_steps_each, *x.shape), or draws
    from `generator`. The coefficients are the JAX sampler's fp32 scalars.
    Returns x[None] if final_only, else the trajectory (L*n[+1], *x.shape)."""
    n_steps_each = check_n_steps_each(n_steps_each)
    if sched.sigmas is None:
        raise ValueError("anneal_langevin_dynamics needs an SMLD schedule")
    f32 = np.float32
    raw = sched.sigmas
    if frac_steps is not None:
        raw = raw[int((1 - frac_steps) * len(raw)):]
    sigmas = np.asarray(raw, f32)
    L = len(sigmas)
    sigma_L = sigmas[-1]
    hm = float(len(raw) / np.sum(1.0 / raw)) if harm_mean else None
    if same_noise and noise_val is None:
        noise_val = x_init
    draws = None if same_noise else _step_draws(step_noise, L * n_steps_each, x_init.shape,
                                                "anneal_langevin_dynamics")
    B = x_init.shape[0]
    x = x_init
    traj = []
    for c in range(L):
        sigma = sigmas[c]
        step = f32(step_lr) * (sigma / sigma_L) ** 2
        c_grad, c_noise = float(step / sigma), float(np.sqrt(step * f32(2.0)))
        labels = torch.full((B,), c, dtype=torch.long, device=x.device)
        for j in range(n_steps_each):
            grad = eps_fn(x, labels).to(x.dtype)
            if harm_mean:
                grad = grad * hm / float(sigma)
            if same_noise:
                noise = noise_val
            elif draws is not None:
                noise = draws[c * n_steps_each + j]
            else:
                noise = _draw(generator, x)
            x = x - c_grad * grad + c_noise * noise
            if not final_only:
                traj.append(x)
    if denoise:
        labels = torch.full((B,), L - 1, dtype=torch.long, device=x.device)
        x = x - float(sigma_L) * eps_fn(x, labels).to(x.dtype)
        if not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)


def consistent_ladder(sched: DiffusionSchedule, n_steps_each: int, step_lr: float):
    """The consistent samplers' tables (upstream models/__init__.py:486-520):
    the geomspace ladder from sigma_1 to sigma_L in (L-1)*n + 1 fp32 steps,
    each step's next sigma (the last repeated), the noise scale beta =
    sqrt(1 - (gamma (1 - eta))^2), gamma = sigma / sigma_next, and eta =
    step_lr / sigma_L^2. step_lr must lie strictly within sigma_L^2 (1 -+
    sigma_T / sigma_{T-1}) (asserted, as upstream does)."""
    sigmas = sched.sigmas
    L = len(sigmas)
    sigma_begin, sigma_end = float(sigmas[0]), float(sigmas[-1])
    ladder = np.geomspace(sigma_begin, sigma_end, (L - 1) * n_steps_each + 1).astype(
        np.float32)
    smallest_invgamma = ladder[-1] / ladder[-2]
    lower = sigma_end ** 2 * (1 - smallest_invgamma)
    higher = sigma_end ** 2 * (1 + smallest_invgamma)
    assert lower < step_lr < higher, f"Could not satisfy {lower} < {step_lr} < {higher}"
    eta = step_lr / (sigma_end ** 2)
    nxt = np.concatenate([ladder[1:], ladder[-1:]])
    beta = np.sqrt(np.maximum(0.0, 1.0 - (ladder / nxt * (1.0 - eta)) ** 2))
    return ladder, nxt, beta.astype(np.float32), eta


def anneal_langevin_dynamics_consistent(
    x_init: torch.Tensor,
    eps_fn_sigma: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: DiffusionSchedule,
    *,
    n_steps_each: int = 200,
    step_lr: float = 0.000008,
    final_only: bool = True,
    denoise: bool = True,
    eps_fn_label: Optional[EpsFn] = None,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[torch.Tensor] = None,
    **_: object,
) -> torch.Tensor:
    """Consistent annealed sampling (upstream models/__init__.py:486-579) on
    `consistent_ladder`: at each sigma of the ladder
        x = x - eta sigma eps(x, sigma), then + beta sigma_next noise
    (no noise at the last). `eps_fn_sigma(x, sigmas)` takes the raw
    per-example sigma values; the final denoise subtracts sigma_L eps by
    `eps_fn_label(x, L-1)` where given, else by sigma. Draws: `step_noise`
    (T, *x.shape) or (T-1, ...), T the ladder's length (entry T-1 is never
    read), or from `generator`."""
    n_steps_each = check_n_steps_each(n_steps_each)
    if sched.sigmas is None:
        raise ValueError("anneal_langevin_dynamics_consistent needs an SMLD schedule")
    ladder, nxt, beta, eta = consistent_ladder(sched, n_steps_each, step_lr)
    T = len(ladder)
    draws = _step_draws(step_noise, T - 1, x_init.shape, "anneal_langevin_dynamics_consistent")
    f32 = np.float32
    B = x_init.shape[0]
    x = x_init
    traj = []
    for i in range(T):
        used = torch.full((B,), float(ladder[i]), dtype=x.dtype, device=x.device)
        grad = eps_fn_sigma(x, used).to(x.dtype)
        x = x - float(f32(eta) * ladder[i]) * grad
        if i < T - 1:
            noise = draws[i] if draws is not None else _draw(generator, x)
            x = x + float(beta[i] * nxt[i]) * noise
        if not final_only:
            traj.append(x)
    if denoise:
        sigma_L = float(f32(sched.sigmas[-1]))
        if eps_fn_label is not None:
            labels = torch.full((B,), len(sched.sigmas) - 1, dtype=torch.long,
                                device=x.device)
            x = x - sigma_L * eps_fn_label(x, labels).to(x.dtype)
        else:
            used = torch.full((B,), float(ladder[-1]), dtype=x.dtype, device=x.device)
            x = x - sigma_L * eps_fn_sigma(x, used).to(x.dtype)
        if not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)


SAMPLERS = {"DDPM": ddpm_sampler, "DDIM": ddim_sampler, "FPNDM": fpndm_sampler,
            "SMLD": anneal_langevin_dynamics}


def get_sampler(version: str):
    """Sampler for `model.version`: DDPM, DDIM, FPNDM, or SMLD (annealed
    Langevin dynamics)."""
    return SAMPLERS[version.upper()]
