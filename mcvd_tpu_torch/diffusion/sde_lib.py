"""The continuous-time SDEs of score SDE, VP, sub-VP and VE (counterpart of
`mcvd_tpu/diffusion/sde_lib.py`), on tensors.

Upstream's score-SDE registry imports an `sde_lib` it never shipped; the JAX
package wrote one, and this is its copy. Conventions are the JAX module's:
t runs over [0, T], T = 1, t = 0 is the data and t = T the prior (the
opposite of the discrete schedules' index 0 = most noised; `registry.
get_score_fn` maps between them); the discrete tables are fp32 numpy, VE's
`discrete_sigmas` small to large. t is a (B,) tensor; methods broadcast it
over x's trailing axes.
"""

from __future__ import annotations

import abc
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) against x."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def _timestep(sde: "SDE", t: torch.Tensor) -> torch.Tensor:
    """The discrete index of t, truncated toward zero as an int32 cast."""
    return (t / sde.T * (sde.N - 1)).to(torch.int64)


class SDE(abc.ABC):
    """Forward SDE dx = f(x, t) dt + g(t) dw on t in [0, T]."""

    def __init__(self, N: int):
        self.N = int(N)

    @property
    def T(self) -> float:
        return 1.0

    @abc.abstractmethod
    def sde(self, x, t):
        """Drift f(x, t) and diffusion g(t)."""

    @abc.abstractmethod
    def marginal_prob(self, x, t):
        """Mean and std of p_t(x(t) | x(0))."""

    def prior_sampling(self, shape, *, generator: Optional[torch.Generator] = None,
                       device=DEFAULT_DEVICE) -> torch.Tensor:
        """A draw from the prior p_T on `device` (the card unless "cpu")."""
        device = resolve_device(device, "prior_sampling")
        return torch.randn(shape, generator=generator, device=device) * self._prior_std

    _prior_std = 1.0

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """Log-density of the prior, per example."""
        return _batch_logp_normal(z, 2.0 * math.log(self._prior_std))

    def discretize(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Euler-Maruyama: x_{i+1} = x_i + f_i + G_i z, f = f(x, t) dt, G =
        g(t) sqrt(dt), dt = 1/N."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)


def _batch_logp_normal(z: torch.Tensor, log_sigma2: float) -> torch.Tensor:
    ndim = int(np.prod(z.shape[1:]))
    axes = tuple(range(1, z.ndim))
    return -0.5 * (ndim * (math.log(2 * math.pi) + log_sigma2)
                   + (z ** 2).sum(dim=axes) / math.exp(log_sigma2))


class VPSDE(SDE):
    """Variance-preserving SDE (continuous DDPM), with its discrete DDPM
    tables for ancestral sampling."""

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0, N: int = 1000):
        super().__init__(N)
        self.beta_0 = float(beta_min)
        self.beta_1 = float(beta_max)
        self.discrete_betas = np.linspace(beta_min / N, beta_max / N, N,
                                          dtype=np.float64).astype(np.float32)
        self.alphas = (1.0 - self.discrete_betas).astype(np.float32)
        self.alphas_cumprod = np.cumprod(self.alphas, dtype=np.float64).astype(np.float32)
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_1m_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t)

    def _log_mean_coeff(self, t):
        return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def marginal_prob(self, x, t):
        lmc = self._log_mean_coeff(t)
        return _bcast(torch.exp(lmc), x) * x, torch.sqrt(1.0 - torch.exp(2.0 * lmc))

    def discretize(self, x, t):
        """The exact DDPM step: f = (sqrt(1 - beta_i) - 1) x, G = sqrt(beta_i)."""
        i = _timestep(self, t)
        beta = _table(self.discrete_betas, x)[i]
        sqrt_alpha = torch.sqrt(_table(self.alphas, x))[i]
        return _bcast(sqrt_alpha, x) * x - x, torch.sqrt(beta)


class subVPSDE(SDE):
    """Sub-VP SDE: VP's mean, a strictly smaller variance."""

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0, N: int = 1000):
        super().__init__(N)
        self.beta_0 = float(beta_min)
        self.beta_1 = float(beta_max)

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        total = 1.0 - torch.exp(-2.0 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t ** 2)
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t * total)

    def marginal_prob(self, x, t):
        lmc = -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        return _bcast(torch.exp(lmc), x) * x, 1.0 - torch.exp(2.0 * lmc)


class VESDE(SDE):
    """Variance-exploding SDE (continuous SMLD)."""

    def __init__(self, sigma_min: float = 0.01, sigma_max: float = 50.0, N: int = 1000):
        super().__init__(N)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self._prior_std = self.sigma_max
        self.discrete_sigmas = np.exp(np.linspace(np.log(sigma_min), np.log(sigma_max),
                                                  N)).astype(np.float32)

    def _sigma(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def sde(self, x, t):
        diffusion = self._sigma(t) * math.sqrt(
            2.0 * (np.log(self.sigma_max) - np.log(self.sigma_min)))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self._sigma(t)

    def discretize(self, x, t):
        """SMLD's ancestral step: f = 0, G = sqrt(sigma_i^2 - sigma_{i-1}^2)
        (sigma_{-1} = 0)."""
        i = _timestep(self, t)
        sigmas = _table(self.discrete_sigmas, x)
        sigma = sigmas[i]
        adjacent = torch.where(i == 0, torch.zeros_like(sigma), sigmas[(i - 1).clamp(min=0)])
        return torch.zeros_like(x), torch.sqrt(sigma ** 2 - adjacent ** 2)
