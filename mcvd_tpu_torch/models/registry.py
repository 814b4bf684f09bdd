"""The score-SDE model registry and score-function wrappers (counterpart of
`mcvd_tpu/models/registry.py`; upstream models/better/utils.py:1-187, dead
upstream because its `sde_lib` was never shipped), on `diffusion.sde_lib`.

As in the JAX module: `create_model` returns the module (no DataParallel),
`get_model_fn` takes the weights explicitly (a state dict, through
`torch.func.functional_call`; None uses the module's own), and the score
wrapper flips SDE time onto the repo's ladder (index 0 = most noised).
Tensors are the port's (B, C, H, W), or any (B, ...) the model takes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..diffusion import sde_lib

_MODELS: Dict[str, Any] = {}


def register_model(cls=None, *, name: Optional[str] = None):
    """Class decorator registering a score model under its name (or `name`)."""

    def _register(cls):
        local_name = cls.__name__ if name is None else name
        if local_name in _MODELS:
            raise ValueError(f"Already registered model with name: {local_name}")
        _MODELS[local_name] = cls
        return cls

    if cls is None:
        return _register
    return _register(cls)


def get_model(name: str):
    """The registered model class `name`."""
    return _MODELS[name]


def get_sigmas(config) -> np.ndarray:
    """The geometric SMLD ladder, large to small, from the score-SDE fields
    `model.sigma_max`, `sigma_min`, `num_scales` (float64)."""
    return np.exp(np.linspace(np.log(config.model.sigma_max), np.log(config.model.sigma_min),
                              config.model.num_scales)).astype(np.float64)


def get_ddpm_params(config) -> Dict[str, Any]:
    """The original DDPM's beta and alpha tables at 1000 steps (float64)."""
    num_diffusion_timesteps = 1000
    beta_start = config.model.beta_min / config.model.num_scales
    beta_end = config.model.beta_max / config.model.num_scales
    betas = np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    return {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "beta_min": beta_start * (num_diffusion_timesteps - 1),
        "beta_max": beta_end * (num_diffusion_timesteps - 1),
        "num_diffusion_timesteps": num_diffusion_timesteps,
    }


def create_model(config) -> torch.nn.Module:
    """The registered model named by `model.name`, else `model.arch`, built
    on `config` (construction draws nothing: `layers.init_weights` does)."""
    model_name = getattr(config.model, "name", None) or config.model.arch
    return get_model(model_name)(config)


def get_model_fn(model: torch.nn.Module, params: Optional[Mapping[str, torch.Tensor]] = None,
                 train: bool = False,
                 generator: Optional[torch.Generator] = None) -> Callable:
    """(x, labels) -> the model's output on `params` (its own weights when
    None), in train mode when `train` (dropout drawn from `generator`)."""

    def model_fn(x, labels):
        model.train(train)
        kw = {"dropout_generator": generator} if train and generator is not None else {}
        if params is None:
            return model(x, labels, **kw)
        return functional_call(model, dict(params), (x, labels), kw)

    return model_fn


def get_score_fn(sde, model: torch.nn.Module, params=None, train: bool = False,
                 continuous: bool = False, generator: Optional[torch.Generator] = None
                 ) -> Callable:
    """score_fn(x, t): the model's output as the score at SDE time t in [0,
    T] (t = 0 is the data). VP / sub-VP: labels (T - t) / T * 999
    (continuous, and always for sub-VP) or (N-1) - the table index of t, and
    the score -out / std(t); VE: labels sigma(t) (continuous) or round((T -
    t)(N-1)), and the output is the score as it is."""
    model_fn = get_model_fn(model, params, train=train, generator=generator)

    if isinstance(sde, (sde_lib.VPSDE, sde_lib.subVPSDE)):

        def score_fn(x, t):
            if continuous or isinstance(sde, sde_lib.subVPSDE):
                labels = (sde.T - t) / sde.T * 999
                score = model_fn(x, labels)
                std = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                # the sde tables keep score SDE's order (index 0 = data)
                sde_idx = (t * (sde.N - 1)).to(torch.int64)
                labels = (sde.N - 1) - sde_idx
                score = model_fn(x, labels)
                std = torch.as_tensor(sde.sqrt_1m_alphas_cumprod, device=x.device)[sde_idx]
            return -score / sde_lib._bcast(std, x)

    elif isinstance(sde, sde_lib.VESDE):

        def score_fn(x, t):
            if continuous:
                labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = torch.round((sde.T - t) * (sde.N - 1)).to(torch.int64)
            return model_fn(x, labels)

    else:
        raise NotImplementedError(f"SDE class {sde.__class__.__name__} not yet supported.")
    return score_fn


def to_flattened_numpy(x: torch.Tensor) -> np.ndarray:
    """x as a 1-D numpy array (on the host)."""
    return x.detach().cpu().numpy().reshape((-1,))


def from_flattened_numpy(x: np.ndarray, shape) -> torch.Tensor:
    """The inverse of `to_flattened_numpy`, a CPU tensor."""
    return torch.from_numpy(np.asarray(x).reshape(shape))


def _register_builtin_models():
    """The NCSN++ family under its `arch` names, as the JAX registry holds it."""
    from .ncsnpp import UNetMoreDDPM

    for arch in ("unetmore", "unetmore3d", "unetmorepseudo3d"):
        _MODELS.setdefault(arch, UNetMoreDDPM)


_register_builtin_models()
