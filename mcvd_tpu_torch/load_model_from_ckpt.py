"""Library loaders (counterpart of the repository's `load_model_from_ckpt.py`;
upstream load_model_from_ckpt.py:39-112).

`load_model(ckpt_path)` reads the `config.yml` beside the checkpoint and
returns (model, params, config, sched) on the card unless device="cpu".
Two checkpoint forms are read:
  * the port's own (`train/checkpoints.py`: `EXP/logs/checkpoint[_N]`);
  * upstream `.pt` files as they are: a list [state_dict, optimizer, epoch,
    step, ema_shadow], the `module.` prefix stripped, the EMA shadow over
    the state dict when model.ema is set (as upstream evaluates).
`params` are the weights evaluation uses (the EMA where model.ema is set),
also loaded into the model, as a state dict for `get_sampler`. The JAX
package's Orbax checkpoints come in through their export: on a host with
jax and orbax, `tools/export_jax_checkpoint.py` writes one `.npz`; on any
host, `python -m mcvd_tpu_torch.compat.jax_ckpt OUT.npz EXP/logs` turns it
into the port's own checkpoints, which this reads.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch

from .compat import yaml_subset
from .config import dict2namespace
from .data.transforms import inverse_data_transform
from .device import DEFAULT_DEVICE, resolve_device
from .diffusion import make_schedule
from .eval.video_gen import init_noise, make_block_sampler
from .models import get_model


def _strip_module_prefix(sd: Mapping) -> Dict:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def upstream_state_dict(ckpt_path: str, use_ema: bool) -> Dict[str, torch.Tensor]:
    """The weights of an upstream `.pt` checkpoint ([sd, optim, epoch, step,
    ema]): the EMA shadow's entries over the state dict's when `use_ema`
    (upstream ncsn_runner.py: ema_helper.ema(scorenet) before evaluation)."""
    states = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if not isinstance(states, (list, tuple)) or not isinstance(states[0], Mapping):
        raise ValueError(f"{ckpt_path}: not an upstream checkpoint list "
                         f"[state_dict, optimizer, epoch, step, ema]")
    sd = _strip_module_prefix(states[0])
    if use_ema and len(states) >= 5 and isinstance(states[-1], Mapping):
        sd = {**sd, **_strip_module_prefix(states[-1])}
    return sd


def _load_into(model: torch.nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> None:
    """Every parameter of `model` from `sd`; buffers (schedule tables) may
    stay as the model made them, keys the model lacks are ignored."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(sd))
    if missing:
        raise KeyError(f"{what}: no weights for {missing[:8]} ({len(missing)} missing)")
    with torch.no_grad():
        for k, p in params.items():
            v = sd[k]
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{what}: {k} has shape {tuple(v.shape)}, the model "
                                 f"{tuple(p.shape)}")
            p.copy_(v)


def load_model(ckpt_path: str, device=DEFAULT_DEVICE):
    """(model, params, config, sched) of a checkpoint; `config.yml` is read
    from the checkpoint's directory."""
    from .train import checkpoints, create_train_state

    device = resolve_device(device, "load_model")
    ckpt_dir, name = os.path.split(os.path.abspath(ckpt_path.rstrip("/")))
    config = dict2namespace(yaml_subset.load_file(os.path.join(ckpt_dir, "config.yml")))
    model = get_model(config, device=device)
    sched = make_schedule(config)
    use_ema = getattr(config.model, "ema", False)
    if name.endswith(".pt"):
        sd = upstream_state_dict(ckpt_path, use_ema)
    else:
        state = checkpoints.load_checkpoint(
            ckpt_dir, name=name, target=create_train_state(config, model, device=device))
        sd = state.ema_params if use_ema else state.params
    _load_into(model, sd, ckpt_path)
    model.eval()
    params = {k: p.detach() for k, p in model.named_parameters()}
    return model, params, config, sched


def get_sampler(config, model, params, sched):
    """sample(init, cond=None, cond_mask=None, *, generator=None) -> the
    block's frames in [0, 1], folded (B, H, W, F*C) (upstream
    load_model_from_ckpt.py:79-97)."""
    block = make_block_sampler(config, model, sched)

    def sample(init, cond=None, cond_mask=None, *, generator: Optional[torch.Generator] = None):
        return inverse_data_transform(config, block(params, init, cond, cond_mask,
                                                    generator=generator))

    return sample


def init_samples(config, *, generator: torch.Generator, device=DEFAULT_DEVICE):
    """The initial reverse-diffusion state of sampling.batch_size videos
    (upstream load_model_from_ckpt.py:99-112)."""
    B = getattr(config.sampling, "batch_size", 1)
    sz, C = config.data.image_size, config.data.channels
    return init_noise(config, make_schedule(config), (B, sz, sz, config.data.num_frames * C),
                      generator=generator, device=device)
