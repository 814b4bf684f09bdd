"""Autoregressive blockwise video prediction (counterpart of
`mcvd_tpu/eval/video_gen.py`: `make_block_sampler`, `init_noise`,
`slide_cond_window`, `autoregressive_predict`).

The public functions take and return the JAX package's layout: folded
(B, H, W, F*C), frame-major. Its NCHW view (`permute(0, 3, 1, 2)`) is a
channels_last tensor with no copy, which is what the network takes.

Random draws come either explicitly (the tests replay the JAX draws) or from
a `torch.Generator`. The metric harness (`run_video_gen`) waits for ROADMAP
Queue 1 item 11.
"""

from __future__ import annotations

import copy
from math import ceil
from typing import Optional, Sequence

import torch
from torch.func import functional_call

from ..data.transforms import data_transform
from ..device import DEFAULT_DEVICE, resolve_device
from ..diffusion import samplers as samplers_mod
from ..diffusion.schedules import DiffusionSchedule

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def make_block_sampler(config, model: torch.nn.Module, sched: DiffusionSchedule):
    """One reverse-diffusion block: block(params, init, cond, cond_mask=None,
    *, generator=None, inj_noise=None, step_noise=None) -> (B, H, W, F*C),
    the JAX sampler's `block(params, key, init, cond, cond_mask)` less the
    key.

    `params` is a state dict (name -> tensor) of `model`, for example
    `dict(model.named_parameters())` or `model.state_dict()`, taken at each
    call: the network runs through `torch.func.functional_call` on a copy of
    `model` that the sampler holds in eval mode (dropout off) under
    torch.inference_mode(), so one sampler serves every snapshot of the
    weights and neither building nor calling it touches `model` or its
    `training` flag. Names missing from `params` (the schedule buffers, say)
    come from that copy.

    `sampling.compute_dtype: bfloat16` runs the score network in bf16 (its
    weights, the input, cond and the timestep embedding) while the chain
    math (x0 clip, posterior mean, noise add) stays fp32. The weights are
    cast at each call; a cast is reused while its source is the same tensor
    object at the same `_version`, so an in-place update of a weight (an
    optimizer step) is seen at the next call. The ensemble mode is not
    ported yet (ROADMAP Queue 1 item 5)."""
    version = getattr(config.model, "version", "DDPM").upper()
    sampler = samplers_mod.get_sampler(version)
    sampling = config.sampling
    kwargs = dict(
        final_only=True,
        denoise=getattr(sampling, "denoise", True),
        subsample_steps=getattr(sampling, "subsample", None),
        clip_before=getattr(sampling, "clip_before", True),
        t_min=getattr(sampling, "init_prev_t", -1),
        gamma=getattr(config.model, "gamma", False),
    )
    comp_dtype = _DTYPES[getattr(sampling, "compute_dtype", "float32")]
    net = copy.deepcopy(model).to(comp_dtype).eval()
    casts = {}   # name -> (source tensor, its _version, the cast)

    def cast(name, t):
        if not t.is_floating_point() or t.dtype == comp_dtype:
            return t
        hit = casts.get(name)
        if hit is None or hit[0] is not t or hit[1] != t._version:
            hit = casts[name] = (t, t._version, t.detach().to(comp_dtype))
        return hit[2]

    def block(params, init, cond, cond_mask=None, *, generator=None, inj_noise=None,
              step_noise=None):
        with torch.inference_mode():
            weights = {k: cast(k, v) for k, v in params.items()}
            cond_c = None if cond is None else cond.permute(0, 3, 1, 2).to(comp_dtype)

            def eps_fn(x, labels):
                out = functional_call(net, weights, (x.permute(0, 3, 1, 2).to(comp_dtype),
                                                     labels, cond_c, cond_mask))
                return out.permute(0, 2, 3, 1)

            return sampler(init, eps_fn, sched, generator=generator,
                           inj_noise=inj_noise, step_noise=step_noise, **kwargs)[-1]

    return block


def init_noise(config, sched: DiffusionSchedule, shape, *,
               generator: torch.Generator, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Initial reverse-diffusion state on `device` (the card unless
    `device="cpu"`; raises without CUDA): N(0, 1) for the DDPM family,
    data_transform(U[0, 1)) for SMLD. `generator` lives on that device."""
    device = resolve_device(device, "init_noise")
    version = getattr(config.model, "version", "DDPM").upper()
    if version == "SMLD":
        return data_transform(config, torch.rand(shape, generator=generator, device=device))
    if getattr(config.model, "gamma", False):
        raise NotImplementedError(
            "gamma noise: not ported yet (ROADMAP Queue 1 item 5: sampling options)")
    return torch.randn(shape, generator=generator, device=device)


def slide_cond_window(config, cond, gen, future: int, one_frame: bool):
    """Autoregressive cond update on folded (B, H, W, F*C) channel slices."""
    C = config.data.channels
    F = config.data.num_frames
    Fc = config.data.num_frames_cond
    if cond is None:
        return gen
    if future == 0:
        if one_frame:
            return torch.cat([cond[..., C:], gen[..., :C]], dim=-1)
        return torch.cat([cond[..., F * C:], gen[..., C * max(0, F - Fc):]], dim=-1)
    if one_frame:
        return torch.cat([cond[..., C: cond.shape[-1] - future * C], gen[..., :C],
                          cond[..., -future * C:]], dim=-1)
    return torch.cat([cond[..., F * C: cond.shape[-1] - future * C],
                      gen[..., C * max(0, F - Fc):], cond[..., -future * C:]], dim=-1)


def autoregressive_predict(config, block_sampler, params, cond, cond_mask,
                           num_frames_pred: int, future: int, sched: DiffusionSchedule,
                           *, generator: Optional[torch.Generator] = None,
                           draws: Optional[Sequence[dict]] = None,
                           unmask_after_first: bool = False):
    """Blockwise generation of num_frames_pred frames with the weights
    `params` (passed to each `block_sampler` call, see `make_block_sampler`);
    returns folded (B, H, W, num_frames_pred*C) in model (transformed) space.

    `draws[i]` may hold block i's explicit draws: "init" (its init noise),
    "inj_noise" and "step_noise" (see `ddpm_sampler`); what it lacks comes
    from `generator`. Init noise is re-drawn per block unless
    sampling.init_prev_t > 0, which warm-starts from the previous block."""
    C = config.data.channels
    F = config.data.num_frames
    sz = config.data.image_size
    B = cond.shape[0]
    one_frame = getattr(config.sampling, "one_frame_at_a_time", False)
    n_iter = num_frames_pred if one_frame else ceil(num_frames_pred / F)
    shape = (B, sz, sz, C * F)

    preds = []
    gen = None
    for i_frame in range(n_iter):
        d = draws[i_frame] if draws is not None else {}
        if i_frame == 0 or getattr(config.sampling, "init_prev_t", -1) <= 0:
            init = d.get("init")
            if init is None:
                init = init_noise(config, sched, shape, generator=generator,
                                  device=cond.device)
        else:
            init = gen
        gen = block_sampler(params, init, cond, cond_mask, generator=generator,
                            inj_noise=d.get("inj_noise"), step_noise=d.get("step_noise"))
        preds.append(gen)
        if i_frame == n_iter - 1:
            continue
        cond = slide_cond_window(config, cond, gen, future, one_frame)
        if unmask_after_first and i_frame == 0 and cond_mask is not None:
            cond_mask = torch.ones_like(cond_mask)
    return torch.cat(preds, dim=-1)[..., : C * num_frames_pred]
