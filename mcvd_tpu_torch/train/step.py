"""The train step: transform -> conditioning -> DSM loss -> grads ->
clip + optimizer -> EMA (counterpart of `mcvd_tpu/train/step.py`; upstream
ncsn_runner.py:371-418).

PyTorch runs it eagerly on the device of the state it is given; nothing
moves to the CPU on its own (the metrics stay 0-dim device tensors). The
score network's GroupNorm and attention run through the port's kernels,
forward and backward, on the card.

Every draw can be given explicitly in `draws` (the tests replay the JAX
package's): "deq_uniform" / "deq_normal" (X's shape), "cond" / "future"
(the (B,) uniforms of the keep masks), "labels" (B,), "z" (the target's
NCHW shape; with gamma noise the Gamma draw, see `dsm_loss`) and, with
`model.noise_in_cond`, "cond_noise" (cond's NCHW shape, see
`models.UNetMoreDDPM`). What is not given comes from `generator` (on the
state's device), in that order, and the resblocks' dropout masks after it.

`training.compute_dtype: bfloat16` runs the score network, forward and
backward, in bf16: a bf16 cast of the fp32 master parameters inside the loss
(`torch.func.functional_call` on the cast tensors, so the gradients flow back
through the cast into fp32), x_t and cond cast to bf16, the output cast back
to fp32; the DSM chain math and the optimizer stay fp32. The eval loss is
always fp32, with dropout off.

In a process group (`parallel.dist`, P ranks) each rank runs the step on
its own rows of the global batch: the draws made from `generator` are the
global batch's, cut to the rank's rows (`parallel.draws.RowDraws`; explicit
`draws` are the caller's rows), and the gradients and the loss are averaged
over the ranks (`parallel.all_reduce_mean_`, flat fp32 buckets) before the
clip, so the clip, the optimizer and the EMA see the global batch's
gradient, every rank receives the same bits and the ranks' parameters stay
equal. The DSM loss is a mean over the batch, so on equal local batches the
mean of the ranks' gradients is the global batch's. Without a group
nothing of this runs.

The JAX package's `make_train_chunk` (K steps in one `lax.scan` dispatch,
`training.steps_per_dispatch`) works around the TPU's per-dispatch cost and
is not ported: here each step is one Python call.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
from torch.func import functional_call

from .. import tracing
from ..data.conditioning import conditioning_fn
from ..data.transforms import data_transform
from ..diffusion.loss import dsm_loss
from ..diffusion.schedules import DiffusionSchedule
from ..models.ema import ema_update
from ..models.ncsnpp import draw_cond_noise
from ..parallel import all_reduce_mean_, row_draws
from .state import TrainState, make_optimizer

_BF16 = ("bfloat16", "bf16")


def loss_for_batch(model: torch.nn.Module, sched: DiffusionSchedule, config,
                   params: Mapping[str, torch.Tensor], X: torch.Tensor, *, train: bool,
                   draws: Optional[Mapping[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The DSM loss of `model` with `params` on the clip X (B, T, H, W, C) in
    [0, 1] (uint8 holds round(x*255)); a 0-dim fp32 tensor. `train` turns
    dropout and the bf16 compute dtype on."""
    draws = draws or {}
    device = next(iter(params.values())).device
    X = X.to(device)
    X = X.float() / 255.0 if X.dtype == torch.uint8 else X.float()
    X = data_transform(config, X, uniform=draws.get("deq_uniform"),
                       normal=draws.get("deq_normal"), generator=generator)
    pred, cond, cond_mask = conditioning_fn(
        config, X, num_frames_pred=config.data.num_frames,
        prob_mask_cond=getattr(config.data, "prob_mask_cond", 0.0),
        prob_mask_future=getattr(config.data, "prob_mask_future", 0.0),
        conditional=config.data.num_frames_cond > 0, mask_draws=draws, generator=generator)

    bf16 = train and getattr(config.training, "compute_dtype", "float32") in _BF16
    call_params = ({k: p.to(torch.bfloat16) for k, p in params.items()} if bf16
                   else params)
    model.train(train)
    noisy_cond = getattr(config.model, "noise_in_cond", False)

    def model_fn(x_t, labels, c, m):
        kw = {"dropout_generator": generator}
        if noisy_cond and c is not None:
            kw["cond_noise"] = draws.get("cond_noise")
            if kw["cond_noise"] is None:
                kw["cond_noise"] = draw_cond_noise(config, sched, labels, c, generator)
        if bf16:
            x_t = x_t.to(torch.bfloat16)
            c = None if c is None else c.to(torch.bfloat16)
        out = functional_call(model, call_params, (x_t, labels, c, m), kw)
        return out.float() if bf16 else out

    return dsm_loss(model_fn, pred, sched, labels=draws.get("labels"), z=draws.get("z"),
                    cond=cond, cond_mask=cond_mask,
                    gamma=getattr(config.model, "gamma", False),
                    L1=getattr(config.training, "L1", False),
                    all_frames=getattr(config.model, "output_all_frames", False),
                    generator=generator)


def make_train_step(model: torch.nn.Module, sched: DiffusionSchedule, config) -> Callable:
    """step(state, X, *, draws=None, generator=None) -> (state, metrics): one
    SGD step on `state` in place (parameters, optimizer slots, EMA, step
    count); metrics {"loss", "grad_norm"} (the global norm of the raw
    gradients) as 0-dim device tensors. In a process group X is the rank's
    rows and the metrics are the global batch's."""
    opt = make_optimizer(config)
    ema_rate = getattr(config.model, "ema_rate", 0.999)
    use_ema = getattr(config.model, "ema", False)

    def step(state: TrainState, X: torch.Tensor, *,
             draws: Optional[Mapping[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None):
        with tracing.span("train.step"):
            params = state.params
            with tracing.span("train.forward"):
                loss = loss_for_batch(model, sched, config, params, X, train=True,
                                      draws=draws, generator=row_draws(generator))
            with tracing.span("train.backward"):
                grads = torch.autograd.grad(loss, list(params.values()),
                                            materialize_grads=True)
            # the loss rides in the last bucket of the gradients' mean
            *grads, loss = all_reduce_mean_([*grads, loss.detach().reshape(1)])
            loss = loss.reshape(())
            with tracing.span("train.optimizer"):
                grad_norm = opt.update(params, dict(zip(params, grads)), state.opt_state)
            if use_ema:
                with tracing.span("train.ema"):
                    ema_update(state.ema_params, params, ema_rate)
            state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step


def make_eval_loss_step(model: torch.nn.Module, sched: DiffusionSchedule,
                        config) -> Callable:
    """eval_step(params, X, *, draws=None, generator=None) -> loss: the
    validation DSM loss (upstream ncsn_runner.py:453-479), fp32, dropout off,
    under `torch.inference_mode()`; params are usually the EMA. In a process
    group X is the rank's rows and the loss the global batch's mean."""

    def eval_step(params: Mapping[str, torch.Tensor], X: torch.Tensor, *,
                  draws: Optional[Mapping[str, torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.inference_mode():
            loss = loss_for_batch(model, sched, config, params, X, train=False,
                                  draws=draws, generator=row_draws(generator))
            return all_reduce_mean_([loss.reshape(1)])[0].reshape(())

    return eval_step
