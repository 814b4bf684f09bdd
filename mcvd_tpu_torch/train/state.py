"""Train state and optimizer (counterpart of `mcvd_tpu/train/state.py`;
upstream losses/__init__.py:4-23 and the checkpoint tuple
[model, optimizer, epoch, step, ema] of ncsn_runner.py:424-439).

`make_optimizer` mirrors the JAX package's optax chain update for update,
not `torch.optim`, whose rules differ:

  * clip by global norm first: the gradients stay as they are when the norm
    is below `grad_clip`, else each becomes (g / norm) * grad_clip, with no
    epsilon (optax `clip_by_global_norm`; `clip_grad_norm_` divides by
    norm + 1e-6);
  * Adam(beta1, 0.999, eps) as optax `scale_by_adam`; AdamW adds
    weight_decay * param to the Adam direction before the learning rate,
    as `optax.adamw`; amsgrad keeps the running max of the bias-corrected
    second moment and divides by its root (optax `scale_by_amsgrad`;
    `torch.optim.Adam(amsgrad=True)` takes the max of the raw moment);
    RMSProp(decay 0.9, eps 1e-8 inside the root); SGD with momentum 0.9;
  * the learning rate lr * min(count / warmup, 1) at the count of updates
    made before this one, so with warmup the first update uses lr 0.

The state's tensors live on the model's device; updates run in place under
`torch.no_grad()` with `torch._foreach_*` ops, a few launches for all the
parameters at once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..parallel import broadcast_, broadcast_from_primary

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """`params` are the model's own fp32 parameters (the train step updates
    them in place), `opt_state` the optimizer's slots, `ema_params` a copy
    of the parameters, `step` and `epoch` host counters."""
    params: Tensors
    opt_state: Dict[str, Any]
    ema_params: Tensors
    step: int = 0
    epoch: int = 0


def _zeros(params: Mapping[str, torch.Tensor]) -> Tensors:
    return {k: torch.zeros_like(p, memory_format=torch.preserve_format)
            for k, p in params.items()}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The optax chain of `mcvd_tpu.train.state.make_optimizer`, in torch."""
    name: str
    lr: float
    warmup: int = 0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    amsgrad: bool = False
    grad_clip: Optional[float] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """count: updates made so far; the moments of the chosen rule."""
        state: Dict[str, Any] = {"count": 0}
        if self.name == "Adam":
            state["mu"], state["nu"] = _zeros(params), _zeros(params)
            if self.amsgrad:
                state["nu_max"] = _zeros(params)
        elif self.name == "RMSProp":
            state["nu"] = _zeros(params)
        elif self.name == "SGD":
            state["trace"] = _zeros(params)
        return state

    def lr_at(self, count: int) -> float:
        """The learning rate of the update made after `count` updates, in
        fp32 as the JAX schedule computes it."""
        lr = np.float32(self.lr)
        if self.warmup and self.warmup > 0:
            lr = lr * np.minimum(np.float32(count) / np.float32(max(self.warmup, 1)),
                                 np.float32(1.0))
        return float(np.float32(lr))

    @torch.no_grad()
    def update(self, params: Tensors, grads: Mapping[str, torch.Tensor],
               state: Dict[str, Any]) -> torch.Tensor:
        """One update of `params` and `state`, in place. Returns the global
        norm of the raw gradients (a 0-dim tensor on their device)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        if self.grad_clip is not None and self.grad_clip > 0:
            # (g / norm) * clip where norm >= clip; g itself (divided and
            # multiplied by exactly 1) where it is below
            keep = norm < self.grad_clip
            one = torch.ones((), device=norm.device)
            g = torch._foreach_mul(torch._foreach_div(g, torch.where(keep, one, norm)),
                                   torch.where(keep, one, one * self.grad_clip))
        count = state["count"] + 1
        if self.name == "Adam":
            u = self._adam(g, state, names, count)
            if self.weight_decay and not self.amsgrad:
                torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        elif self.name == "RMSProp":
            nu = [state["nu"][k] for k in names]
            torch._foreach_mul_(nu, 0.9)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - 0.9))
            u = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, 1e-8)), g)
        elif self.name == "SGD":
            tr = [state["trace"][k] for k in names]
            torch._foreach_mul_(tr, 0.9)
            torch._foreach_add_(tr, g)
            u = tr
        else:
            raise NotImplementedError(f"Optimizer {self.name} not understood.")
        step = -1 * self.lr_at(state["count"])
        torch._foreach_add_(p, torch._foreach_mul(u, step))
        state["count"] = count
        return norm

    def _adam(self, g, state, names, count):
        b1, b2 = self.beta1, self.beta2
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        # bias corrections 1 - b**count in fp32, as optax's tree_bias_correction
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        if self.amsgrad:
            nu_max = [state["nu_max"][k] for k in names]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        return torch._foreach_div(mu_hat, den)


def make_optimizer(config) -> Optimizer:
    """Adam(beta1, 0.999, eps)[+amsgrad][AdamW when weight_decay > 0] /
    RMSProp / SGD(momentum 0.9) with linear warmup to optim.lr and
    global-norm clipping before it."""
    opt = config.optim
    name = getattr(opt, "optimizer", "Adam")
    if name not in ("Adam", "RMSProp", "SGD"):
        raise NotImplementedError(f"Optimizer {name} not understood.")
    return Optimizer(name=name, lr=float(opt.lr), warmup=getattr(opt, "warmup", 0) or 0,
                     beta1=getattr(opt, "beta1", 0.9), eps=getattr(opt, "eps", 1e-8),
                     weight_decay=getattr(opt, "weight_decay", 0.0) or 0.0,
                     amsgrad=bool(getattr(opt, "amsgrad", False)),
                     grad_clip=getattr(opt, "grad_clip", None))


def create_train_state(config, model: torch.nn.Module, *,
                       device=DEFAULT_DEVICE) -> TrainState:
    """Move `model` to `device` (the card unless `device="cpu"`; raises
    without CUDA) and build the optimizer state and the EMA, a real copy of
    the parameters. The model keeps its weights: draw them first
    (`models.get_model`)."""
    device = resolve_device(device, "create_train_state")
    model.to(device)
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=make_optimizer(config).init(params),
                      ema_params={k: p.detach().clone() for k, p in params.items()})


def broadcast_state_(state: TrainState) -> TrainState:
    """Rank 0's state in every rank's, in place: parameters, EMA, the
    optimizer's slots and counters (no-op without a process group)."""
    tensors = [t for d in (state.params, state.ema_params) for t in d.values()]
    tensors += [t for v in state.opt_state.values() if isinstance(v, dict) for t in v.values()]
    with torch.no_grad():
        broadcast_(tensors)
    state.step, state.epoch, state.opt_state["count"] = broadcast_from_primary(
        (state.step, state.epoch, state.opt_state["count"]), "train state")
    return state
