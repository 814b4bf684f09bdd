"""Plain DDPM sampling and training arithmetic of MCVD, frozen for the
benchmark's checks (voletiv/mcvd-pytorch models/__init__.py, losses/dsm.py,
losses/__init__.py, models/ema.py), in float32.

Layouts: a clip is (B, T, H, W, C) in [0, 1]; the chain's state and the
predicted frames are folded (B, H, W, F*C), frame-major; the network takes
NCHW (`.permute(0, 3, 1, 2)`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def schedule(cfg: dict) -> Dict[str, np.ndarray]:
    """Linear betas from sigma_begin to sigma_end; index 0 is the noisiest
    level: alphas = cumprod(1 - betas[::-1])[::-1], alphas_prev shifted by
    one with 1 appended (float32, as upstream computes them)."""
    m = cfg["model"]
    if m["sigma_dist"] != "linear":
        raise ValueError("the reference schedule is the linear one")
    betas = np.linspace(m["sigma_begin"], m["sigma_end"], m["num_classes"], dtype=np.float32)
    alphas = np.cumprod(1.0 - betas[::-1], dtype=np.float32)[::-1].copy()
    return {"betas": betas, "alphas": alphas,
            "alphas_prev": np.concatenate([alphas[1:], np.float32([1.0])])}


def sampler_tables(cfg: dict) -> Dict[str, np.ndarray]:
    """The DDPM chain's per-step labels and coefficients at `sampling.subsample`
    steps: every (T // subsample)-th level, betas re-derived as 1 - a / a_prev
    within the subsampled table."""
    a_full = schedule(cfg)["alphas"]
    T = len(a_full)
    n = cfg["sampling"]["subsample"]
    steps = np.arange(0, T, T // n) if n and n < T else np.arange(T)
    f = np.float32
    a = a_full[steps]
    ap = np.concatenate([a[1:], f([1.0])])
    b = f(1.0) - a / ap
    return {"labels": steps, "sq1ma": np.sqrt(f(1.0) - a), "sqa": np.sqrt(a),
            "c_x0": np.sqrt(ap) * b / (f(1.0) - a), "c_x": np.sqrt(f(1.0) - b) * (f(1.0) - ap)
            / (f(1.0) - a), "std": np.sqrt((f(1.0) - ap) / (f(1.0) - a) * b)}


def ddpm_block(eps_fn, x: torch.Tensor, cond: torch.Tensor, tables, step_noise,
               clip: bool = True, denoise: bool = True) -> torch.Tensor:
    """One reverse-diffusion block from init x (B, H, W, F*C) on cond (B, H, W,
    Fc*C): per step x0 = (x - sqrt(1 - a) eps) / sqrt(a), clipped to [-1, 1],
    x = c_x0 x0 + c_x x, plus std z except at the last step; then the denoise
    step x - sqrt(1 - a_L) eps at label L - 1 (upstream feeds the subsampled
    index there). `step_noise[i]` is step i's z."""
    t = tables
    L = len(t["labels"])
    B = x.shape[0]
    c = cond.permute(0, 3, 1, 2)
    for i in range(L):
        lab = torch.full((B,), int(t["labels"][i]), dtype=torch.long, device=x.device)
        eps = eps_fn(x.permute(0, 3, 1, 2), lab, c).permute(0, 2, 3, 1)
        x0 = (x - float(t["sq1ma"][i]) * eps) / float(t["sqa"][i])
        if clip:
            x0 = x0.clamp(-1.0, 1.0)
        x = float(t["c_x0"][i]) * x0 + float(t["c_x"][i]) * x
        if i < L - 1:
            x = x + float(t["std"][i]) * step_noise[i]
    if denoise:
        lab = torch.full((B,), L - 1, dtype=torch.long, device=x.device)
        x = x - float(t["sq1ma"][-1]) * eps_fn(x.permute(0, 3, 1, 2), lab, c).permute(
            0, 2, 3, 1)
    return x


def predict(eps_fn, cfg: dict, cond: torch.Tensor, block_draws: Sequence[dict],
            n_pred: int) -> List[torch.Tensor]:
    """Autoregressive prediction of n_pred frames in blocks of F on cond (B, H,
    W, Fc*C): after each block cond keeps its last frames and takes the
    block's last min(F, Fc) frames. `block_draws[k]` holds block k's "init"
    and "step_noise". Returns each block's output (B, H, W, F*C)."""
    d = cfg["data"]
    C, F, Fc = d["channels"], d["num_frames"], d["num_frames_cond"]
    tables = sampler_tables(cfg)
    s = cfg["sampling"]
    outs = []
    for k in range(math.ceil(n_pred / F)):
        dr = block_draws[k]
        gen = ddpm_block(eps_fn, dr["init"], cond, tables, dr["step_noise"],
                         clip=s.get("clip_before", True), denoise=s.get("denoise", True))
        outs.append(gen)
        cond = torch.cat([cond[..., F * C:], gen[..., C * max(0, F - Fc):]], dim=-1)
    return outs


# ---------------------------------------------------------------- training

def dsm_loss(eps_fn, cfg: dict, X: torch.Tensor, labels: torch.Tensor, z: torch.Tensor,
             alphas: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the per-example sum of 0.5 (z - eps(x_t))^2 with
    x_t = sqrt(a) x + sqrt(1 - a) z, a = alphas[labels]; x the clip's
    predicted frames mapped to [-1, 1], cond its first Fc frames."""
    d = cfg["data"]
    Fc, F = d["num_frames_cond"], d["num_frames"]
    B, T, H, W, C = X.shape
    X = 2.0 * X.float() - 1.0

    def fold(v):
        return v.permute(0, 2, 3, 1, 4).reshape(B, H, W, -1).permute(0, 3, 1, 2)

    x, cond = fold(X[:, Fc:Fc + F]), fold(X[:, :Fc])
    a = alphas[labels].view(B, 1, 1, 1)
    x_t = torch.sqrt(a) * x + torch.sqrt(1.0 - a) * z
    diff = (z - eps_fn(x_t, labels, cond)).reshape(B, -1)
    return (0.5 * diff.square().sum(-1)).mean()


class Adam:
    """Clip by global norm (no epsilon), then Adam with bias correction and a
    learning rate lr * min(count / warmup, 1) at the count of updates made
    before this one; EMA of the parameters after the update. `count` is the
    number of updates made before the first one here, `mu` and `nu` the
    moments they left (zero when not given)."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], count: int = 0,
                 mu: Optional[Dict[str, torch.Tensor]] = None,
                 nu: Optional[Dict[str, torch.Tensor]] = None):
        o = cfg["optim"]
        if o.get("optimizer", "Adam") != "Adam" or o.get("weight_decay", 0.0) or o.get(
                "amsgrad", False):
            raise ValueError("the reference optimizer is Adam without decay or amsgrad")
        self.lr, self.warmup = float(o["lr"]), int(o.get("warmup", 0) or 0)
        self.b1, self.b2, self.eps = float(o.get("beta1", 0.9)), 0.999, float(o["eps"])
        self.clip = o.get("grad_clip")
        self.ema_rate = float(cfg["model"].get("ema_rate", 0.999))
        self.count = int(count)
        self.mu = {k: (torch.zeros_like(p) if mu is None else mu[k].clone())
                   for k, p in params.items()}
        self.nu = {k: (torch.zeros_like(p) if nu is None else nu[k].clone())
                   for k, p in params.items()}

    @torch.no_grad()
    def update(self, params, grads, ema):
        """Updates params and ema in place; returns (raw global norm, the
        clipped gradients as the moments took them)."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        if self.clip and float(norm) >= self.clip:
            grads = {k: g / norm * self.clip for k, g in grads.items()}
        lr = self.lr * (min(self.count / self.warmup, 1.0) if self.warmup > 0 else 1.0)
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g * (1.0 - self.b1))
            self.nu[k].mul_(self.b2).add_(g * g * (1.0 - self.b2))
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            p.sub_(lr * u)
            ema[k].mul_(self.ema_rate).add_(p * (1.0 - self.ema_rate))
        return norm, grads
