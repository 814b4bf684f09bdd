"""Core layers: DDPM init, time embedding, NIN, convs, group norm
(counterpart of `mcvd_tpu/models/layers.py`).

Tensors inside the model are NCHW stored `channels_last`, whose memory is the
JAX package's NHWC. Parameters keep the upstream torch layouts and names, so
upstream `.pt` state dicts load as they are.

Weights are drawn by `init_weights(module, generator)` from an explicit
`torch.Generator`; construction itself fills zeros and draws nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops


def num_groups_for(ch: int) -> int:
    """min(ch//4, 32), decremented until it divides ch."""
    g = min(ch // 4, 32)
    if g < 1:
        return 1
    while ch % g != 0:
        g -= 1
    return g


def default_init_(w: torch.Tensor, scale: float, generator: torch.Generator,
                  in_out: bool = False) -> None:
    """DDPM init in place: variance_scaling(scale, fan_avg, uniform), with
    scale 0 mapped to 1e-10 (the JAX package's `default_init`). Fans follow
    torch layouts: Linear (out,in) and Conv (O,I,kh,kw) give fan_in=I*kh*kw,
    fan_out=O*kh*kw; `in_out=True` reads an (in,out) matrix (NIN's W)."""
    scale = 1e-10 if scale == 0 else scale
    if in_out:
        fan_in, fan_out = w.shape[0], w.shape[1]
    else:
        rf = int(np.prod(w.shape[2:])) if w.ndim > 2 else 1
        fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float32)
    with torch.no_grad():
        w.copy_((2.0 * u - 1.0) * limit)


class Conv2d(nn.Conv2d):
    """kxk stride-1 'same' conv with DDPM init (JAX `Conv2dSame`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, *,
                 init_scale: float = 1.0, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, padding=kernel // 2, bias=bias)
        self.init_scale = init_scale

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Linear(nn.Linear):
    """Dense with DDPM init (flax `nn.Dense(kernel_init=default_init())`)."""

    def __init__(self, in_features: int, out_features: int, *, init_scale: float = 1.0):
        super().__init__(in_features, out_features)
        self.init_scale = init_scale

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class NIN(nn.Module):
    """Per-pixel channel mixing on a channels-last tensor (..., in) -> (..., out);
    W is (in, out) as upstream stores it."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))
        self.init_scale = init_scale

    def forward(self, x):
        return torch.matmul(x, self.W) + self.b


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight of `module` in `modules()` order from `generator`
    (CPU). Biases and GroupNorm shifts are zero, GroupNorm scales one, the
    cond-mask embedding N(0, 1)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            default_init_(m.weight, m.init_scale, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, NIN):
            default_init_(m.W, m.init_scale, generator, in_out=True)
            nn.init.zeros_(m.b)
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding in fp32 (upstream models/better/layers.py)."""
    if timesteps.ndim != 1:
        raise ValueError(f"timesteps must be 1-D, got shape {tuple(timesteps.shape)}")
    half_dim = embedding_dim // 2
    scale = math.log(max_positions) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                   device=timesteps.device) * -scale)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def group_norm_folded(
    x: torch.Tensor,
    num_groups: int,
    *,
    eps: float = 1e-6,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    frames_last: int = 1,
    act: bool = False,
):
    """GroupNorm(+affine)(+AdaGN)(+SiLU) over (B, C*N, H, W): the plain
    version of the GroupNorm kernel. Stats in fp32 as E[x^2]-mean^2; channel
    index c*N+n (channel-major frame fold) belongs to the group of c, so a
    group is a contiguous run of (C/G)*N channels. The tail folds into one
    per-(b, channel) y = A*x + B, then SiLU. Returns (y, A, B)."""
    B, CN = x.shape[0], x.shape[1]
    G = num_groups
    xf = x.float()
    dims = tuple(range(2, x.ndim))
    S = int(np.prod(x.shape[2:]))
    s1 = xf.sum(dims).view(B, G, -1).sum(-1)
    s2 = (xf * xf).sum(dims).view(B, G, -1).sum(-1)
    n = S * (CN // G)
    mean_g = s1 / n
    var_g = s2 / n - mean_g * mean_g
    rstd_g = torch.rsqrt(var_g + eps)
    A = rstd_g.repeat_interleave(CN // G, dim=1)
    Bc = (-mean_g * rstd_g).repeat_interleave(CN // G, dim=1)
    if gamma is not None:
        g = gamma.float().repeat_interleave(frames_last)
        b = beta.float().repeat_interleave(frames_last)
        A = A * g
        Bc = Bc * g + b
    if scale is not None:
        e = 1.0 + scale.float()
        A = A * e
        Bc = Bc * e + shift.float()
    bshape = (B, CN) + (1,) * (x.ndim - 2)
    y = xf * A.view(bshape) + Bc.view(bshape)
    if act:
        y = F.silu(y)
    return y.to(x.dtype), A, Bc


class GroupNorm(nn.Module):
    """Affine GroupNorm over NCHW with an optional fused SiLU, through the
    GroupNorm kernel (`ops.groupnorm.group_norm`). (The AdaGN norms have no
    affine and call the kernel directly, from `blocks.ActNorm`.)"""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, act: bool = False):
        return ops.groupnorm.group_norm(
            x, num_groups_for(self.channels), eps=self.eps, gamma=self.weight,
            beta=self.bias, act=act)
