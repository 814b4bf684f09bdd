"""The legacy NCSNv1/v2 normalizations (counterpart of
`mcvd_tpu/models/normalization.py`; upstream models/better/normalization.py):
InstanceNorm++, its class-conditional form, VarianceNorm, and
`get_normalization`, on NCHW tensors.

The statistics follow the JAX package: the instance variance over H, W is
biased, the variance across the channel means is unbiased (ddof 1, as
torch's default there). The scales are stored as the JAX package stores
them, as N(0, 0.02) draws around zero, with the 1.0 added at call time; the
conditional norm's embedding is stored the same way, around
concat([ones(2C), zeros(C)]). So the bridge copies every leaf as it is.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from .layers import GroupNorm

EPS = 1e-5
INIT_STD = 0.02   # the stored scales' and the class table's N(0, 0.02)


def _draw_(t: torch.Tensor, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(INIT_STD * torch.randn(t.shape, generator=generator))


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps), per (B, C) over H, W, var biased."""
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + EPS)


def _normalized_channel_means(x: torch.Tensor) -> torch.Tensor:
    """The per-channel spatial means (B, C), normalized across the channels
    with the unbiased variance (the '++' part)."""
    means = x.mean(dim=(2, 3))
    v, m = torch.var_mean(means, dim=-1, keepdim=True, unbiased=True)
    return (means - m) / torch.sqrt(v + EPS)


class _NormEmbedding(nn.Embedding):
    """The conditional norm's class table."""

    def draw_weights(self, generator: torch.Generator) -> None:
        _draw_(self.weight, generator)


class InstanceNorm2dPlus(nn.Module):
    """gamma * (instance_norm(x) + alpha * normalized channel means) + beta,
    with alpha and gamma stored around zero."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(num_features))
        self.gamma = nn.Parameter(torch.zeros(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def draw_weights(self, generator: torch.Generator) -> None:
        _draw_(self.alpha, generator)
        _draw_(self.gamma, generator)
        if self.beta is not None:
            nn.init.zeros_(self.beta)

    def forward(self, x):
        means = _normalized_channel_means(x)
        h = _instance_norm(x) + means[:, :, None, None] * (self.alpha + 1.0)[:, None, None]
        out = (self.gamma + 1.0)[:, None, None] * h
        if self.beta is not None:
            out = out + self.beta[:, None, None]
        return out


class ConditionalInstanceNorm2dPlus(nn.Module):
    """InstanceNorm++ whose gamma, alpha (and beta) are rows of a class
    table `embed` (num_classes x 3C, or 2C without bias) indexed by y."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.num_features = num_features
        self.bias = bias
        n = 3 if bias else 2
        self.embed = _NormEmbedding(num_classes, num_features * n)
        self.embed.weight.data.zero_()
        offset = torch.cat([torch.ones(2 * num_features),
                            torch.zeros(num_features if bias else 0)])
        self.register_buffer("offset", offset, persistent=False)

    def forward(self, x, y):
        e = self.embed(y) + self.offset.to(self.embed.weight.dtype)
        means = _normalized_channel_means(x)
        h = _instance_norm(x)
        if self.bias:
            gamma, alpha, beta = e.chunk(3, dim=-1)
        else:
            (gamma, alpha), beta = e.chunk(2, dim=-1), None
        h = h + means[:, :, None, None] * alpha[:, :, None, None]
        out = gamma[:, :, None, None] * h
        return out if beta is None else out + beta[:, :, None, None]


class VarianceNorm2d(nn.Module):
    """Scale-only instance norm: (alpha + 1) * x / sqrt(var + eps)."""

    def __init__(self, num_features: int, bias: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(num_features))

    def draw_weights(self, generator: torch.Generator) -> None:
        _draw_(self.alpha, generator)

    def forward(self, x):
        var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)
        return (self.alpha + 1.0)[:, None, None] * x * torch.rsqrt(var + EPS)


class ChannelsLastGroupNorm(GroupNorm):
    """`layers.GroupNorm` (eps 1e-6, the GroupNorm kernel on the card) in
    the place of an unconditional norm; it takes its input channels_last,
    as the kernel does, whatever layout the pools and resizes left."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__(num_features)

    def forward(self, x, act: bool = False):
        return super().forward(x.contiguous(memory_format=torch.channels_last), act)


def get_normalization(config, conditional: bool = False):
    """The norm class of `model.normalization` (upstream
    normalization.py:22-40): InstanceNorm++ (the conditional form when
    `conditional`), VarianceNorm, or GroupNorm, which is `layers.GroupNorm`
    and so launches `gn_fused` on the card."""
    norm = getattr(config.model, "normalization", "InstanceNorm++")
    if conditional:
        if norm == "InstanceNorm++":
            return functools.partial(ConditionalInstanceNorm2dPlus,
                                     num_classes=config.model.num_classes)
        raise NotImplementedError(f"{norm} conditional not implemented")
    if norm == "InstanceNorm++":
        return InstanceNorm2dPlus
    if norm == "VarianceNorm":
        return VarianceNorm2d
    if norm == "GroupNorm":
        return ChannelsLastGroupNorm
    raise ValueError(f"Unknown normalization: {norm}")
