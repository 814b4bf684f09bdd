"""The legacy NCSNv1/v2 RefineNet blocks (counterpart of
`mcvd_tpu/models/legacy_blocks.py`; upstream models/better/layers.py:122-500):
the CRP, RCU, MSF and RefineNet families, ConvMeanPool, MeanPoolConv,
UpsampleConv, and the ncsn residual blocks, on NCHW tensors.

torch has the reference's own ops where the JAX package rebuilt them: the
5x5 stride-1 pools are `F.max_pool2d` / `F.avg_pool2d` (count_include_pad:
the divisor is 25 at the borders too), the bilinear resize is
`F.interpolate(align_corners=True)`, and UpsampleConv is upstream's cat x4
and `pixel_shuffle`, which scrambles the channels as the JAX gather copies.

Submodules are named after the flax tree, with the flax `Conv2d` wrapper's
inner `Conv_0` left out (`begin_conv`, `res2_0.conv2.conv`,
`refine1.adapt_convs_0.1_1_conv`, `crp.convs_0`, `norms_0.embed`), so the
weight bridge is a layout transform per leaf (`compat.flax_names`, layout
"ncsn"). The convs of the DDPM-init `Conv2d` draw what the JAX `Conv2d`
draws; the dilated convs are flax's default-init `nn.Conv` (`LecunConv2d`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d
from .normalization import ConditionalInstanceNorm2dPlus, InstanceNorm2dPlus


def max_pool_5x5(x):
    """nn.MaxPool2d(5, stride=1, padding=2)."""
    return F.max_pool2d(x, 5, stride=1, padding=2)


def avg_pool_5x5(x):
    """nn.AvgPool2d(5, stride=1, padding=2), count_include_pad: the divisor
    is always 25."""
    return F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)


def interpolate_bilinear_align(x, shape):
    """F.interpolate(x, size=shape, mode='bilinear', align_corners=True)."""
    return F.interpolate(x, size=tuple(int(s) for s in shape), mode="bilinear",
                         align_corners=True)


def _mean_pool_2x2(x):
    """The mean of the four 2x2-grid subsamples, summed in the JAX order."""
    return (x[:, :, ::2, ::2] + x[:, :, 1::2, ::2]
            + x[:, :, ::2, 1::2] + x[:, :, 1::2, 1::2]) / 4.0


class LecunConv2d(nn.Conv2d):
    """flax's default `nn.Conv`: kernel lecun-normal (variance 1/fan_in,
    truncated at two standard deviations), bias zero; drawn by
    `layers.init_weights` through `draw_weights`."""

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def draw_weights(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        # flax's truncated_normal: a standard normal cut at +-2, its std
        # restored by 1/0.87962566
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(
            2.0 / math.sqrt(2.0))) / 2.0
        u = torch.rand(self.weight.shape, generator=generator, dtype=torch.float32)
        z = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0) * math.sqrt(2.0)
        with torch.no_grad():
            self.weight.copy_(z.clamp(-2.0, 2.0) * std)
            if self.bias is not None:
                self.bias.zero_()


def _dil_conv(in_ch: int, out_ch: int, dil: int) -> LecunConv2d:
    return LecunConv2d(in_ch, out_ch, 3, padding=dil, dilation=dil)


class ConvMeanPool(nn.Module):
    """conv (kernel x kernel, 'same') then the 2x2 mean pool; with
    `adjust_padding` one zero row on top and one column on the left first."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True,
                 adjust_padding: bool = False):
        super().__init__()
        self.adjust_padding = adjust_padding
        self.conv = Conv2d(in_ch, out_ch, kernel, bias=bias)

    def forward(self, x):
        if self.adjust_padding:
            x = F.pad(x, (1, 0, 1, 0))
        return _mean_pool_2x2(self.conv(x))


class MeanPoolConv(nn.Module):
    """The 2x2 mean pool then conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, bias=bias)

    def forward(self, x):
        return self.conv(_mean_pool_2x2(x))


class UpsampleConv(nn.Module):
    """cat([x] * 4, channels) -> pixel_shuffle(2) -> conv, as upstream does it
    (output channel c, subpixel (dy, dx) takes input channel
    (4c + 2dy + dx) mod C)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, bias=bias)

    def forward(self, x):
        up = F.pixel_shuffle(torch.cat([x, x, x, x], dim=1), 2)
        return self.conv(up.contiguous(memory_format=torch.channels_last))


def _add_indexed(module: nn.Module, fmt: str, items) -> List[str]:
    """Register `items` under the names fmt.format(i), in order; returns the
    names."""
    names = []
    for i, m in enumerate(items):
        names.append(fmt.format(i))
        module.add_module(names[-1], m)
    return names


class CRPBlock(nn.Module):
    """Chained residual pooling: act, then n_stages of pool -> conv (no bias),
    each added to the running sum."""

    def __init__(self, features: int, n_stages: int, act: Callable = F.relu,
                 maxpool: bool = True):
        super().__init__()
        self.act, self.pool = act, max_pool_5x5 if maxpool else avg_pool_5x5
        self.convs = _add_indexed(self, "convs_{}", (Conv2d(features, features, 3, bias=False)
                                                     for _ in range(n_stages)))

    def forward(self, x):
        x = self.act(x)
        path = x
        for c in self.convs:
            path = getattr(self, c)(self.pool(path))
            x = path + x
        return x


class CondCRPBlock(nn.Module):
    """Conditional CRP: each stage norm(path, y) -> avg pool -> conv."""

    def __init__(self, features: int, n_stages: int, normalizer, act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.norms = _add_indexed(self, "norms_{}", (normalizer(features)
                                                     for _ in range(n_stages)))
        self.convs = _add_indexed(self, "convs_{}", (Conv2d(features, features, 3, bias=False)
                                                     for _ in range(n_stages)))

    def forward(self, x, y):
        x = self.act(x)
        path = x
        for n, c in zip(self.norms, self.convs):
            path = getattr(self, c)(avg_pool_5x5(getattr(self, n)(path, y)))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units: n_blocks of (act -> conv) x n_stages + residual;
    the convs are named `{i+1}_{j+1}_conv`. Conditional with `normalizer`
    (upstream's CondRCUBlock): a norm `{i+1}_{j+1}_norm`(x, y) before each
    act."""

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 act: Callable = F.relu, normalizer=None):
        super().__init__()
        self.act = act
        self.conditional = normalizer is not None
        self.units = []
        for i in range(n_blocks):
            unit = []
            for j in range(n_stages):
                if self.conditional:
                    self.add_module(f"{i + 1}_{j + 1}_norm", normalizer(features))
                self.add_module(f"{i + 1}_{j + 1}_conv",
                                Conv2d(features, features, 3, bias=False))
                unit.append(f"{i + 1}_{j + 1}")
            self.units.append(unit)

    def forward(self, x, y=None):
        for unit in self.units:
            residual = x
            for s in unit:
                if self.conditional:
                    x = getattr(self, f"{s}_norm")(x, y)
                x = getattr(self, f"{s}_conv")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: a conv (with bias) on each input, the bilinear
    align_corners resize to `shape`, the sum; conditional with `normalizer`
    (upstream's CondMSFBlock): a norm(x, y) before each conv."""

    def __init__(self, in_planes: Sequence[int], features: int, normalizer=None):
        super().__init__()
        self.conditional = normalizer is not None
        if self.conditional:
            self.norms = _add_indexed(self, "norms_{}", (normalizer(c) for c in in_planes))
        self.convs = _add_indexed(self, "convs_{}", (Conv2d(c, features, 3, bias=True)
                                                     for c in in_planes))

    def forward(self, xs, shape, y=None):
        assert len(xs) == len(self.convs)
        out = None
        for i, xi in enumerate(xs):
            if self.conditional:
                xi = getattr(self, self.norms[i])(xi, y)
            h = interpolate_bilinear_align(getattr(self, self.convs[i])(xi), shape)
            out = h if out is None else out + h
        return out


class RefineBlock(nn.Module):
    """RefineNet block: an RCU adapter (2 x 2) per input -> MSF (when there
    are several inputs) -> CRP (2 stages) -> output RCU (3 blocks when
    `end`, else 1). Conditional with `normalizer` (upstream's
    CondRefineBlock), a callable(features) of a norm taking (x, y)."""

    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu,
                 end: bool = False, maxpool: bool = True, normalizer=None):
        super().__init__()
        self.conditional = normalizer is not None
        self.adapt = _add_indexed(self, "adapt_convs_{}", (RCUBlock(c, 2, 2, act, normalizer)
                                                           for c in in_planes))
        if len(in_planes) > 1:
            self.msf = MSFBlock(in_planes, features, normalizer)
        self.crp = (CondCRPBlock(features, 2, normalizer, act) if self.conditional
                    else CRPBlock(features, 2, act, maxpool=maxpool))
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act, normalizer)

    def forward(self, xs, output_shape, y=None):
        assert len(xs) == len(self.adapt)
        hs = [getattr(self, a)(xi, y) for a, xi in zip(self.adapt, xs)]
        h = self.msf(hs, output_shape, y) if len(hs) > 1 else hs[0]
        h = self.crp(h, y) if self.conditional else self.crp(h)
        return self.output_convs(h, y)


class ResidualBlock(nn.Module):
    """The ncsn residual block: norm -> act -> conv, twice, plus a shortcut;
    `resample="down"` halves the size by ConvMeanPool, except on the dilated
    branches, which keep it (padding = dilation, no pool). The plain
    shortcut is a 1x1 conv where the width changes; the dilated one a 3x3
    dilated conv. `num_classes` makes every norm conditional, norm(x, y)
    (upstream's ConditionalResidualBlock, whose plain branch with another
    width, a TypeError upstream, takes the 1x1 conv as the JAX package
    does)."""

    def __init__(self, input_dim: int, output_dim: int, resample: Optional[str] = None,
                 act: Callable = F.elu, normalization=None, adjust_padding: bool = False,
                 dilation: int = 1, num_classes: Optional[int] = None):
        super().__init__()
        self.act = act
        self.conditional = num_classes is not None
        if self.conditional:
            base = normalization or ConditionalInstanceNorm2dPlus

            def norm(c):
                return base(c, num_classes)
        else:
            norm = normalization or InstanceNorm2dPlus
        dil = dilation
        self.normalize1 = norm(input_dim)
        self.shortcut = None
        if resample == "down":
            if dil > 1:
                self.conv1 = _dil_conv(input_dim, input_dim, dil)
                self.normalize2 = norm(input_dim)
                self.conv2 = _dil_conv(input_dim, output_dim, dil)
                self.shortcut = _dil_conv(input_dim, output_dim, dil)
            else:
                self.conv1 = Conv2d(input_dim, input_dim, 3)
                self.normalize2 = norm(input_dim)
                self.conv2 = ConvMeanPool(input_dim, output_dim, 3,
                                          adjust_padding=adjust_padding)
                self.shortcut = ConvMeanPool(input_dim, output_dim, 1,
                                             adjust_padding=adjust_padding)
        elif resample is None:
            if dil > 1:
                self.conv1 = _dil_conv(input_dim, output_dim, dil)
                self.normalize2 = norm(output_dim)
                self.conv2 = _dil_conv(output_dim, output_dim, dil)
                if output_dim != input_dim:
                    self.shortcut = _dil_conv(input_dim, output_dim, dil)
            else:
                self.conv1 = Conv2d(input_dim, output_dim, 3)
                self.normalize2 = norm(output_dim)
                self.conv2 = Conv2d(output_dim, output_dim, 3)
                if output_dim != input_dim:   # upstream's 1x1 ncsn conv
                    self.shortcut = Conv2d(input_dim, output_dim, 1)
        else:
            raise ValueError(f"invalid resample {resample}")

    def _norm(self, norm, x, y):
        return norm(x, y) if self.conditional else norm(x)

    def forward(self, x, y=None):
        h = self.conv1(self.act(self._norm(self.normalize1, x, y)))
        h = self.conv2(self.act(self._norm(self.normalize2, h, y)))
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return shortcut + h
