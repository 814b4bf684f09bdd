"""The legacy NCSN image score networks on the RefineNet blocks (counterpart
of `mcvd_tpu/models/ncsnv2.py`): NCSNv2 and its Deeper and Deepest forms,
dispatched by image size (>= 256 Deepest, >= 96 Deeper), and NCSNv1,
`CondRefineNetDilated`, whose class-conditional norms carry the noise
level. Upstream ships no such model (its dispatcher returns None for `arch:
ncsn`); the JAX package rebuilt them from the published architectures, and
this is that rebuild, on NCHW channels_last tensors.

The call is the video nets' (x, y, cond=None, cond_mask=None, ...): cond
frames are concatenated on the channels, the input is mapped to 2x-1 unless
the data is rescaled or logit-transformed, and the raw output is the eps
prediction (`_smld_rescale` is the identity; the JAX docstring says why).
NCSNv2 reads y nowhere. The dilated stages keep their size (padding =
dilation, no pool), as the JAX package repaired upstream's blocks.

Names follow the flax tree (`begin_conv`, `res1_0`, `refine1`,
`normalizer`, `end_conv`; `legacy_blocks` says how), so the models carry
`flax_layout = "ncsn"` for the weight bridge. With `model.normalization:
GroupNorm` the norms are `layers.GroupNorm`, which launches the GroupNorm
kernel on the card.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import legacy_blocks as lb
from .layers import Conv2d
from .normalization import ConditionalInstanceNorm2dPlus, get_normalization

_ACTS = {"elu": F.elu, "relu": F.relu, "swish": F.silu, "silu": F.silu,
         "softplus": F.softplus, "lrelu": functools.partial(F.leaky_relu, negative_slope=0.2)}

# A stage: (name, input width and output width in ngf, resample, dilation,
# adjust_padding at 28 px); res{name}_0 changes the width, res{name}_1 keeps it.
Stage = Tuple[str, int, int, object, int, bool]
# A refine block: (name, features in ngf, the stage whose output it takes).
Refine = Tuple[str, int, str]

DEEP: List[Stage] = [("1", 1, 1, None, 1, False), ("2", 1, 2, "down", 1, False),
                     ("3", 2, 2, "down", 2, False), ("4", 2, 2, "down", 4, True)]
DEEP_REFINES: List[Refine] = [("1", 2, "4"), ("2", 2, "3"), ("3", 1, "2"), ("4", 1, "1")]
DEEPER: List[Stage] = [("1", 1, 1, None, 1, False), ("2", 1, 2, "down", 1, False),
                       ("3", 2, 2, "down", 1, False), ("4", 2, 4, "down", 2, False),
                       ("5", 4, 4, "down", 4, False)]
DEEPER_REFINES: List[Refine] = [("1", 4, "5"), ("2", 2, "4"), ("3", 2, "3"), ("4", 1, "2"),
                                ("5", 1, "1")]
DEEPEST: List[Stage] = DEEPER[:3] + [("31", 2, 2, "down", 1, False)] + DEEPER[3:]
DEEPEST_REFINES: List[Refine] = DEEPER_REFINES[:2] + [("31", 2, "31")] + DEEPER_REFINES[2:]


def _get_act(config):
    """`model.nonlinearity` (default elu); an unknown name raises."""
    name = str(getattr(config.model, "nonlinearity", "elu")).lower()
    if name not in _ACTS:
        raise ValueError(f"model.nonlinearity={name!r} not supported for the ncsn archs "
                         f"(one of {sorted(_ACTS)})")
    return _ACTS[name]


def _input_scale(config, x):
    """2x - 1 unless the data is already centred (logit_transform or
    rescaled)."""
    logit = bool(getattr(config.data, "logit_transform", False))
    rescaled = bool(getattr(config.data, "rescaled", False))
    return x if (logit or rescaled) else 2.0 * x - 1.0


def _smld_rescale(config, out, y):
    """The identity: the raw output is the eps prediction (the JAX
    package's `_smld_rescale`)."""
    return out


def _widths(config) -> Tuple[int, int]:
    """(input channels, output channels): the predicted frames and the cond
    frames concatenated on them; the output is the predicted frames, or all
    of them with `model.output_all_frames`."""
    d = config.data
    n_cond = d.num_frames_cond + getattr(d, "num_frames_future", 0)
    n_in = d.channels * (d.num_frames + n_cond)
    all_frames = bool(getattr(config.model, "output_all_frames", False))
    return n_in, n_in if all_frames else d.channels * d.num_frames


class _RefineNet(nn.Module):
    """begin_conv -> the stages' residual blocks -> the refine blocks from
    the deepest stage up -> normalizer -> act -> end_conv."""

    flax_layout = "ncsn"
    conditional = False

    def __init__(self, config, stages: List[Stage], refines: List[Refine]):
        super().__init__()
        self.config = config
        ngf = config.model.ngf
        self.act = act = _get_act(config)
        adjust = int(getattr(config.data, "image_size", 32)) == 28
        n_in, n_out = _widths(config)
        if self.conditional:
            if getattr(config.model, "normalization", "InstanceNorm++") != "InstanceNorm++":
                raise NotImplementedError("NCSNv1 supports only InstanceNorm++ conditional "
                                          "norms")
            norm = functools.partial(ConditionalInstanceNorm2dPlus,
                                     num_classes=config.model.num_classes)
            res_kw = dict(num_classes=config.model.num_classes)
            ref_kw = dict(normalizer=norm)
        else:
            norm = get_normalization(config)
            res_kw = dict(normalization=norm)
            ref_kw = {}
        self.begin_conv = Conv2d(n_in, ngf, 3)
        self.stages, width = [], {}
        for name, w_in, w_out, resample, dil, adj in stages:
            self.add_module(f"res{name}_0", lb.ResidualBlock(
                w_in * ngf, w_out * ngf, resample=resample, act=act, dilation=dil,
                adjust_padding=adj and adjust, **res_kw))
            self.add_module(f"res{name}_1", lb.ResidualBlock(
                w_out * ngf, w_out * ngf, act=act, dilation=dil, **res_kw))
            self.stages.append(name)
            width[name] = w_out * ngf
        self.refines, prev = [], None
        for i, (name, feats, skip) in enumerate(refines):
            planes = [width[skip]] + ([prev] if prev is not None else [])
            self.add_module(f"refine{name}", lb.RefineBlock(
                planes, feats * ngf, act=act, end=i == len(refines) - 1, **ref_kw))
            self.refines.append((name, skip))
            prev = feats * ngf
        self.normalizer = norm(ngf)
        self.end_conv = Conv2d(ngf, n_out, 3)

    def forward(self, x, y, cond=None, cond_mask=None, dropout_generator=None,
                cond_noise=None):
        """(B, C*F, H, W) -> (B, C*F, H, W). `cond_mask`, `dropout_generator`
        and `cond_noise` are the video nets' arguments, which these nets do
        not read (the JAX models ignore `sched` and `rng` so)."""
        y_c = y if self.conditional else None
        h = _input_scale(self.config, x)
        if cond is not None:
            h = torch.cat([h, cond], dim=1)
        h = self.begin_conv(h.contiguous(memory_format=torch.channels_last))
        outs = {}
        for name in self.stages:
            h = getattr(self, f"res{name}_0")(h, y_c)
            h = outs[name] = getattr(self, f"res{name}_1")(h, y_c)
        r = None
        for name, skip in self.refines:
            xs = [outs[skip]] + ([r] if r is not None else [])
            r = getattr(self, f"refine{name}")(xs, outs[skip].shape[2:], y_c)
        out = self.normalizer(r, y) if self.conditional else self.normalizer(r)
        out = self.end_conv(self.act(out))
        return out if self.conditional else _smld_rescale(self.config, out, y)


class NCSNv2(_RefineNet):
    """NCSNv2 (the published 'deep' form): 4 stages, the last two dilated,
    unconditional norms."""

    def __init__(self, config):
        super().__init__(config, DEEP, DEEP_REFINES)


class NCSNv2Deeper(_RefineNet):
    """5 stages, for 96-255 px."""

    def __init__(self, config):
        super().__init__(config, DEEPER, DEEPER_REFINES)


class NCSNv2Deepest(_RefineNet):
    """Deeper with one more undilated 2ngf stage (res31 / refine31), for
    256 px and up."""

    def __init__(self, config):
        super().__init__(config, DEEPEST, DEEPEST_REFINES)


class CondRefineNetDilated(_RefineNet):
    """NCSNv1: NCSNv2's 'deep' stages with class-conditional InstanceNorm++
    everywhere (the noise level y picks the row); no output rescale."""

    conditional = True

    def __init__(self, config):
        super().__init__(config, DEEP, DEEP_REFINES)


def get_ncsn_model(config) -> nn.Module:
    """arch 'ncsn' -> NCSNv1; 'ncsnv2' -> NCSNv2 by `data.image_size`."""
    if getattr(config.model, "arch", "ncsnv2") == "ncsn":
        return CondRefineNetDilated(config)
    size = int(getattr(config.data, "image_size", 32))
    if size >= 256:
        return NCSNv2Deepest(config)
    if size >= 96:
        return NCSNv2Deeper(config)
    return NCSNv2(config)
