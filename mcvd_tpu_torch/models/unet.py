"""The legacy small UNet, `arch: unet` (counterpart of
`mcvd_tpu/models/unet.py`; upstream models/unet.py UNet:175, UNet_DDPM:327),
the network of configs/smmnist_DDPM_small5.yml, on NCHW channels_last
tensors. The JAX module's quirks are kept:

  * the channel ladder comes from `config.mode` (deep, deeper, deepest;
    default deep) and `model.ch_mult` is ignored;
  * attention runs only at ladder index 1 and in the middle, and its output
    replaces the resblock's entry in the skip stack;
  * Dropout2d: whole channels, the mask drawn from the step's generator;
  * the input is mapped to 2x-1 in the forward when the data is not
    rescaled;
  * xavier-uniform init with gain sqrt(scale) (`layers.default_init_`, the
    same distribution);
  * `noise_in_cond` takes an explicit draw, as `UNetMoreDDPM` does.

Its GroupNorms (32 groups, eps 1e-6, affine) run through the GroupNorm
kernel, with the SiLU fused where the JAX code applies act(GroupNorm(x)),
and its single-head attention (scale 1/sqrt(C)) through the attention
kernel on the packed q, k, v of one fused projection.

Names are upstream's, so its state dicts load by name: `downblocks.i`,
`middleblocks.i`, `upblocks.i`, `temb_dense.0`/`.2`, `normalize`, `out`,
and each `Nin` keeps `weights` as (out, in).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..diffusion.schedules import make_schedule
from .layers import Conv2d, GroupNorm, LegacyNin as Nin, Linear, get_timestep_embedding

LEGACY_GROUPS = 32


def _group_norm(ch: int) -> GroupNorm:
    return GroupNorm(ch, eps=1e-6, num_groups=LEGACY_GROUPS)


def _dropout2d(h: torch.Tensor, rate: float, training: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Whole-channel dropout (flax Dropout with broadcast over H and W): keep
    channel (b, c) where U[0, 1) >= rate, scaled by 1/(1 - rate)."""
    if not training or rate == 0.0:
        return h
    B, C = h.shape[:2]
    u = torch.rand(B, C, generator=generator, device=h.device)
    return h * ((u >= rate).to(h.dtype) / (1.0 - rate))[:, :, None, None]


class ResnetBlock(nn.Module):
    """SiLU(normalize0(x)) -> conv0 (-> + dense(temb)) -> SiLU(normalize1)
    -> Dropout2d -> conv1 (init 1e-10) -> + x (through `nin` where the width
    changes)."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float, temb_dim: int,
                 conditional: bool):
        super().__init__()
        self.dropout = dropout
        self.normalize0 = _group_norm(in_ch)
        self.conv0 = Conv2d(in_ch, out_ch, 3)
        if conditional:
            self.dense = Linear(temb_dim, out_ch)
        self.normalize1 = _group_norm(out_ch)
        self.conv1 = Conv2d(out_ch, out_ch, 3, init_scale=0.0)
        if in_ch != out_ch:
            self.nin = Nin(in_ch, out_ch)

    def forward(self, x, temb=None, generator=None):
        h = self.conv0(self.normalize0(x, act=True))
        if temb is not None and hasattr(self, "dense"):
            h = h + self.dense(temb)[:, :, None, None]
        h = _dropout2d(self.normalize1(h, act=True), self.dropout, self.training, generator)
        h = self.conv1(h)
        if hasattr(self, "nin"):
            x = self.nin(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the H*W tokens, scale 1/sqrt(C):
    normalize -> one fused Q|K|V projection -> the attention kernel on the
    packed qkv -> OUT (init 1e-10) -> x + h."""

    def __init__(self, channels: int):
        super().__init__()
        C = channels
        self.normalize = _group_norm(C)
        self.Q, self.K, self.V = Nin(C, C), Nin(C, C), Nin(C, C)
        self.OUT = Nin(C, C, init_scale=0.0)

    def forward(self, x):
        B, C, H, W = x.shape
        tokens = self.normalize(x).permute(0, 2, 3, 1).reshape(B * H * W, C)
        w_qkv = torch.cat([self.Q.weights, self.K.weights, self.V.weights]).t()
        b_qkv = torch.cat([self.Q.bias, self.K.bias, self.V.bias])
        qkv = torch.addmm(b_qkv, tokens, w_qkv).view(B, H * W, 3 * C)
        o = ops.attention.attention_packed(qkv, 1, C ** -0.5)
        h = self.OUT(o).view(B, H, W, C).permute(0, 3, 1, 2)
        return x + h


class Upsample(nn.Module):
    """Nearest x2, then `conv` 3x3."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def channel_ladder(config):
    ch = config.model.ngf
    mode = getattr(config, "mode", "deep")
    mult = {"deepest": (1, 2, 2, 2, 4, 4), "deeper": (1, 2, 2, 4, 4)}.get(mode, (1, 2, 2, 2))
    return [ch * n for n in mult]


class UNet(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        d, m = config.data, config.model
        self.n_channels = d.channels
        self.ch = ch = m.ngf
        self.time_conditional = bool(getattr(m, "time_conditional", False))
        self.rescale_input = not d.logit_transform and not d.rescaled
        self.num_frames = getattr(d, "num_frames", 1)
        self.num_frames_cond = getattr(d, "num_frames_cond", 0) + getattr(
            d, "num_frames_future", 0)
        self.output_all_frames = bool(getattr(m, "output_all_frames", False))
        drop = getattr(m, "dropout", 0.0)
        ladder = channel_ladder(config)

        def res(cin, cout):
            return ResnetBlock(cin, cout, drop, ch * 4, self.time_conditional)

        in_ch = self.n_channels * (self.num_frames + self.num_frames_cond)
        down, kinds = [Conv2d(in_ch, ch, 3)], ["conv"]
        prev, ch_size = ladder[0], [ch]
        for i, ich in enumerate(ladder):
            for first in (prev, ich):
                down.append(res(first, ich))
                kinds.append("res")
                ch_size.append(ich)
                if i == 1:
                    down.append(AttnBlock(ich))
                    kinds.append("attn")
            if i != len(ladder) - 1:
                down.append(Conv2d(ich, ich, 3, stride=2))
                kinds.append("conv")
                ch_size.append(ich)
            prev = ich
        self.downblocks = nn.ModuleList(down)
        self._down_kinds = kinds
        top = ladder[-1]
        self.middleblocks = nn.ModuleList([res(top, top), AttnBlock(top), res(top, top)])

        up, kinds = [], []
        prev = top
        for i, ich in reversed(list(enumerate(ladder))):
            for _ in range(3):
                up.append(res(prev + ch_size.pop(), ich))
                kinds.append("res")
                if i == 1:
                    up.append(AttnBlock(ich))
                    kinds.append("attn")
                prev = ich
            if i != 0:
                up.append(Upsample(ich))
                kinds.append("up")
        self.upblocks = nn.ModuleList(up)
        self._up_kinds = kinds

        out_ch = self.n_channels * (self.num_frames + (
            self.num_frames_cond if self.output_all_frames else 0))
        self.normalize = _group_norm(ch)
        self.out = Conv2d(ch, out_ch, 3, init_scale=0.0)
        self.temb_dense = nn.Sequential(Linear(ch, ch * 4), nn.SiLU(), Linear(ch * 4, ch * 4),
                                        nn.SiLU())

    def forward(self, x, y=None, cond=None, dropout_generator=None):
        gen = dropout_generator
        temb = None
        if y is not None and self.time_conditional:
            temb = self.temb_dense(get_timestep_embedding(y, self.ch).to(x.dtype))
        if cond is not None:
            x = torch.cat([x, cond], dim=1)
        if self.rescale_input:
            x = 2 * x - 1.0
        x = x.contiguous(memory_format=torch.channels_last)

        hs = []
        for kind, module in zip(self._down_kinds, self.downblocks):
            x = module(x, temb, gen) if kind == "res" else module(x)
            if kind == "attn":
                hs.pop()
            hs.append(x)
        for module in self.middleblocks:
            x = module(x) if isinstance(module, AttnBlock) else module(x, temb, gen)
        for kind, module in zip(self._up_kinds, self.upblocks):
            if kind == "res":
                x = module(torch.cat([x, hs.pop()], dim=1), temb, gen)
            else:
                x = module(x)
        out = self.out(self.normalize(x, act=True))
        if self.output_all_frames and cond is not None:
            out = out[:, self.num_frames_cond * self.n_channels:]
        return out


class UNetLegacy(nn.Module):
    """UNet_DDPM / UNet_SMLD (upstream models/unet.py:301-380): the schedule
    tables as buffers (`betas`, `alphas`, `alphas_prev`; `sigmas` for SMLD)
    and the network as `unet`. With `model.noise_in_cond`, cond is perturbed
    at the labels' level by the explicit draw `cond_noise` (cond's shape,
    N(0, 1)): cond + sigmas[y] z (SMLD), sqrt(a) cond + sqrt(1 - a) z with a
    = alphas[y] (DDPM family)."""

    def __init__(self, config):
        super().__init__()
        self.version = getattr(config.model, "version", "SMLD").upper()
        self.noise_in_cond = bool(getattr(config.model, "noise_in_cond", False))
        self.unet = UNet(config)
        sched = make_schedule(config)
        names = ("sigmas",) if self.version == "SMLD" else ("betas", "alphas", "alphas_prev")
        for name in names:
            self.register_buffer(name, torch.from_numpy(getattr(sched, name).copy()))

    def forward(self, x, y, cond=None, cond_mask=None, dropout_generator=None,
                cond_noise: Optional[torch.Tensor] = None):
        if self.noise_in_cond and cond is not None:
            if cond_noise is None:
                raise ValueError("noise_in_cond needs the cond-noise draw (draw_cond_noise)")
            shape = (cond.shape[0],) + (1,) * (cond.ndim - 1)
            z = cond_noise.float()
            if self.version == "SMLD":
                c = cond.float() + self.sigmas[y].view(shape) * z
            else:
                used = self.alphas[y].view(shape)
                c = torch.sqrt(used) * cond.float() + torch.sqrt(1.0 - used) * z
            cond = c.to(cond.dtype)
        return self.unet(x, y, cond, dropout_generator)


__all__ = ["Nin", "UNet", "UNetLegacy", "channel_ladder"]
