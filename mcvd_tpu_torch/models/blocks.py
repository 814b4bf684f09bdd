"""NCSN++ building blocks on NCHW channels_last tensors (counterpart of
`mcvd_tpu/models/blocks.py`), 2D and group-norm branches.

Attribute names are upstream's (Conv_0, GroupNorm_0, NIN_0, Dense_0,
actnorm0, Norm_0, ...), so upstream state dicts load by name. The SPADE
norm, the 3D/pseudo-3D conv families and the DDPM resblock raise
NotImplementedError: ROADMAP Queue 1 item 13 ports them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from . import resample
from .layers import NIN, Conv2d, GroupNorm, Linear, num_groups_for

_LATER = "not ported yet (ROADMAP Queue 1 item 13: model variants)"
FIR_KERNEL = (1, 3, 3, 1)

# the DDPM-init 'same' conv; one class serves both names here
Conv2dSame = Conv2d


class AttnBlock(nn.Module):
    """Multi-head self-attention over the H*W tokens (upstream
    AttnBlockpp with skip_rescale): GroupNorm(eps 1e-6) -> one fused QKV
    matmul -> the attention kernel on the packed qkv -> NIN_3 ->
    (x + h)/sqrt(2)."""

    def __init__(self, channels: int, init_scale: float = 0.0, n_heads: int = 1,
                 n_head_channels: int = -1):
        super().__init__()
        C = channels
        if n_head_channels == -1:
            self.n_heads = n_heads
        elif C < n_head_channels:
            self.n_heads = 1
        else:
            if C % n_head_channels:
                raise ValueError(f"{C} channels do not split into {n_head_channels}-channel heads")
            self.n_heads = C // n_head_channels
        self.GroupNorm_0 = GroupNorm(C, eps=1e-6)
        self.NIN_0 = NIN(C, C)
        self.NIN_1 = NIN(C, C)
        self.NIN_2 = NIN(C, C)
        self.NIN_3 = NIN(C, C, init_scale=init_scale)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.GroupNorm_0(x)
        tokens = h.permute(0, 2, 3, 1).reshape(B * H * W, C)
        w_qkv = torch.cat([self.NIN_0.W, self.NIN_1.W, self.NIN_2.W], dim=1)
        b_qkv = torch.cat([self.NIN_0.b, self.NIN_1.b, self.NIN_2.b])
        qkv = torch.addmm(b_qkv, tokens, w_qkv).view(B, H * W, 3 * C)
        hd = C // self.n_heads
        o = ops.attention.attention_packed(qkv, self.n_heads, hd ** -0.5)
        h = self.NIN_3(o).view(B, H, W, C).permute(0, 3, 1, 2)
        return (x + h) / math.sqrt(2.0)


class ActNorm(nn.Module):
    """GroupNorm -> (AdaGN from temb) -> SiLU, all in one GroupNorm-kernel
    call (upstream get_act_norm). With emb: GroupNorm(affine=False) at eps
    1e-5, Dense_0(SiLU(emb)) -> (scale, shift), x*(1+scale)+shift. Without:
    affine Norm_0 at eps 1e-5."""

    def __init__(self, ch: int, emb_dim: Optional[int] = None, norm: str = "group",
                 is3d: bool = False):
        super().__init__()
        if norm != "group":
            raise NotImplementedError(f"ActNorm norm={norm!r}: {_LATER}")
        if is3d:
            raise NotImplementedError(f"ActNorm over 3D frames: {_LATER}")
        self.ch = ch
        if emb_dim is not None:
            self.Dense_0 = Linear(emb_dim, 2 * ch)
        else:
            self.Norm_0 = GroupNorm(ch, eps=1e-5)

    def forward(self, x, emb=None):
        if emb is None:
            return self.Norm_0(x, act=True)
        scale, shift = self.Dense_0(F.silu(emb)).chunk(2, dim=1)
        return ops.groupnorm.group_norm(
            x, num_groups_for(self.ch), eps=1e-5, scale=scale, shift=shift, act=True)


class ResnetBlockBigGAN(nn.Module):
    """actnorm0 -> [FIR (1,3,3,1) up/down] -> Conv_0 -> actnorm1 -> dropout
    -> Conv_1 (init 0) -> (+ Conv_2 1x1 shortcut) / sqrt(2)
    (upstream ResnetBlockBigGANppGN with fir and skip_rescale, as NCSN++
    builds it).

    In training mode the dropout mask is drawn from `generator` (the train
    step's explicit one; torch's global generator when None), as flax draws
    it from the step's dropout key: keep where U[0, 1) >= rate, kept values
    scaled by 1/(1 - rate)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, up: bool = False, down: bool = False,
                 dropout: float = 0.1, init_scale: float = 0.0, conv_mode: str = "2d",
                 norm: str = "group"):
        super().__init__()
        if conv_mode != "2d":
            raise NotImplementedError(f"ResnetBlockBigGAN conv_mode={conv_mode!r}: {_LATER}")
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        self.actnorm0 = ActNorm(in_ch, temb_dim, norm=norm)
        self.Conv_0 = Conv2dSame(in_ch, out_ch, 3)
        self.actnorm1 = ActNorm(out_ch, temb_dim, norm=norm)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = Conv2dSame(out_ch, out_ch, 3, init_scale=init_scale)
        self.Conv_2 = (Conv2dSame(in_ch, out_ch, 1)
                       if in_ch != out_ch or up or down else None)

    def dropout(self, h, generator=None):
        rate = self.Dropout_0.p
        if not self.training or rate == 0.0:
            return h
        B, C, H, W = h.shape   # the mask in h's channels_last layout
        u = torch.rand(B, H, W, C, generator=generator, device=h.device).permute(0, 3, 1, 2)
        return h * (u >= rate).to(h.dtype) / (1.0 - rate)

    def forward(self, x, temb=None, generator=None):
        h = self.actnorm0(x, temb)
        if self.up:
            h = resample.upsample_2d(h, FIR_KERNEL, factor=2)
            x = resample.upsample_2d(x, FIR_KERNEL, factor=2)
        elif self.down:
            h = resample.downsample_2d(h, FIR_KERNEL, factor=2)
            x = resample.downsample_2d(x, FIR_KERNEL, factor=2)
        h = self.Conv_0(h)
        h = self.actnorm1(h, temb)
        h = self.dropout(h, generator)
        h = self.Conv_1(h)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return (x + h) / math.sqrt(2.0)


class ResnetBlockDDPM(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ResnetBlockDDPM: {_LATER}")
