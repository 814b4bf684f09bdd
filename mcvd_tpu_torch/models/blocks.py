"""NCSN++ building blocks on NCHW channels_last tensors (counterpart of
`mcvd_tpu/models/blocks.py`), the 2D branch: BigGAN and DDPM resblocks with
AdaGN or SPADE conditioning, multi-head attention, FIR up/down resampling.

Attribute names are upstream's (Conv_0, GroupNorm_0, NIN_0, Dense_0,
actnorm0, Norm_0, mlp_shared.0, Conv2d_0, ...), so upstream state dicts load
by name. The 3D and pseudo-3D families (`conv_mode` "3d", "pseudo3d") keep
the frames folded into the channels channel-major (c*N + n, the JAX
package's layout): their convs are `layers.Conv3d` and `layers.PseudoConv3d`
(`make_convs`), their norms group the N copies of a channel together
(`frames_last`), and their attention runs over space, then over time
(`AttnBlock3d`), or over both at once (`AttnBlock3dFull`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..parallel import draws as rng
from . import resample
from .layers import (NIN, Conv2d, Conv3d, GroupNorm, Linear, PseudoConv3d, UpDownConv2d,
                     nchw_unfold, nhwc_fold, num_groups_for)

FIR_KERNEL = (1, 3, 3, 1)

def nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize (B, C, H, W) to `size` by taking row floor(i*H/H_out) and
    column floor(j*W/W_out): `F.interpolate(mode="nearest")`, not
    "nearest-exact" (upstream layerspp.py:91, 166; the JAX package's
    `nearest_resize`)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")


def _dropout(h: torch.Tensor, rate: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout with the mask drawn from `generator` (torch's global one when
    None) in h's channels_last layout, as flax draws it from the step's
    dropout key: keep where U[0, 1) >= rate, kept values scaled by
    1/(1 - rate)."""
    if not training or rate == 0.0:
        return h
    B, C, H, W = h.shape
    u = rng.rand((B, H, W, C), generator, device=h.device).permute(0, 3, 1, 2)
    return h * (u >= rate).to(h.dtype) / (1.0 - rate)


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


def make_convs(mode: str, n_frames: int, act: bool = True):
    """(conv3x3, conv1x1) factories (in_planes, out_planes, init_scale=1.0)
    of a conv family, planes counted folded (the JAX package's
    `make_convs`): 2d `Conv2d`, 3d `layers.Conv3d`, pseudo3d
    `layers.PseudoConv3d` with SiLU between its space and time convs where
    `act`."""
    if mode == "2d":
        def conv(k):
            return lambda i, o, init_scale=1.0: Conv2d(i, o, k, init_scale=init_scale)
    elif mode == "3d":
        def conv(k):
            return lambda i, o, init_scale=1.0: Conv3d(i, o, k, n_frames,
                                                       init_scale=init_scale)
    elif mode == "pseudo3d":
        def conv(k):
            return lambda i, o, init_scale=1.0: PseudoConv3d(i, o, k, n_frames,
                                                             init_scale=init_scale, act=act)
    else:
        raise ValueError(f"conv mode {mode!r} is not 2d, 3d or pseudo3d")
    return conv(3), conv(1)


def _tokens_as_image(t: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, T, C) tokens, T = H*W, as a (B, C, H, W) channels_last image (a
    copy where `t` is a strided view, as the folded frames are at B=1)."""
    return t.reshape(t.shape[0], H, W, t.shape[2]).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


class AttnBlock3d(nn.Module):
    """Factorized attention over the folded layout (upstream layers3d.py
    AttnBlockpp3d, the JAX package's `AttnBlock3d`): `space_att` over the
    H*W tokens of each frame, then `time_att` over the N frames of each
    pixel, each an `AttnBlock` on the true channels C."""

    def __init__(self, channels: int, n_frames: int, init_scale: float = 0.0,
                 n_head_channels: int = -1):
        super().__init__()
        self.n_frames = n_frames
        C = channels // n_frames
        self.space_att = AttnBlock(C, init_scale, n_head_channels=n_head_channels)
        self.time_att = AttnBlock(C, init_scale, n_head_channels=n_head_channels)

    def forward(self, x):
        B, _, H, W = x.shape
        N = self.n_frames
        f = nhwc_fold(x, N).permute(0, 4, 1, 2, 3)                    # (B, N, H, W, C)
        C = f.shape[-1]
        h = self.space_att(_tokens_as_image(f.reshape(B * N, H * W, C), H, W))
        t = h.permute(0, 2, 3, 1).reshape(B, N, H, W, C).permute(0, 2, 3, 1, 4)
        h = self.time_att(_tokens_as_image(t.reshape(B * H * W, N, C), N, 1))
        return nchw_unfold(h.permute(0, 2, 3, 1).reshape(B, H, W, N, C).transpose(3, 4))


class AttnBlock3dFull(nn.Module):
    """Joint space-time attention over the folded layout (upstream
    layers3d.py AttnBlockpp3d_old, the JAX package's `AttnBlock3dFull`): one
    `AttnBlock` named `att` over all N*H*W tokens."""

    def __init__(self, channels: int, n_frames: int, init_scale: float = 0.0,
                 n_head_channels: int = -1):
        super().__init__()
        self.n_frames = n_frames
        self.att = AttnBlock(channels // n_frames, init_scale, n_head_channels=n_head_channels)

    def forward(self, x):
        B, _, H, W = x.shape
        N = self.n_frames
        f = nhwc_fold(x, N).permute(0, 4, 1, 2, 3)                    # (B, N, H, W, C)
        h = self.att(_tokens_as_image(f.reshape(B, N * H * W, f.shape[-1]), N * H, W))
        return nchw_unfold(h.permute(0, 2, 3, 1).reshape(B, N, H, W, -1)
                           .permute(0, 2, 3, 4, 1))


class MySPADE(nn.Module):
    """Spatially adaptive normalization (upstream layerspp.py:101-173):
    GroupNorm without affine at eps 1e-6 (one `gn_fused` call with no
    affine, no AdaGN and no act), then gamma and beta predicted by convs
    over the cond frames resized to x's size: mlp_shared (conv 3x3 + SiLU),
    mlp_gamma and mlp_beta (conv 3x3); out = n*(1 + gamma) + beta. The
    spatial gamma/beta cannot fold into the kernel's per-channel A*x + B,
    so that tail is PyTorch elementwise code, as it is XLA code beside the
    JAX package's norm.

    3D family (`is3d`, N = `n_frames`): the norm groups each channel's N
    frames; the segmap's `num_frames_cond` frames first map to N by
    `converter`, a 1x1 conv of the model's family with the image channels
    in the frame role (`conv1x1_cond`), and the mlp convs are the family's
    (`conv3x3`) over spade_dim // N * N folded channels."""

    def __init__(self, norm_nc: int, label_nc: int, spade_dim: int = 128,
                 is3d: bool = False, n_frames: int = 1, num_frames_cond: int = 0,
                 conv3x3=None, conv1x1_cond=None):
        super().__init__()
        self.norm_nc, self.is3d = norm_nc, is3d
        N = n_frames if is3d else 1
        self.n_frames, self.num_frames_cond = N, num_frames_cond
        conv3x3 = conv3x3 or (lambda i, o: Conv2d(i, o, 3))
        if is3d:
            img_ch = label_nc // num_frames_cond
            self.converter = conv1x1_cond(label_nc, img_ch * N)
            label_nc = img_ch * N
        hidden = spade_dim // N * N
        self.mlp_shared = nn.Sequential(conv3x3(label_nc, hidden), nn.SiLU())
        self.mlp_gamma = conv3x3(hidden, norm_nc * N)
        self.mlp_beta = conv3x3(hidden, norm_nc * N)

    def forward(self, x, segmap):
        N = self.n_frames
        normalized = ops.groupnorm.group_norm(x, num_groups_for(self.norm_nc), eps=1e-6,
                                              frames_last=N)
        if self.is3d:   # (C_img, Nc) -> (Nc, C_img) fold, frames Nc -> N, back
            seg = nchw_unfold(nhwc_fold(segmap, self.num_frames_cond).transpose(3, 4))
            segmap = nchw_unfold(nhwc_fold(self.converter(seg), seg.shape[1] //
                                           self.num_frames_cond).transpose(3, 4))
        actv = self.mlp_shared(nearest_resize(segmap, x.shape[2:]))
        gamma = self.mlp_gamma(actv)
        beta = self.mlp_beta(actv)
        return torch.addcmul(beta, normalized, 1 + gamma)


class ActNorm(nn.Module):
    """norm -> (AdaGN from temb) -> SiLU (upstream get_act_norm).

    group norm, all in one GroupNorm-kernel call: with emb, GroupNorm
    (affine=False) at eps 1e-5, Dense_0(SiLU(emb)) -> (scale, shift),
    x*(1+scale)+shift; without, affine Norm_0 at eps 1e-5.
    spade: Norm_0 is `MySPADE` over `cond`; with emb the AdaGN
    ·(1+scale)+shift follows it, then SiLU, in PyTorch elementwise code.
    3D family (`is3d`): `ch` counts folded channels, the norm groups each
    true channel's `n_frames` copies, and gamma/beta and scale/shift are
    per true channel, repeated over the frames."""

    def __init__(self, ch: int, emb_dim: Optional[int] = None, norm: str = "group",
                 is3d: bool = False, cond_ch: int = 0, spade_dim: int = 128,
                 n_frames: int = 1, num_frames_cond: int = 0, conv3x3=None,
                 conv1x1_cond=None):
        super().__init__()
        if norm not in ("group", "spade"):
            raise ValueError(f"ActNorm norm={norm!r} is not group or spade")
        self.N = n_frames if is3d else 1
        self.ch = ch // self.N    # true channels
        self.norm = norm
        if emb_dim is not None:
            self.Dense_0 = Linear(emb_dim, 2 * self.ch)
        if norm == "spade":
            self.Norm_0 = MySPADE(self.ch, cond_ch, spade_dim, is3d=is3d, n_frames=n_frames,
                                  num_frames_cond=num_frames_cond, conv3x3=conv3x3,
                                  conv1x1_cond=conv1x1_cond)
        elif emb_dim is None:
            self.Norm_0 = GroupNorm(self.ch, eps=1e-5, frames_last=self.N)

    def _scale_shift(self, emb):
        scale, shift = self.Dense_0(F.silu(emb)).chunk(2, dim=1)
        if self.N > 1:
            scale, shift = (t.repeat_interleave(self.N, dim=1) for t in (scale, shift))
        return scale, shift

    def forward(self, x, emb=None, cond=None):
        if self.norm == "spade":
            h = self.Norm_0(x, cond)
            if emb is not None:
                scale, shift = self._scale_shift(emb)
                h = torch.addcmul(shift[:, :, None, None], h, 1 + scale[:, :, None, None])
            return F.silu(h)
        if emb is None:
            return self.Norm_0(x, act=True)
        scale, shift = self._scale_shift(emb)
        return ops.groupnorm.group_norm(
            x, num_groups_for(self.ch), eps=1e-5, scale=scale, shift=shift,
            frames_last=self.N, act=True)


class Upsample(nn.Module):
    """x2 upsampling (upstream layerspp.py:250-282): the fused FIR conv
    `Conv2d_0` (fir, with_conv), the FIR alone (fir), or nearest neighbour
    then `Conv_0` 3x3 (not fir; the conv only with with_conv)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = True,
                 fir: bool = True, fir_kernel=FIR_KERNEL):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, list(fir_kernel)
        if not fir and with_conv:
            self.Conv_0 = Conv2d(in_ch, out_ch, 3)
        elif fir and with_conv:
            self.Conv2d_0 = UpDownConv2d(in_ch, out_ch, 3, up=True, resample_kernel=fir_kernel)

    def forward(self, x, temb=None, cond=None, generator=None):
        """x2 up; takes a resblock's arguments and ignores all but x."""
        if not self.fir:
            h = resample.naive_upsample_2d(x)
            return self.Conv_0(h) if self.with_conv else h
        if not self.with_conv:
            return resample.upsample_2d(x, self.fir_kernel, factor=2)
        return self.Conv2d_0(x)


class Downsample(nn.Module):
    """x2 downsampling (upstream layerspp.py:285-319): the fused FIR conv
    `Conv2d_0` (fir, with_conv), the FIR alone (fir), a (0, 1, 0, 1) pad then
    the stride-2 VALID 3x3 `Conv_0` (not fir, with_conv), or a 2x2 mean."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = True,
                 fir: bool = True, fir_kernel=FIR_KERNEL):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, list(fir_kernel)
        if not fir and with_conv:
            self.Conv_0 = Conv2d(in_ch, out_ch, 3, stride=2, padding=0)
        elif fir and with_conv:
            self.Conv2d_0 = UpDownConv2d(in_ch, out_ch, 3, down=True,
                                         resample_kernel=fir_kernel)

    def forward(self, x, temb=None, cond=None, generator=None):
        """x2 down; takes a resblock's arguments and ignores all but x."""
        if not self.fir:
            if self.with_conv:
                return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
            return resample.naive_downsample_2d(x)
        if not self.with_conv:
            return resample.downsample_2d(x, self.fir_kernel, factor=2)
        return self.Conv2d_0(x)


def _norm_kwargs(conv_mode, norm, cond_ch, spade_dim, n_frames, num_frames_cond, conv3x3,
                 act3d):
    """`ActNorm`'s arguments in a resblock of `conv_mode` (the JAX blocks'
    spade_kwargs: SPADE's converter is a 1x1 conv of the family with the
    image channels as its frames)."""
    kw = dict(norm=norm, cond_ch=cond_ch, spade_dim=spade_dim, is3d=conv_mode != "2d",
              n_frames=n_frames)
    if norm == "spade":
        img_ch = cond_ch // max(num_frames_cond, 1)
        kw.update(num_frames_cond=num_frames_cond, conv3x3=conv3x3,
                  conv1x1_cond=make_convs(conv_mode, img_ch, act3d)[1])
    return kw


class ResnetBlockBigGAN(nn.Module):
    """actnorm0 -> [FIR (1,3,3,1) up/down] -> Conv_0 -> actnorm1 -> dropout
    -> Conv_1 (init 0) -> (+ Conv_2 1x1 shortcut) / sqrt(2)
    (upstream ResnetBlockBigGANppGN, or ...SPADE with norm="spade", with fir
    and skip_rescale, as NCSN++ builds it).

    In training mode the dropout mask is drawn from `generator` (the train
    step's explicit one; torch's global generator when None), see
    `_dropout`."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, up: bool = False, down: bool = False,
                 dropout: float = 0.1, init_scale: float = 0.0, conv_mode: str = "2d",
                 norm: str = "group", cond_ch: int = 0, spade_dim: int = 128,
                 n_frames: int = 1, num_frames_cond: int = 0, act3d: bool = True):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        conv3x3, conv1x1 = make_convs(conv_mode, n_frames, act3d)
        norm_kw = _norm_kwargs(conv_mode, norm, cond_ch, spade_dim, n_frames,
                               num_frames_cond, conv3x3, act3d)
        self.actnorm0 = ActNorm(in_ch, temb_dim, **norm_kw)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        self.actnorm1 = ActNorm(out_ch, temb_dim, **norm_kw)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        self.Conv_2 = (conv1x1(in_ch, out_ch)
                       if in_ch != out_ch or up or down else None)

    def forward(self, x, temb=None, cond=None, generator=None):
        h = self.actnorm0(x, temb, cond)
        if self.up:
            h = resample.upsample_2d(h, FIR_KERNEL, factor=2)
            x = resample.upsample_2d(x, FIR_KERNEL, factor=2)
        elif self.down:
            h = resample.downsample_2d(h, FIR_KERNEL, factor=2)
            x = resample.downsample_2d(x, FIR_KERNEL, factor=2)
        h = self.Conv_0(h)
        h = self.actnorm1(h, temb, cond)
        h = _dropout(h, self.Dropout_0.p, self.training, generator)
        h = self.Conv_1(h)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return (x + h) / math.sqrt(2.0)


class ResnetBlockDDPM(nn.Module):
    """act(GroupNorm_0) -> Conv_0 -> (+ Dense_0(act(temb))) ->
    act(GroupNorm_1) -> dropout -> Conv_1 (init `init_scale`) -> (+ Conv_2
    3x3 or NIN_0 shortcut where the width changes) [/ sqrt(2)] (upstream
    ResnetBlockDDPMpp, or ...SPADE with norm="spade"). The group norm is
    affine at eps 1e-6 with the SiLU fused, one `gn_fused` call; the spade
    norm is `MySPADE` over `cond`, then SiLU. Dropout as
    `ResnetBlockBigGAN`'s."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, conv_shortcut: bool = False,
                 dropout: float = 0.1, skip_rescale: bool = False, init_scale: float = 0.0,
                 conv_mode: str = "2d", norm: str = "group", cond_ch: int = 0,
                 spade_dim: int = 128, n_frames: int = 1, num_frames_cond: int = 0,
                 act3d: bool = False):
        super().__init__()
        if norm not in ("group", "spade"):
            raise ValueError(f"ResnetBlockDDPM norm={norm!r} is not group or spade")
        out_ch = out_ch or in_ch
        self.spade = norm == "spade"
        self.skip_rescale = skip_rescale
        conv3x3, _ = make_convs(conv_mode, n_frames, act3d)
        N = n_frames if conv_mode != "2d" else 1
        norm_kw = _norm_kwargs(conv_mode, norm, cond_ch, spade_dim, n_frames,
                               num_frames_cond, conv3x3, act3d)

        def norm_layer(ch):
            if self.spade:
                return MySPADE(ch // N, cond_ch, spade_dim, is3d=conv_mode != "2d",
                               n_frames=n_frames, num_frames_cond=num_frames_cond,
                               conv3x3=conv3x3, conv1x1_cond=norm_kw.get("conv1x1_cond"))
            return GroupNorm(ch // N, eps=1e-6, frames_last=N)

        self.GroupNorm_0 = norm_layer(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Linear(temb_dim, out_ch)
        self.GroupNorm_1 = norm_layer(out_ch)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def _act_norm(self, norm, h, cond):
        if self.spade:
            return F.silu(norm(h, cond))
        return norm(h, act=True)

    def forward(self, x, temb=None, cond=None, generator=None):
        h = self._act_norm(self.GroupNorm_0, x, cond)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(F.silu(temb))[:, :, None, None]
        h = self._act_norm(self.GroupNorm_1, h, cond)
        h = _dropout(h, self.Dropout_0.p, self.training, generator)
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        if not self.skip_rescale:
            return x + h
        return (x + h) / math.sqrt(2.0)
