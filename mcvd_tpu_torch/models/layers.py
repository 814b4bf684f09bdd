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
from . import resample


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
    """kxk conv with DDPM init: stride 1 and 'same' padding (JAX
    `Conv2dSame`) unless `stride` and `padding` say otherwise."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, *,
                 init_scale: float = 1.0, bias: bool = True, stride: int = 1,
                 padding: Optional[int] = None):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding, bias=bias)
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


class UpDownConv2d(nn.Module):
    """StyleGAN2 conv with the FIR up/down resampling fused in (upstream
    up_or_down_sampling.Conv2d; the JAX package's `blocks.UpDownConv2d`):
    `weight` (O, I, k, k) with DDPM init and `bias` (O,), as upstream stores
    them."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, up: bool = False,
                 down: bool = False, resample_kernel=(1, 3, 3, 1), use_bias: bool = True):
        super().__init__()
        self.up, self.down = up, down
        self.resample_kernel = list(resample_kernel)
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        self.init_scale = 1.0

    def forward(self, x):
        if self.up:
            x = resample.upsample_conv_2d(x, self.weight, k=self.resample_kernel)
        elif self.down:
            x = resample.conv_downsample_2d(x, self.weight, k=self.resample_kernel)
        else:
            x = F.conv2d(x, self.weight, padding=self.weight.shape[-1] // 2)
        if self.bias is not None:
            x = x + self.bias.view(1, -1, 1, 1)
        return x


class LegacyNin(nn.Module):
    """The legacy UNet's per-pixel channel map on a channels-last tensor
    (..., in) -> (..., out), `weights` (out, in) as upstream stores it
    (upstream models/unet.py:49-58)."""

    def __init__(self, in_ch: int, out_ch: int, init_scale: float = 1.0):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(out_ch, in_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.init_scale = init_scale

    def forward(self, x):
        return torch.addmm(self.bias, x.reshape(-1, x.shape[-1]), self.weights.t()).view(
            *x.shape[:-1], -1)


# ------------------------------------------------- the 3D family's folded convs
#
# The 3D family folds N frames into the channel axis channel-major: channel
# c*N + n of (B, C*N, H, W) is channel c of frame n (the JAX package's
# `blocks.py` layout note). In channels_last memory that is (B, H, W, C, N).

def nhwc_fold(x: torch.Tensor, N: int) -> torch.Tensor:
    """(B, C*N, H, W) channel-major -> (B, H, W, C, N)."""
    B, CN, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H, W, CN // N, N)


def nchw_unfold(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C, N) -> (B, C*N, H, W), stored channels_last (a copy where
    the reshape's view is not, as for a conv's NCDHW output at B=1)."""
    B, H, W, C, N = x.shape
    return x.reshape(B, H, W, C * N).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


class _ZeroInit:
    """A torch conv built with zeros (construction draws nothing), its
    weights drawn later by `init_weights` at `init_scale`."""

    def __init__(self, *args, init_scale: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.init_scale = init_scale

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class _Conv3d(_ZeroInit, nn.Conv3d):
    pass


class _Conv1d(_ZeroInit, nn.Conv1d):
    pass


class Conv3d(nn.Module):
    """True 3D conv over the folded frames (upstream layers3d.py MyConv3d,
    the JAX package's `Conv3dFolded`): (B, Cin*N, H, W) -> (B, Cout*N, H, W),
    'same' padding; `conv` is the nn.Conv3d, weight (O, I, kd, kh, kw), as
    upstream names it."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int, n_frames: int, *,
                 init_scale: float = 1.0):
        super().__init__()
        self.n_frames = n_frames
        self.conv = _Conv3d(in_planes // n_frames, out_planes // n_frames, kernel,
                            padding=kernel // 2, init_scale=init_scale)

    def forward(self, x):
        x5 = nhwc_fold(x, self.n_frames).permute(0, 3, 4, 1, 2)   # (B, C, N, H, W)
        y = self.conv(x5.contiguous(memory_format=torch.channels_last_3d))
        return nchw_unfold(y.permute(0, 3, 4, 1, 2))


class PseudoConv3d(nn.Module):
    """Factorized 3D conv (upstream layers3d.py PseudoConv3d, the JAX
    package's `PseudoConv3dFolded`): `space_conv` (Conv2d) on each frame,
    SiLU where `act`, then `time_conv` (Conv1d, weight (O, I, k)) along the
    frames of each pixel."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int, n_frames: int, *,
                 init_scale: float = 1.0, act: bool = True):
        super().__init__()
        self.n_frames, self.act = n_frames, act
        cin, cout = in_planes // n_frames, out_planes // n_frames
        self.space_conv = Conv2d(cin, cout, kernel, init_scale=init_scale)
        self.time_conv = _Conv1d(cout, cout, kernel, padding=kernel // 2,
                                 init_scale=init_scale)

    def forward(self, x):
        B, _, H, W = x.shape
        N = self.n_frames
        f = nhwc_fold(x, N).permute(0, 4, 1, 2, 3)                 # (B, N, H, W, C)
        h = self.space_conv(f.reshape(B * N, H, W, -1).permute(0, 3, 1, 2))
        if self.act:
            h = F.silu(h)
        C = h.shape[1]
        t = h.permute(0, 2, 3, 1).reshape(B, N, H, W, C).permute(0, 2, 3, 4, 1)
        t = self.time_conv(t.reshape(B * H * W, C, N))             # (B*H*W, C, N)
        return nchw_unfold(t.reshape(B, H, W, C, N))


class FrameConverter(nn.Module):
    """1x1 map over the frame axis, (B, C*Nin, H, W) -> (B, C*Nout, H, W)
    (upstream's conv1x1 frame converters, ncsnpp_more.py:215-218, 327-334):
    `weight` (Nout, Nin, 1, 1) and `bias` (Nout,) as upstream stores them."""

    def __init__(self, n_in: int, n_out: int, init_scale: float = 1.0):
        super().__init__()
        self.n_in = n_in
        self.weight = nn.Parameter(torch.zeros(n_out, n_in, 1, 1))
        self.bias = nn.Parameter(torch.zeros(n_out))
        self.init_scale = init_scale

    def forward(self, x):
        f = nhwc_fold(x, self.n_in)
        return nchw_unfold(torch.matmul(f, self.weight[:, :, 0, 0].t()) + self.bias)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight of `module` in `modules()` order from `generator`
    (CPU). Biases and GroupNorm shifts are zero, GroupNorm scales one, the
    cond-mask embedding N(0, 1). A module with a `draw_weights(generator)`
    method draws its own (the legacy ncsn norms and dilated convs)."""
    for m in module.modules():
        if hasattr(m, "draw_weights"):
            m.draw_weights(generator)
        elif isinstance(m, (Conv2d, Linear, UpDownConv2d, FrameConverter, _ZeroInit)):
            default_init_(m.weight, m.init_scale, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, LegacyNin):
            default_init_(m.weights, m.init_scale, generator)
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
    version of the GroupNorm kernel. Stats in fp32 (fp64 for fp64 x) as
    E[x^2]-mean^2; channel index c*N+n (channel-major frame fold) belongs to
    the group of c, so a group is a contiguous run of (C/G)*N channels. The
    tail folds into one per-(b, channel) y = A*x + B, then SiLU. Returns (y,
    A, B)."""
    B, CN = x.shape[0], x.shape[1]
    G = num_groups
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct)
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
        g = gamma.to(ct).repeat_interleave(frames_last)
        b = beta.to(ct).repeat_interleave(frames_last)
        A = A * g
        Bc = Bc * g + b
    if scale is not None:
        e = 1.0 + scale.to(ct)
        A = A * e
        Bc = Bc * e + shift.to(ct)
    bshape = (B, CN) + (1,) * (x.ndim - 2)
    y = xf * A.view(bshape) + Bc.view(bshape)
    if act:
        y = F.silu(y)
    return y.to(x.dtype), A, Bc


class GroupNorm(nn.Module):
    """Affine GroupNorm over NCHW with an optional fused SiLU, through the
    GroupNorm kernel (`ops.groupnorm.group_norm`): `num_groups` groups
    (`num_groups_for(channels)` by default) over `channels` true channels,
    each folded `frames_last` times channel-major. (The AdaGN norms have no
    affine and call the kernel directly, from `blocks.ActNorm`.)"""

    def __init__(self, channels: int, eps: float = 1e-6, num_groups: Optional[int] = None,
                 frames_last: int = 1):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.num_groups = num_groups or num_groups_for(channels)
        self.frames_last = frames_last
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, act: bool = False):
        return ops.groupnorm.group_norm(
            x, self.num_groups, eps=self.eps, gamma=self.weight, beta=self.bias,
            frames_last=self.frames_last, act=act)
