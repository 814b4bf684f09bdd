"""NCSN++ score network (counterpart of `mcvd_tpu/models/ncsnpp.py`;
upstream models/better/ncsnpp_more.py): 2D (`arch: unetmore`), 3D
(`unetmore3d`) and pseudo-3D (`unetmorepseudo3d`), with channel-concat
conditioning or SPADE (`model.spade`), BigGAN or DDPM resblocks
(`model.resblock_type`), and the DDPM wrapper's `noise_in_cond`.

The network takes NCHW tensors with frames folded into channels frame-major
(f*C + c): x (B, num_frames*C, H, W) and cond (B, cond_frames*C, H, W),
concatenated as [x, cond], or with SPADE fed to every norm. It stores them
channels_last, whose memory is the JAX package's (B, H, W, F*C). Submodules
sit in upstream's `all_modules` order, so upstream checkpoints
(`unet.all_modules.{i}...`) load by name.

The 3D family reorders the folded frames channel-major (c*N + n) on the way
in and back on the way out, exactly as the JAX package does
(`_frame_reorder_in`, `_frame_reorder_out`), counts its widths folded
(nf = ngf*N), concatenates skips along the true channel axis
(`_concat_channel_major`) and, with concat conditioning, maps the skips and
the middle from the cond+pred frames to the predicted ones with
`FrameConverter`s.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion.schedules import get_sigmas, make_schedule
from ..parallel import draws as rng
from . import blocks
from .layers import FrameConverter, Linear, get_timestep_embedding, nchw_unfold, nhwc_fold

ARCHS = ("unetmore", "unetmore3d", "unetmorepseudo3d")


def _frame_reorder_in(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, N*C, H, W) frame-major -> (B, C*N, H, W) channel-major."""
    return nchw_unfold(nhwc_fold(x, x.shape[1] // n_frames).transpose(3, 4))


def _frame_reorder_out(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, C*N, H, W) channel-major -> (B, N*C, H, W) frame-major."""
    return nchw_unfold(nhwc_fold(x, n_frames).transpose(3, 4))


def _concat_channel_major(h: torch.Tensor, prev: torch.Tensor, n_frames: int):
    """Concat two channel-major folded tensors along the true channel axis
    (upstream ncsnpp_more.py:344-354, a cat of (B, C, N, H, W) on dim 1)."""
    return nchw_unfold(torch.cat([nhwc_fold(h, n_frames), nhwc_fold(prev, n_frames)], dim=3))


class NCSNpp(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        arch = getattr(config.model, "arch", "unetmore")
        if arch not in ARCHS:
            raise ValueError(f"NCSNpp: arch {arch!r} not in {ARCHS}")
        self.is3d = is3d = arch != "unetmore"
        self.conv_mode = conv_mode = {"unetmore3d": "3d", "unetmorepseudo3d": "pseudo3d"}.get(
            arch, "2d")
        self.spade = spade = bool(getattr(config.model, "spade", False))
        self.resblock_type = resblock_type = getattr(config.model, "resblock_type", "biggan")
        if resblock_type not in ("biggan", "ddpm"):
            raise ValueError(f"resblock type {resblock_type} unrecognized.")

        self.channels = channels = config.data.channels
        self.num_frames = num_frames = config.data.num_frames
        self.num_frames_cond = num_frames_cond = config.data.num_frames_cond + getattr(
            config.data, "num_frames_future", 0)
        # SPADE processes only the predicted frames; cond goes to every norm
        self.n_frames = n_frames = num_frames if spade else num_frames + num_frames_cond
        ngf = config.model.ngf
        self.nf = nf = ngf * n_frames if is3d else ngf
        numf = ngf * num_frames if is3d else ngf
        # the up path's frames: with concat conditioning the 3D family drops
        # the cond frames at the middle (FrameConverter)
        self.up_frames = up_frames = num_frames if is3d and not spade else n_frames
        ch_mult = config.model.ch_mult
        self.num_res_blocks = num_res_blocks = config.model.num_res_blocks
        self.attn_resolutions = attn_resolutions = config.model.attn_resolutions
        dropout = getattr(config.model, "dropout", 0.0)
        self.num_resolutions = num_resolutions = len(ch_mult)
        self.all_resolutions = all_resolutions = [
            config.data.image_size // (2**i) for i in range(num_resolutions)]
        self.conditional = getattr(config.model, "time_conditional", True)
        self.use_cond_emb = bool(getattr(config.model, "cond_emb", False))
        self.output_all_frames = bool(getattr(config.model, "output_all_frames", False))
        n_head_channels = getattr(config.model, "n_head_channels", -1)
        spade_dim = getattr(config.model, "spade_dim", 128)
        cond_ch = num_frames_cond * channels
        init_scale = 0.0

        modules: List[nn.Module] = []
        temb_dim = None
        if self.conditional:
            modules.append(Linear(nf, nf * 4))
            modules.append(Linear(nf * 4, nf * 4))
            temb_dim = nf * 4
            if self.use_cond_emb:
                modules.append(nn.Embedding(2, nf // 2))
                temb_dim += nf // 2

        conv3x3, _ = blocks.make_convs(conv_mode, n_frames)
        conv3x3_last, _ = blocks.make_convs(conv_mode, num_frames)
        if is3d:
            attn3d = (blocks.AttnBlock3dFull if getattr(config.model, "full3d_attn", False)
                      else blocks.AttnBlock3d)
            AttnDown = functools.partial(attn3d, n_frames=n_frames, init_scale=init_scale,
                                         n_head_channels=n_head_channels)
            AttnUp = functools.partial(attn3d, n_frames=up_frames, init_scale=init_scale,
                                       n_head_channels=n_head_channels)
        else:
            AttnDown = AttnUp = functools.partial(blocks.AttnBlock, init_scale=init_scale,
                                                  n_head_channels=n_head_channels)
        res_kwargs = dict(dropout=dropout, init_scale=init_scale, temb_dim=temb_dim,
                          conv_mode=conv_mode, act3d=True)
        if spade:
            res_kwargs.update(norm="spade", cond_ch=cond_ch, spade_dim=spade_dim,
                              num_frames_cond=num_frames_cond)
        if resblock_type == "ddpm":
            Res = functools.partial(blocks.ResnetBlockDDPM, skip_rescale=True, **res_kwargs)
        else:
            Res = functools.partial(blocks.ResnetBlockBigGAN, **res_kwargs)
        ResDown = functools.partial(Res, n_frames=n_frames)
        ResUp = functools.partial(Res, n_frames=up_frames)
        converts = is3d and not spade

        # Down
        modules.append(conv3x3(channels * n_frames, nf))
        hs_c = [nf]
        in_ch = nf
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                modules.append(ResDown(in_ch=in_ch, out_ch=out_ch))
                in_ch = out_ch
                if all_resolutions[i_level] in attn_resolutions:
                    modules.append(AttnDown(channels=in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                if resblock_type == "ddpm":
                    modules.append(blocks.Downsample(in_ch=in_ch))
                else:
                    modules.append(ResDown(down=True, in_ch=in_ch))
                hs_c.append(in_ch)

        # Middle
        in_ch = hs_c[-1]
        modules.append(ResDown(in_ch=in_ch))
        modules.append(AttnDown(channels=in_ch))
        if converts:
            modules.append(FrameConverter(n_frames, num_frames))
            in_ch = in_ch * num_frames // n_frames
        modules.append(ResUp(in_ch=in_ch))

        # Up
        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = (numf if converts else nf) * ch_mult[i_level]
                skip_ch = hs_c.pop()
                if converts:
                    modules.append(FrameConverter(n_frames, num_frames))
                    skip_ch = skip_ch * num_frames // n_frames
                modules.append(ResUp(in_ch=in_ch + skip_ch, out_ch=out_ch))
                in_ch = out_ch
            if all_resolutions[i_level] in attn_resolutions:
                modules.append(AttnUp(channels=in_ch))
            if i_level != 0:
                if resblock_type == "ddpm":
                    modules.append(blocks.Upsample(in_ch=in_ch))
                else:
                    modules.append(ResUp(in_ch=in_ch, up=True))
        assert not hs_c

        # Output head
        norm_kw = dict(is3d=is3d, n_frames=up_frames)
        if spade:
            norm_kw.update(norm="spade", cond_ch=cond_ch, spade_dim=spade_dim,
                           num_frames_cond=num_frames_cond, conv3x3=conv3x3,
                           conv1x1_cond=blocks.make_convs(conv_mode, channels)[1])
        modules.append(blocks.ActNorm(in_ch, **norm_kw))
        modules.append(conv3x3_last(in_ch, channels * num_frames, init_scale=init_scale))
        self.all_modules = nn.ModuleList(modules)
        self.register_buffer("sigmas", torch.from_numpy(get_sigmas(config).copy()))

    def forward(self, x, time_cond, cond=None, cond_mask=None, dropout_generator=None):
        """`dropout_generator` draws the resblocks' dropout masks in training
        mode (`blocks.ResnetBlockBigGAN`)."""
        modules = self.all_modules
        m_idx = 0
        gen = dropout_generator
        spade_cond = None
        if cond is not None and self.spade:
            spade_cond = cond.contiguous(memory_format=torch.channels_last)
        elif cond is not None:
            x = torch.cat([x, cond], dim=1)
        x = x.contiguous(memory_format=torch.channels_last)
        if self.is3d:
            x = _frame_reorder_in(x, self.n_frames)
            if spade_cond is not None:
                spade_cond = _frame_reorder_in(spade_cond, self.num_frames_cond)

        temb = None
        if self.conditional:
            # sinusoid in fp32, then the compute dtype (bf16 stays bf16 after)
            temb = get_timestep_embedding(time_cond, self.nf).to(x.dtype)
            temb = modules[m_idx](temb)
            m_idx += 1
            temb = modules[m_idx](F.silu(temb))
            m_idx += 1
            if self.use_cond_emb:
                if cond_mask is None:
                    cond_mask = torch.ones(x.shape[0], dtype=torch.long, device=x.device)
                temb = torch.cat([temb, modules[m_idx](cond_mask.long())], dim=1)
                m_idx += 1

        # Down
        hs = [modules[m_idx](x)]
        m_idx += 1
        for i_level in range(self.num_resolutions):
            for _ in range(self.num_res_blocks):
                h = modules[m_idx](hs[-1], temb, spade_cond, gen)
                m_idx += 1
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    h = modules[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != self.num_resolutions - 1:
                hs.append(modules[m_idx](hs[-1], temb, spade_cond, gen))
                m_idx += 1

        # Middle
        converts = self.is3d and not self.spade
        h = modules[m_idx](hs[-1], temb, spade_cond, gen)
        h = modules[m_idx + 1](h)
        m_idx += 2
        if converts:
            h = modules[m_idx](h)
            m_idx += 1
        h = modules[m_idx](h, temb, spade_cond, gen)
        m_idx += 1

        # Up
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                prev = hs.pop()
                if converts:
                    prev = modules[m_idx](prev)
                    m_idx += 1
                if self.is3d:
                    h_comb = _concat_channel_major(h, prev, self.up_frames)
                else:
                    h_comb = torch.cat([h, prev], dim=1)
                h = modules[m_idx](h_comb, temb, spade_cond, gen)
                m_idx += 1
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = modules[m_idx](h)
                m_idx += 1
            if i_level != 0:
                h = modules[m_idx](h, temb, spade_cond, gen)
                m_idx += 1
        assert not hs

        # Output head
        h = modules[m_idx](h, None, spade_cond) if self.spade else modules[m_idx](h)
        h = modules[m_idx + 1](h)
        m_idx += 2
        assert m_idx == len(modules)

        if self.output_all_frames and cond is not None and not self.spade:
            h = h[:, self.num_frames_cond * self.channels:]
        if self.is3d:
            h = _frame_reorder_out(h, self.num_frames)
        return h


class UNetMoreDDPM(nn.Module):
    """DDPM wrapper (upstream UNetMore_DDPM): the schedule tables as the
    buffers `betas`, `alphas`, `alphas_prev`, and the score network as `unet`.

    With `model.noise_in_cond`, cond is diffused to the noise level of the
    labels before the network sees it: sqrt(a) cond + sqrt(1 - a) z with a
    = alphas[y], and z from the explicit draw `cond_noise` (cond's shape):
    N(0, 1), or with `model.gamma` a Gamma(k_cum[y], 1) draw, centred and
    scaled as (g - k) theta / sqrt(1 - a). `draw_cond_noise` makes it from a
    generator. The JAX package takes an rng there instead, and raises
    without one, as this raises without the draw."""

    def __init__(self, config):
        super().__init__()
        self.version = getattr(config.model, "version", "DDPM").upper()
        if self.version not in ("DDPM", "DDIM", "FPNDM"):
            raise ValueError(f"UNetMoreDDPM: version {self.version} is not DDPM-family")
        self.noise_in_cond = bool(getattr(config.model, "noise_in_cond", False))
        self.gamma = bool(getattr(config.model, "gamma", False))
        self.unet = NCSNpp(config)
        sched = make_schedule(config)
        for name in ("betas", "alphas", "alphas_prev"):
            self.register_buffer(name, torch.from_numpy(getattr(sched, name).copy()))
        if self.gamma:   # not upstream's buffers: kept out of the state dict
            for name in ("k_cum", "theta_t"):
                self.register_buffer(name, torch.from_numpy(getattr(sched, name).copy()),
                                     persistent=False)

    def forward(self, x, y, cond=None, cond_mask=None, dropout_generator=None,
                cond_noise: Optional[torch.Tensor] = None):
        if self.noise_in_cond and cond is not None:
            if cond_noise is None:
                raise ValueError("noise_in_cond needs the cond-noise draw (draw_cond_noise)")
            shape = (cond.shape[0],) + (1,) * (cond.ndim - 1)
            used = self.alphas[y].view(shape)
            z = cond_noise.float()
            if self.gamma:
                k, theta = self.k_cum[y].view(shape), self.theta_t[y].view(shape)
                z = (z * theta - k * theta) / torch.sqrt(1.0 - used)
            cond = (torch.sqrt(used) * cond.float() + torch.sqrt(1.0 - used) * z).to(cond.dtype)
        return self.unet(x, y, cond, cond_mask, dropout_generator)


def draw_cond_noise(config, sched, labels: torch.Tensor, cond: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """The `noise_in_cond` draw for cond (its shape, fp32, on its device) at
    the noise levels `labels`: N(0, 1), or with `model.gamma` Gamma(k_cum[y],
    1) per example, from `generator`."""
    if generator is None:
        raise ValueError("draw_cond_noise needs a torch.Generator")
    if not getattr(config.model, "gamma", False):
        return rng.randn(cond.shape, generator, device=cond.device)
    k = torch.as_tensor(sched.k_cum, device=cond.device)[labels.to(cond.device)]
    k = k.view((cond.shape[0],) + (1,) * (cond.ndim - 1)).expand(cond.shape)
    return rng.standard_gamma(k.contiguous(), generator)
