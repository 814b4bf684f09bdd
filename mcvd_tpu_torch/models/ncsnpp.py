"""NCSN++ score network, 2D channel-concat branch (counterpart of
`mcvd_tpu/models/ncsnpp.py`; upstream models/better/ncsnpp_more.py).

The network takes NCHW tensors with frames folded into channels frame-major
(f*C + c): x (B, num_frames*C, H, W) and cond (B, cond_frames*C, H, W),
concatenated as [x, cond]. It stores them channels_last, whose memory is the
JAX package's (B, H, W, F*C). Submodules sit in upstream's `all_modules`
order, so upstream checkpoints (`unet.all_modules.{i}...`) load by name.
"""

from __future__ import annotations

import functools
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion.schedules import get_sigmas, make_schedule
from . import blocks
from .layers import Conv2d, Linear, get_timestep_embedding

_LATER = "not ported yet (ROADMAP Queue 1 item 13: model variants)"


class NCSNpp(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        arch = getattr(config.model, "arch", "unetmore")
        if arch != "unetmore":
            raise NotImplementedError(f"arch {arch!r}: {_LATER}")
        if getattr(config.model, "spade", False):
            raise NotImplementedError(f"SPADE conditioning: {_LATER}")
        resblock_type = getattr(config.model, "resblock_type", "biggan")
        if resblock_type != "biggan":
            raise NotImplementedError(f"resblock_type {resblock_type!r}: {_LATER}")

        self.channels = channels = config.data.channels
        self.num_frames = num_frames = config.data.num_frames
        self.num_frames_cond = num_frames_cond = config.data.num_frames_cond + getattr(
            config.data, "num_frames_future", 0)
        self.n_frames = num_frames + num_frames_cond
        self.nf = nf = config.model.ngf
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

        Attn = functools.partial(blocks.AttnBlock, init_scale=init_scale,
                                 n_head_channels=n_head_channels)
        Res = functools.partial(blocks.ResnetBlockBigGAN, dropout=dropout,
                                init_scale=init_scale, temb_dim=temb_dim)

        # Down
        modules.append(Conv2d(channels * self.n_frames, nf, 3))
        hs_c = [nf]
        in_ch = nf
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                modules.append(Res(in_ch=in_ch, out_ch=out_ch))
                in_ch = out_ch
                if all_resolutions[i_level] in attn_resolutions:
                    modules.append(Attn(channels=in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                modules.append(Res(down=True, in_ch=in_ch))
                hs_c.append(in_ch)

        # Middle
        in_ch = hs_c[-1]
        modules.append(Res(in_ch=in_ch))
        modules.append(Attn(channels=in_ch))
        modules.append(Res(in_ch=in_ch))

        # Up
        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                modules.append(Res(in_ch=in_ch + hs_c.pop(), out_ch=out_ch))
                in_ch = out_ch
            if all_resolutions[i_level] in attn_resolutions:
                modules.append(Attn(channels=in_ch))
            if i_level != 0:
                modules.append(Res(in_ch=in_ch, up=True))
        assert not hs_c

        # Output head
        modules.append(blocks.ActNorm(in_ch))
        modules.append(Conv2d(in_ch, channels * num_frames, 3, init_scale=init_scale))
        self.all_modules = nn.ModuleList(modules)
        self.register_buffer("sigmas", torch.from_numpy(get_sigmas(config).copy()))

    def forward(self, x, time_cond, cond=None, cond_mask=None, dropout_generator=None):
        """`dropout_generator` draws the resblocks' dropout masks in training
        mode (`blocks.ResnetBlockBigGAN`)."""
        modules = self.all_modules
        m_idx = 0
        gen = dropout_generator
        if cond is not None:
            x = torch.cat([x, cond], dim=1)
        x = x.contiguous(memory_format=torch.channels_last)

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
                h = modules[m_idx](hs[-1], temb, gen)
                m_idx += 1
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    h = modules[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != self.num_resolutions - 1:
                hs.append(modules[m_idx](hs[-1], temb, gen))
                m_idx += 1

        # Middle
        h = modules[m_idx](hs[-1], temb, gen)
        h = modules[m_idx + 1](h)
        h = modules[m_idx + 2](h, temb, gen)
        m_idx += 3

        # Up
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = modules[m_idx](torch.cat([h, hs.pop()], dim=1), temb, gen)
                m_idx += 1
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = modules[m_idx](h)
                m_idx += 1
            if i_level != 0:
                h = modules[m_idx](h, temb, gen)
                m_idx += 1
        assert not hs

        # Output head
        h = modules[m_idx](h)
        h = modules[m_idx + 1](h)
        m_idx += 2
        assert m_idx == len(modules)

        if self.output_all_frames and cond is not None:
            h = h[:, self.num_frames_cond * self.channels:]
        return h


class UNetMoreDDPM(nn.Module):
    """DDPM wrapper (upstream UNetMore_DDPM): the schedule tables as the
    buffers `betas`, `alphas`, `alphas_prev`, and the score network as `unet`."""

    def __init__(self, config):
        super().__init__()
        self.version = getattr(config.model, "version", "DDPM").upper()
        if self.version not in ("DDPM", "DDIM", "FPNDM"):
            raise ValueError(f"UNetMoreDDPM: version {self.version} is not DDPM-family")
        if getattr(config.model, "noise_in_cond", False):
            raise NotImplementedError(
                "noise_in_cond: not ported yet (ROADMAP Queue 1 item 4)")
        self.unet = NCSNpp(config)
        sched = make_schedule(config)
        for name in ("betas", "alphas", "alphas_prev"):
            self.register_buffer(name, torch.from_numpy(getattr(sched, name).copy()))

    def forward(self, x, y, cond=None, cond_mask=None, dropout_generator=None):
        return self.unet(x, y, cond, cond_mask, dropout_generator)
