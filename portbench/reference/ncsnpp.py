"""Plain PyTorch NCSN++ score network, frozen for the benchmark's checks.

The `unetmore` network of MCVD (voletiv/mcvd-pytorch, models/better/
ncsnpp_more.py) on the branch the benchmark's configurations take: 2D
convolutions, channel-concat conditioning, BigGAN resblocks with FIR (1, 3,
3, 1) up/down resampling, AdaGN from the time embedding, multi-head
self-attention at `attn_resolutions`, skip rescaling by 1/sqrt(2). It is
written from the published architecture in float32 with plain torch
operations; it imports nothing of the program under test.

Weights are a dict keyed by upstream's state-dict names
(`unet.all_modules.{i}.<sub>.{weight,bias}`), which both the program and this
file take, so the benchmark hands the same tensors to both.

Tensors are NCHW with frames folded into channels frame-major (f*C + c).

Two hooks serve the benchmark:
  * `precision`: a `reference.precision.Precision` that rounds both
    operands of every convolution and matrix product, and the gradient of
    its output (the control computes in a lower precision this way);
  * `record`: a list that receives one dict per GroupNorm and per attention
    call, with its shapes (the kernels' operation and byte counts read them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

FIR = (1.0, 3.0, 3.0, 1.0)


def num_groups(ch: int) -> int:
    """min(ch // 4, 32), lowered until it divides ch (upstream get_act_norm)."""
    g = min(ch // 4, 32)
    if g < 1:
        return 1
    while ch % g:
        g -= 1
    return g


def _fir_2d(dtype, device, gain: float) -> torch.Tensor:
    k = np.outer(FIR, FIR)
    k = k / k.sum() * gain
    return torch.tensor(k, dtype=dtype, device=device)


class Plan:
    """The module list of the network, in upstream's `all_modules` order:
    (kind, in_ch, out_ch) with kind one of temb, conv, res, res_down,
    res_up, attn, head_norm."""

    def __init__(self, cfg: dict):
        m, d = cfg["model"], cfg["data"]
        if m.get("arch", "unetmore") != "unetmore" or m.get("spade", False):
            raise ValueError("the reference NCSN++ covers arch unetmore without SPADE")
        if m.get("resblock_type", "biggan") != "biggan" or m.get("cond_emb", False):
            raise ValueError("the reference NCSN++ covers BigGAN resblocks without cond_emb")
        self.nf = nf = m["ngf"]
        self.ch_mult = ch_mult = list(m["ch_mult"])
        self.nrb = nrb = m["num_res_blocks"]
        self.attn_res = list(m["attn_resolutions"])
        self.head_ch = m.get("n_head_channels", -1)
        self.C = d["channels"]
        self.F = d["num_frames"]
        self.Fc = d["num_frames_cond"] + d.get("num_frames_future", 0)
        self.res = [d["image_size"] // 2 ** i for i in range(len(ch_mult))]
        mods = [("temb", nf, 4 * nf), ("temb", 4 * nf, 4 * nf),
                ("conv", self.C * (self.F + self.Fc), nf)]
        hs, ch = [nf], nf
        for lvl, mult in enumerate(ch_mult):
            for _ in range(nrb):
                mods.append(("res", ch, nf * mult))
                ch = nf * mult
                if self.res[lvl] in self.attn_res:
                    mods.append(("attn", ch, ch))
                hs.append(ch)
            if lvl != len(ch_mult) - 1:
                mods.append(("res_down", ch, ch))
                hs.append(ch)
        mods += [("res", ch, ch), ("attn", ch, ch), ("res", ch, ch)]
        for lvl in reversed(range(len(ch_mult))):
            for _ in range(nrb + 1):
                out = nf * ch_mult[lvl]
                mods.append(("res", ch + hs.pop(), out))
                ch = out
            if self.res[lvl] in self.attn_res:
                mods.append(("attn", ch, ch))
            if lvl != 0:
                mods.append(("res_up", ch, ch))
        mods += [("head_norm", ch, ch), ("conv", ch, self.C * self.F)]
        self.mods = mods

    def heads(self, ch: int) -> int:
        if self.head_ch == -1 or ch < self.head_ch:
            return 1
        if ch % self.head_ch:
            raise ValueError(f"{ch} channels do not split into {self.head_ch}-wide heads")
        return ch // self.head_ch

    def shapes(self) -> Dict[str, tuple]:
        """Every parameter's name and shape (torch layouts, as upstream)."""
        out, temb = {}, 4 * self.nf

        def add(name, *shape):
            out[name] = shape

        for i, (kind, cin, cout) in enumerate(self.mods):
            p = f"unet.all_modules.{i}."
            if kind == "temb":
                add(p + "weight", cout, cin)
                add(p + "bias", cout)
            elif kind == "conv":
                add(p + "weight", cout, cin, 3, 3)
                add(p + "bias", cout)
            elif kind.startswith("res"):
                add(p + "actnorm0.Dense_0.weight", 2 * cin, temb)
                add(p + "actnorm0.Dense_0.bias", 2 * cin)
                add(p + "Conv_0.weight", cout, cin, 3, 3)
                add(p + "Conv_0.bias", cout)
                add(p + "actnorm1.Dense_0.weight", 2 * cout, temb)
                add(p + "actnorm1.Dense_0.bias", 2 * cout)
                add(p + "Conv_1.weight", cout, cout, 3, 3)
                add(p + "Conv_1.bias", cout)
                if cin != cout or kind != "res":
                    add(p + "Conv_2.weight", cout, cin, 1, 1)
                    add(p + "Conv_2.bias", cout)
            elif kind == "attn":
                add(p + "GroupNorm_0.weight", cin)
                add(p + "GroupNorm_0.bias", cin)
                for j in range(4):
                    add(p + f"NIN_{j}.W", cin, cin)
                    add(p + f"NIN_{j}.b", cin)
            else:   # head_norm
                add(p + "Norm_0.weight", cin)
                add(p + "Norm_0.bias", cin)
        return out


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    e = t.float()[:, None] * freqs[None]
    e = torch.cat([torch.sin(e), torch.cos(e)], dim=1)
    return F.pad(e, (0, 1)) if dim % 2 else e


class NCSNpp:
    """forward(w, x, t, cond) -> predicted noise, (B, F*C, H, W).

    `dropout`: None (evaluation), or (rate, generator): in each resblock the
    mask is drawn after its second norm as U[0, 1) of shape (B, H, W, C) from
    the generator, in the blocks' order, kept where u >= rate and scaled by
    1 / (1 - rate) (MCVD's flax layout of the draw)."""

    def __init__(self, cfg: dict, precision=None, record: Optional[List[dict]] = None):
        self.plan = Plan(cfg)
        self.q = precision.operand if precision else (lambda t: t)
        self.qo = precision.output if precision else (lambda t: t)
        self.record = record

    # -- operations whose operands the precision hook rounds
    def conv(self, x, w, b, stride=1, groups=1, pad=None):
        pad = w.shape[-1] // 2 if pad is None else pad
        y = self.qo(F.conv2d(self.q(x), self.q(w), None, stride=stride, padding=pad,
                             groups=groups))
        return y if b is None else y + b.view(1, -1, 1, 1)

    def linear(self, x, w, b):
        return self.qo(F.linear(self.q(x), self.q(w))) + b

    def matmul(self, a, b):
        return self.qo(torch.matmul(self.q(a), self.q(b)))

    # -- layers
    def group_norm(self, x, eps, gamma=None, beta=None, scale=None, shift=None, act=False):
        B, C, H, W = x.shape
        G = num_groups(C)
        if self.record is not None:
            self.record.append(dict(kernel="gn_fused", B=B, C=C, H=H, W=W, groups=G,
                                    affine=gamma is not None, adagn=scale is not None,
                                    act=act))
        xg = x.reshape(B, G, -1)
        mean = xg.mean(-1, keepdim=True)
        var = (xg - mean).square().mean(-1, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
        if gamma is not None:
            y = y * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)
        if scale is not None:
            y = y * (1 + scale[:, :, None, None]) + shift[:, :, None, None]
        return F.silu(y) if act else y

    def fir_up(self, x):
        B, C, H, W = x.shape
        z = x.new_zeros(B, C, 2 * H, 2 * W)
        z[:, :, ::2, ::2] = x
        z = F.pad(z, (2, 1, 2, 1))
        k = _fir_2d(x.dtype, x.device, 4.0).expand(C, 1, 4, 4)
        return self.conv(z, k, None, groups=C, pad=0)

    def fir_down(self, x):
        C = x.shape[1]
        k = _fir_2d(x.dtype, x.device, 1.0).expand(C, 1, 4, 4)
        return self.conv(F.pad(x, (1, 1, 1, 1)), k, None, stride=2, groups=C, pad=0)

    def resblock(self, w, p, x, temb, kind, dropout):
        def adagn(h, name):
            s = self.linear(F.silu(temb), w[p + name + ".Dense_0.weight"],
                            w[p + name + ".Dense_0.bias"])
            scale, shift = s.chunk(2, dim=1)
            return self.group_norm(h, 1e-5, scale=scale, shift=shift, act=True)

        h = adagn(x, "actnorm0")
        if kind == "res_up":
            h, x = self.fir_up(h), self.fir_up(x)
        elif kind == "res_down":
            h, x = self.fir_down(h), self.fir_down(x)
        h = self.conv(h, w[p + "Conv_0.weight"], w[p + "Conv_0.bias"])
        h = adagn(h, "actnorm1")
        if dropout is not None:
            rate, gen = dropout
            B, C, H, W = h.shape
            u = torch.rand((B, H, W, C), generator=gen, device=h.device).permute(0, 3, 1, 2)
            h = h * (u >= rate).to(h.dtype) / (1.0 - rate)
        h = self.conv(h, w[p + "Conv_1.weight"], w[p + "Conv_1.bias"])
        if p + "Conv_2.weight" in w:
            x = self.conv(x, w[p + "Conv_2.weight"], w[p + "Conv_2.bias"])
        return (x + h) / math.sqrt(2.0)

    def attention(self, w, p, x):
        B, C, H, W = x.shape
        h = self.group_norm(x, 1e-6, w[p + "GroupNorm_0.weight"], w[p + "GroupNorm_0.bias"])
        tok = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = (self.matmul(tok, w[p + f"NIN_{j}.W"]) + w[p + f"NIN_{j}.b"]
                   for j in range(3))
        nh = self.plan.heads(C)
        d = C // nh
        if self.record is not None:
            self.record.append(dict(kernel="attention_fwd", B=B, T=H * W, H=nh, D=d))
        q, k, v = (t.reshape(B, H * W, nh, d).transpose(1, 2) for t in (q, k, v))
        a = torch.softmax(self.matmul(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
        o = self.matmul(a, v).transpose(1, 2).reshape(B, H * W, C)
        h = self.matmul(o, w[p + "NIN_3.W"]) + w[p + "NIN_3.b"]
        return (x + h.view(B, H, W, C).permute(0, 3, 1, 2)) / math.sqrt(2.0)

    def forward(self, w: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor, dropout=None) -> torch.Tensor:
        plan = self.plan
        mods = plan.mods

        def p(i):
            return f"unet.all_modules.{i}."

        x = torch.cat([x, cond], dim=1)
        temb = timestep_embedding(t, plan.nf)
        temb = self.linear(temb, w[p(0) + "weight"], w[p(0) + "bias"])
        temb = self.linear(F.silu(temb), w[p(1) + "weight"], w[p(1) + "bias"])
        hs = [self.conv(x, w[p(2) + "weight"], w[p(2) + "bias"])]
        i = 3
        # down, recording each level's outputs for the skips
        for lvl in range(len(plan.ch_mult)):
            for _ in range(plan.nrb):
                h = self.resblock(w, p(i), hs[-1], temb, "res", dropout)
                i += 1
                if plan.res[lvl] in plan.attn_res:
                    h = self.attention(w, p(i), h)
                    i += 1
                hs.append(h)
            if lvl != len(plan.ch_mult) - 1:
                hs.append(self.resblock(w, p(i), hs[-1], temb, "res_down", dropout))
                i += 1
        h = self.resblock(w, p(i), hs[-1], temb, "res", dropout)
        h = self.attention(w, p(i + 1), h)
        h = self.resblock(w, p(i + 2), h, temb, "res", dropout)
        i += 3
        for lvl in reversed(range(len(plan.ch_mult))):
            for _ in range(plan.nrb + 1):
                h = self.resblock(w, p(i), torch.cat([h, hs.pop()], dim=1), temb, "res",
                                  dropout)
                i += 1
            if plan.res[lvl] in plan.attn_res:
                h = self.attention(w, p(i), h)
                i += 1
            if lvl != 0:
                h = self.resblock(w, p(i), h, temb, "res_up", dropout)
                i += 1
        h = self.group_norm(h, 1e-5, w[p(i) + "Norm_0.weight"], w[p(i) + "Norm_0.bias"],
                            act=True)
        assert mods[i + 1][0] == "conv" and i + 2 == len(mods)
        return self.conv(h, w[p(i + 1) + "weight"], w[p(i + 1) + "bias"])

    __call__ = forward
