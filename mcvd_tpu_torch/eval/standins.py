"""Seeded random weights in the metric files' own schemas, for checks that
run without the real files (the I3D TorchScript, torchvision's AlexNet, the
LPIPS lin heads, pt_inception are downloads upstream, and absent here).

Each state dict is numpy float32, drawn from `np.random.RandomState(seed)`
at a scale that keeps activations of order one through the network (He
normal convolutions; BatchNorm statistics and affine drawn around 0 and 1),
so a check on it compares numbers of a sensible size. `write_standins`
saves them as the files a user would point `eval.*` at.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from .i3d import MIXED
from .lpips import ALEX_CONVS, FEATURE_IDX


def _conv(rng, out_ch, in_ch, kernel):
    fan_in = in_ch * int(np.prod(kernel))
    return (rng.randn(out_ch, in_ch, *kernel) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def _unit3d(sd, rng, name, in_ch, out_ch, kernel=(1, 1, 1)):
    """pytorch_i3d's Unit3D with BatchNorm (no conv bias)."""
    sd[f"{name}.conv3d.weight"] = _conv(rng, out_ch, in_ch, kernel)
    sd[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, out_ch).astype(np.float32)
    sd[f"{name}.bn.bias"] = (0.1 * rng.randn(out_ch)).astype(np.float32)
    sd[f"{name}.bn.running_mean"] = (0.1 * rng.randn(out_ch)).astype(np.float32)
    sd[f"{name}.bn.running_var"] = rng.uniform(0.75, 1.25, out_ch).astype(np.float32)
    sd[f"{name}.bn.num_batches_tracked"] = np.array(0, np.int64)


def i3d_state_dict(seed: int, num_classes: int = 400) -> Dict[str, np.ndarray]:
    """Upstream InceptionI3d's state dict (models/fvd/pytorch_i3d.py): BN
    after every conv but the logits, which have a bias."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    _unit3d(sd, rng, "Conv3d_1a_7x7", 3, 64, (7, 7, 7))
    _unit3d(sd, rng, "Conv3d_2b_1x1", 64, 64)
    _unit3d(sd, rng, "Conv3d_2c_3x3", 64, 192, (3, 3, 3))
    ch = 192
    for name, o in MIXED.items():
        for b, ci, co, k in (("b0", ch, o[0], 1), ("b1a", ch, o[1], 1), ("b1b", o[1], o[2], 3),
                             ("b2a", ch, o[3], 1), ("b2b", o[3], o[4], 3),
                             ("b3b", ch, o[5], 1)):
            _unit3d(sd, rng, f"{name}.{b}", ci, co, (k, k, k))
        ch = o[0] + o[2] + o[4] + o[5]
    sd["logits.conv3d.weight"] = _conv(rng, num_classes, ch, (1, 1, 1))
    sd["logits.conv3d.bias"] = (0.1 * rng.randn(num_classes)).astype(np.float32)
    return sd


def alexnet_features_state_dict(seed: int, prefix: str = "") -> Dict[str, np.ndarray]:
    """torchvision AlexNet's convolutions: `{prefix}{i}.weight` / `.bias`
    (prefix "" for `alexnet.features`, "features." for the whole net)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for fi, (ci, co, k, _, _) in zip(FEATURE_IDX, ALEX_CONVS):
        sd[f"{prefix}{fi}.weight"] = _conv(rng, co, ci, (k, k))
        sd[f"{prefix}{fi}.bias"] = (0.1 * rng.randn(co)).astype(np.float32)
    return sd


def lpips_lin_state_dict(seed: int) -> Dict[str, np.ndarray]:
    """The reference's lin heads (models/weights/v0.1/alex.pth): nonnegative
    (1, C, 1, 1) weights."""
    rng = np.random.RandomState(seed)
    return {f"lin{k}.model.1.weight": rng.rand(1, co, 1, 1).astype(np.float32)
            for k, (_, co, *_) in enumerate(ALEX_CONVS)}


def simple_state_dict(seed: int, nd: int, in_ch: int = 3, out_ch: int = 16,
                      feat_dim: int = 32, kernel: int = 3) -> Dict[str, np.ndarray]:
    """The minimal `conv.*`/`head.*` embedder, nd = 2 (images) or 3 (videos)."""
    rng = np.random.RandomState(seed)
    return {"conv.weight": _conv(rng, out_ch, in_ch, (kernel,) * nd),
            "conv.bias": (0.1 * rng.randn(out_ch)).astype(np.float32),
            "head.weight": (rng.randn(feat_dim, out_ch) / np.sqrt(out_ch)).astype(np.float32),
            "head.bias": (0.1 * rng.randn(feat_dim)).astype(np.float32)}


class TinyInception(nn.Module):
    """An image embedder outside the simple schema: two strided convs, a
    global mean and a linear layer, (B, 3, H, W) -> (B, feat_dim). As a
    TorchScript archive it stands in for pt_inception."""

    def __init__(self, feat_dim: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 3, 2, 1)
        self.conv2 = nn.Conv2d(16, 32, 3, 2, 1)
        self.fc = nn.Linear(32, feat_dim)

    def forward(self, x):
        x = torch.relu(self.conv2(torch.relu(self.conv1(x))))
        return self.fc(x.mean(dim=(2, 3)))


def tiny_inception(seed: int) -> torch.jit.ScriptModule:
    net = TinyInception()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (2.0 / max(p[0].numel(), 1)) ** 0.5)
    return torch.jit.script(net.eval())


def save_state_dict(sd: Dict[str, np.ndarray], path: str) -> str:
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return path


def write_standins(out_dir: str, seed: int = 0) -> Dict[str, str]:
    """The four metric files, under their canonical names in `out_dir`:
    {"i3d", "lpips", "alexnet", "inception"} -> path."""
    from . import weights as W

    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "i3d": save_state_dict(i3d_state_dict(seed), os.path.join(out_dir, W.I3D)),
        "lpips": save_state_dict(lpips_lin_state_dict(seed + 1),
                                 os.path.join(out_dir, W.LPIPS_LIN)),
        "alexnet": save_state_dict(alexnet_features_state_dict(seed + 2),
                                   os.path.join(out_dir, W.ALEXNET)),
        "inception": os.path.join(out_dir, W.INCEPTION),
    }
    tiny_inception(seed + 3).save(paths["inception"])
    return paths

