"""The FVD embedder: I3D (Inception-v1 3D) as an `nn.Module` on the card
(counterpart of `mcvd_tpu/eval/i3d.py` and `mcvd_tpu/eval/fvd.py`; upstream
models/fvd/pytorch_i3d.py:135 and models/fvd/fvd.py:30-49,160-186).

The JAX package has two routes to the features: a flax I3D, and a torch-CPU
sidecar that runs the TorchScript archive. The port has one: the weights of
the archive (or of a plain torch checkpoint) go into `InceptionI3d`, with
BatchNorm folded into the convolutions, which runs on the caller's device.
Layout NCDHW (channels_last_3d ran slower: 5.020 against 4.757 ms a
video of 16 frames at 224 px, fp32, on an NVIDIA H100 80GB HBM3 at 700 W,
`chip_smoke.py` eval_nets); TF-"same" padding is computed from the input's
size at each call, and the max-pools pad with zeros, as upstream does.

Two weight schemas are taken (`detect_schema`):
  * the full InceptionI3d naming (`Conv3d_1a_7x7.conv3d.weight`, ...,
    `logits.conv3d.weight`, with `.bn.*`), as pytorch_i3d.py writes it;
  * a minimal `conv.weight`/`head.weight` embedder (conv -> global mean ->
    linear), 3d for videos (`SimpleScriptEmbedder3d`) or 2d for images
    (`SimpleScriptEmbedder2d`, the FID stand-in, see `eval/fid.py`).
A TorchScript archive often nests the network under a wrapper module
(`inner.`, `module.`, ...): up to two shared leading names are stripped.

Preprocessing (`preprocess_videos`) is the JAX package's jitted path: the
shortest side bilinear-resized to 224 (antialiased where it downscales, as
`jax.image.resize` does), a center crop, [-1, 1], grayscale repeated to 3
channels.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-'same' padding of one dimension (upstream pytorch_i3d.py:72-77)."""
    pad = max(k - s, 0) if size % s == 0 else max(k - (size % s), 0)
    return pad // 2, pad - pad // 2


def _pad_same_3d(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Zero-pad (B, C, T, H, W) so a VALID window gives TF's 'same' size."""
    pads = [same_pad(x.shape[2 + i], kernel[i], stride[i]) for i in range(3)]
    return F.pad(x, (*pads[2], *pads[1], *pads[0]))


def _max_pool_same_3d(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """MaxPool3dSamePadding (upstream pytorch_i3d.py:7-34): zeros, not -inf,
    then a VALID max-pool."""
    return F.max_pool3d(_pad_same_3d(x, kernel, stride), kernel, stride)


class Unit3D(nn.Module):
    """Conv3d with BatchNorm folded in, then ReLU (upstream
    pytorch_i3d.py:37-103)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), act: bool = True):
        super().__init__()
        self.kernel, self.stride, self.act = tuple(kernel), tuple(stride), act
        self.conv3d = nn.Conv3d(in_ch, out_ch, self.kernel, self.stride, bias=True)

    def forward(self, x):
        x = self.conv3d(_pad_same_3d(x, self.kernel, self.stride))
        return F.relu(x) if self.act else x


class InceptionModule(nn.Module):
    """The four-branch block (upstream pytorch_i3d.py:106-133)."""

    def __init__(self, in_ch: int, out: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(in_ch, out[0])
        self.b1a = Unit3D(in_ch, out[1])
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3))
        self.b2a = Unit3D(in_ch, out[3])
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3))
        self.b3b = Unit3D(in_ch, out[5])

    def forward(self, x):
        b3 = self.b3b(_max_pool_same_3d(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], 1)


MIXED = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}
# (max-pool kernel, stride) before these blocks
_POOL_BEFORE = {"Mixed_4b": ((3, 3, 3), (2, 2, 2)), "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


def _mixed_out(out: Sequence[int]) -> int:
    return out[0] + out[2] + out[4] + out[5]


class InceptionI3d(nn.Module):
    """I3D up to its logits (upstream pytorch_i3d.py:135-322), which FVD
    takes as the features (fvd.py:43, return_features=True): (B, 3, T, H, W)
    in [-1, 1] -> (B, num_classes). Needs H, W >= 224 and T >= 9 (the
    (2, 7, 7) VALID average pool)."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        ch = 192
        for name, out in MIXED.items():
            setattr(self, name, InceptionModule(ch, out))
            ch = _mixed_out(out)
        self.logits = Unit3D(ch, num_classes, act=False)

    def forward(self, x):
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool_same_3d(x, (1, 3, 3), (1, 2, 2))        # MaxPool3d_2a
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _max_pool_same_3d(x, (1, 3, 3), (1, 2, 2))        # MaxPool3d_3a
        for name in MIXED:
            if name in _POOL_BEFORE:                           # MaxPool3d_4a, _5a
                x = _max_pool_same_3d(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        # AvgPool3d (2, 7, 7) VALID -> dropout (identity in eval) -> 1x1x1
        # conv -> spatial squeeze, mean over time
        x = self.logits(F.avg_pool3d(x, (2, 7, 7), (1, 1, 1)))
        return x.mean(dim=2)[:, :, 0, 0]


class SimpleScriptEmbedder3d(nn.Module):
    """conv3d -> global mean -> linear head: the minimal embedder schema.
    Input (B, C, T, H, W)."""

    def __init__(self, in_ch: int, out_ch: int, feat_dim: int, kernel: Sequence[int],
                 stride: Sequence[int] = (1, 1, 1), pad: Sequence[int] = (0, 0, 0)):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, tuple(kernel), tuple(stride), tuple(pad))
        self.head = nn.Linear(out_ch, feat_dim)

    def forward(self, x):
        return self.head(self.conv(x).mean(dim=(2, 3, 4)))


class SimpleScriptEmbedder2d(nn.Module):
    """conv2d -> global mean -> linear head (stand-in Inception files).
    Input (B, C, H, W)."""

    def __init__(self, in_ch: int, out_ch: int, feat_dim: int, kernel: Sequence[int],
                 stride: Sequence[int] = (1, 1), pad: Sequence[int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, tuple(kernel), tuple(stride), tuple(pad))
        self.head = nn.Linear(out_ch, feat_dim)

    def forward(self, x):
        return self.head(self.conv(x).mean(dim=(2, 3)))


def as_tensor(v) -> torch.Tensor:
    """A state-dict entry (tensor or numpy) as a float32 CPU tensor."""
    return v.detach().cpu().float() if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.asarray(v, np.float32))


def fold_bn(sd, prefix: str, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Eval-mode BatchNorm3d folded into the conv before it: with g =
    gamma / sqrt(var + eps) per output channel, w' = w * g and b' = beta +
    (b - mu) * g. Computed in float64 and stored fp32."""
    def get(name):
        return as_tensor(sd[f"{prefix}.{name}"]).double()

    w = get("conv3d.weight")
    b = get("conv3d.bias") if f"{prefix}.conv3d.bias" in sd else torch.zeros(
        w.shape[0], dtype=torch.float64)
    if f"{prefix}.bn.weight" in sd:
        g = get("bn.weight") / torch.sqrt(get("bn.running_var") + eps)
        w = w * g[:, None, None, None, None]
        b = get("bn.bias") + (b - get("bn.running_mean")) * g
    return {f"{prefix}.conv3d.weight": w.float(), f"{prefix}.conv3d.bias": b.float()}


def convert_i3d_state_dict(sd) -> Dict[str, torch.Tensor]:
    """Upstream InceptionI3d state dict -> `InceptionI3d`'s (BN folded)."""
    out = {}
    for name in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        out.update(fold_bn(sd, name))
    for name in MIXED:
        for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b"):
            out.update(fold_bn(sd, f"{name}.{b}"))
    out.update(fold_bn(sd, "logits"))
    return out


def detect_schema(sd) -> str:
    """"i3d", "simple3d" or "simple2d"; raises on any other state dict."""
    if any(k.startswith("Conv3d_1a_7x7") for k in sd):
        return "i3d"
    if "conv.weight" in sd and "head.weight" in sd:
        return "simple3d" if sd["conv.weight"].ndim == 5 else "simple2d"
    raise ValueError(f"unrecognized embedder state dict: {sorted(sd)[:8]}")


def strip_wrapper_prefixes(sd) -> Tuple[dict, str]:
    """(state dict, stripped prefix): shared leading names removed, at most
    two, until the keys match a schema (TorchScript wrappers)."""
    prefix = ""
    for _ in range(2):
        try:
            detect_schema(sd)
            return sd, prefix
        except ValueError:
            pass
        firsts = {k.split(".", 1)[0] for k in sd}
        if len(firsts) != 1 or not all("." in k for k in sd):
            break
        prefix += f"{firsts.pop()}."
        sd = {k.split(".", 1)[1]: v for k, v in sd.items()}
    return sd, prefix


def load_embedder_spec(path: str):
    """(state dict, conv_spec, module) of a TorchScript archive or a torch
    checkpoint (a state dict or a pickled module). conv_spec holds the
    script's `conv` stride and padding where it has one (a state dict has no
    hyperparameters); module is the loaded module, or None for a state dict.
    A file that is neither raises."""
    try:
        mod = torch.jit.load(path, map_location="cpu")
    except (RuntimeError, ValueError):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        mod = obj if isinstance(obj, nn.Module) else None
        sd = obj.state_dict() if mod is not None else obj
        if not isinstance(sd, dict):
            raise ValueError(f"{path}: neither a TorchScript archive, a module nor a "
                             f"state dict ({type(obj).__name__})")
        sd, _ = strip_wrapper_prefixes(sd)
        return sd, {}, mod
    sd, prefix = strip_wrapper_prefixes(mod.state_dict())
    spec, owner = {}, mod
    for name in prefix.split(".")[:-1]:
        owner = getattr(owner, name)
    conv = getattr(owner, "conv", None)
    if conv is not None:
        for attr in ("stride", "padding"):
            if hasattr(conv, attr):
                spec[attr] = tuple(getattr(conv, attr))
    return sd, spec, mod


def build_embedder_from_state_dict(sd, conv_spec=None) -> nn.Module:
    """The module of any accepted schema, with the weights loaded (CPU, eval
    mode). Input NCDHW (3d) or NCHW (2d)."""
    schema = detect_schema(sd)
    if schema == "i3d":
        net = InceptionI3d(num_classes=sd["logits.conv3d.weight"].shape[0])
        net.load_state_dict(convert_i3d_state_dict(sd))
        return net.eval()
    w, hw = as_tensor(sd["conv.weight"]), as_tensor(sd["head.weight"])
    nd = w.ndim - 2
    spec = conv_spec or {}
    cls = SimpleScriptEmbedder3d if schema == "simple3d" else SimpleScriptEmbedder2d
    net = cls(w.shape[1], w.shape[0], hw.shape[0], w.shape[2:],
              stride=spec.get("stride", (1,) * nd), pad=spec.get("padding", (0,) * nd))
    net.load_state_dict({k: as_tensor(sd[k]) for k in ("conv.weight", "conv.bias", "head.weight",
                                                 "head.bias")})
    return net.eval()


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, *size): half-pixel bilinear, antialiased where
    it downscales, which is what `jax.image.resize(..., "bilinear")` does."""
    down = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=down)


def preprocess_videos(videos: torch.Tensor, resolution: int = 224) -> torch.Tensor:
    """(B, T, H, W, C) in [0, 1] -> (B, 3, T, res, res) in [-1, 1]: the
    shortest side resized to `resolution`, then a center crop (upstream
    fvd.py preprocess_single)."""
    B, T, H, W, C = videos.shape
    v = videos.float()
    if C == 1:   # grayscale -> 3 channels (upstream ncsn_runner.py:1918-1923)
        v = v.expand(B, T, H, W, 3)
    scale = resolution / min(H, W)
    th, tw = (resolution, math.ceil(W * scale)) if H < W else (math.ceil(H * scale),
                                                               resolution)
    x = resize_bilinear(v.reshape(B * T, H, W, 3).permute(0, 3, 1, 2), (th, tw))
    h0, w0 = (th - resolution) // 2, (tw - resolution) // 2
    x = x[:, :, h0:h0 + resolution, w0:w0 + resolution]
    x = x.reshape(B, T, 3, resolution, resolution).permute(0, 2, 1, 3, 4)
    return ((x - 0.5) * 2.0).contiguous()


def make_i3d_embedder(path: str, device=DEFAULT_DEVICE, batch_size: int = 8) -> Callable:
    """embed(videos (B, T, H, W, C) numpy in [0, 1]) -> (B, F) numpy
    features, the network on `device` (the card unless device="cpu"). The
    weights are the file's, in either schema; a file that does not load
    raises."""
    device = resolve_device(device, "make_i3d_embedder")
    sd, spec, _ = load_embedder_spec(path)
    net = build_embedder_from_state_dict(sd, spec).to(device)

    def embed(videos: np.ndarray) -> np.ndarray:
        feats = []
        with torch.inference_mode():
            for i in range(0, len(videos), batch_size):
                v = torch.from_numpy(np.ascontiguousarray(videos[i:i + batch_size],
                                                          np.float32)).to(device)
                feats.append(net(preprocess_videos(v)).float().cpu().numpy())
        return np.concatenate(feats)

    return embed

