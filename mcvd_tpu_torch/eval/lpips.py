"""LPIPS (net-lin, AlexNet) on the card (counterpart of
`mcvd_tpu/eval/lpips.py`; upstream models/eval_models.py PerceptualLoss ->
models/dist_model.py -> models/networks_basic.py PNetLin).

The shift/scale layer, the five ReLU slices of torchvision's AlexNet
features (max-pool after the first two), each slice unit-normalized over
its channels, squared differences weighted by the 1x1 'lin' heads, the
spatial mean, and the sum over slices. The weights are torchvision's AlexNet
(its `.features` or the whole net) and the reference's lin heads
(models/weights/v0.1/alex.pth); `make_lpips_fn` takes frames as upstream
does (ncsn_runner.py:1427-1431): resized to 128 (bilinear, antialiased where
it downscales, as the JAX package's `jax.image.resize`) and mapped to
[-1, 1].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device
from .i3d import as_tensor, resize_bilinear

# ImageNet-derived scaling constants (upstream networks_basic.py ScalingLayer)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# torchvision AlexNet.features convolutions: (in, out, kernel, stride, pad)
ALEX_CONVS = [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
              (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
FEATURE_IDX = [0, 3, 6, 8, 10]   # their indices within AlexNet.features


class AlexFeatures(nn.Module):
    """The five ReLU slices of torchvision's AlexNet.features."""

    def __init__(self):
        super().__init__()
        for i, (ci, co, k, s, p) in enumerate(ALEX_CONVS):
            setattr(self, f"conv{i}", nn.Conv2d(ci, co, k, s, p))

    def forward(self, x):
        feats = []
        for i in range(len(ALEX_CONVS)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if i in (0, 1):   # max-pool after relu1 and relu2
                x = F.max_pool2d(x, 3, 2)
        return feats


def _unit_normalize(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPSAlex(nn.Module):
    """PNetLin(pnet_type='alex', lpips=True, spatial=False, version='0.1'):
    (in0, in1) NCHW in [-1, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.net = AlexFeatures()
        for kk, (_, co, *_) in enumerate(ALEX_CONVS):
            self.register_parameter(f"lin{kk}", nn.Parameter(torch.ones(co)))
        self.register_buffer("shift", torch.tensor(SHIFT)[None, :, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE)[None, :, None, None],
                             persistent=False)

    def forward(self, in0, in1):
        f0 = self.net((in0 - self.shift) / self.scale)
        f1 = self.net((in1 - self.shift) / self.scale)
        val = 0.0
        for kk in range(len(ALEX_CONVS)):
            diff = (_unit_normalize(f0[kk]) - _unit_normalize(f1[kk])) ** 2
            # a 1x1 conv to one channel: a channel-weighted sum
            res = torch.sum(diff * getattr(self, f"lin{kk}")[None, :, None, None], dim=1)
            val = val + res.mean(dim=(1, 2))
        return val


def convert_lpips_weights(alexnet_sd, lin_sd) -> Dict[str, torch.Tensor]:
    """`LPIPSAlex`'s state dict from torchvision's AlexNet state dict (the
    whole net, `features.{i}.*`, or its `.features`, `{i}.*`) and the lin
    heads (`lin{k}.model.1.weight`, (1, C, 1, 1))."""
    out = {}
    for i, fi in enumerate(FEATURE_IDX):
        for prefix in (f"features.{fi}", str(fi)):
            if f"{prefix}.weight" in alexnet_sd:
                out[f"net.conv{i}.weight"] = as_tensor(alexnet_sd[f"{prefix}.weight"])
                out[f"net.conv{i}.bias"] = as_tensor(alexnet_sd[f"{prefix}.bias"])
                break
        else:
            raise KeyError(f"alexnet conv {fi} not found")
    for kk in range(len(ALEX_CONVS)):
        out[f"lin{kk}"] = as_tensor(lin_sd[f"lin{kk}.model.1.weight"]).reshape(-1)
    return out


def _load(path: str):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def make_lpips_fn(lin_weights_path: str, alexnet_weights_path: Optional[str],
                  device=DEFAULT_DEVICE, batch_size: int = 512) -> Callable:
    """lpips(real, pred) -> the per-video mean LPIPS, a list of B floats.
    real, pred: (B, T, H, W, C) numpy in [0, 1]. The network runs on
    `device` (the card unless device="cpu"); a file that does not load
    raises."""
    device = resolve_device(device, "make_lpips_fn")
    if alexnet_weights_path is None:
        raise ValueError("LPIPS needs torchvision's AlexNet weights beside its lin heads")
    net = LPIPSAlex()
    net.load_state_dict(convert_lpips_weights(_load(alexnet_weights_path),
                                              _load(lin_weights_path)))
    net = net.to(device).eval()

    def prep(v: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        return resize_bilinear(x.contiguous(), (128, 128)) * 2.0 - 1.0

    def lpips(real: np.ndarray, pred: np.ndarray):
        B, T = real.shape[:2]
        r = real.reshape(B * T, *real.shape[2:])
        p = pred.reshape(B * T, *pred.shape[2:])
        d = []
        with torch.inference_mode():
            for i in range(0, B * T, batch_size):
                d.append(net(prep(r[i:i + batch_size]), prep(p[i:i + batch_size])))
        return torch.cat(d).float().cpu().numpy().reshape(B, T).mean(axis=1).tolist()

    return lpips
