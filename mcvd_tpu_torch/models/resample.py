"""FIR up/down-sampling, StyleGAN2 `upfirdn2d` semantics (counterpart of
`mcvd_tpu/models/resample.py`) on NCHW tensors.

upfirdn2d zero-stuffs by `up`, pads, convolves with the FIR kernel (a TRUE
convolution, so the kernel is flipped before torch's cross-correlation) as a
depthwise conv, and keeps every `down`-th sample:
out_h = (in_h*up + pad0 + pad1 - kernel_h) // down + 1.

The conv-fused variants (`upsample_conv_2d`, `conv_downsample_2d`, the
`resblock_type: ddpm` branch's resampling) take the conv weight in torch's
(O, I, kh, kw) layout, as upstream's `up_or_down_sampling.Conv2d` stores it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def setup_kernel(k: Sequence[float]) -> np.ndarray:
    """1D -> 2D outer product, normalized to sum 1."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= k.sum()
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"FIR kernel must be square, got {k.shape}")
    return k


def upfirdn2d(x: torch.Tensor, kernel: np.ndarray, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Upsample (zero-stuff) -> pad -> FIR convolve -> downsample over the
    last two axes of (B, C, H, W), the same pad on both axes."""
    B, C, H, W = x.shape
    if up > 1:
        z = torch.zeros((B, C, H * up, W * up), dtype=x.dtype, device=x.device)
        z = z.contiguous(memory_format=torch.channels_last)
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(x, _fir_weight(kernel, C, x.dtype, x.device), stride=down, groups=C)


_FIR_WEIGHTS = {}


def _fir_weight(kernel: np.ndarray, C: int, dtype, device) -> torch.Tensor:
    """The flipped kernel as a (C, 1, kh, kw) depthwise weight, made once per
    (kernel, C, dtype, device): a fresh one per call would copy host to
    device on every resample. Made outside inference mode, so a weight
    first made by the sampler (under `torch.inference_mode()`) serves the
    train step's autograd too."""
    key = (kernel.tobytes(), kernel.shape, C, dtype, device)
    w = _FIR_WEIGHTS.get(key)
    if w is None:
        kf = np.ascontiguousarray(np.flip(kernel, (0, 1)))
        with torch.inference_mode(False):
            w = torch.as_tensor(kf, dtype=dtype, device=device)
            w = w[None, None].expand(C, 1, *kf.shape).contiguous()
        _FIR_WEIGHTS[key] = w
    return w


def upsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
    if k is None:
        k = [1.0] * factor
    kk = setup_kernel(k) * (gain * (factor**2))
    p = kk.shape[0] - factor
    return upfirdn2d(x, kk, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
    if k is None:
        k = [1.0] * factor
    kk = setup_kernel(k) * gain
    p = kk.shape[0] - factor
    return upfirdn2d(x, kk, down=factor, pad=((p + 1) // 2, p // 2))


def naive_upsample_2d(x, factor: int = 2):
    """Nearest-neighbour upsample (in x's memory format)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def naive_downsample_2d(x, factor: int = 2):
    """Mean-pool downsample."""
    return F.avg_pool2d(x, factor)


def upsample_conv_2d(x, w, k=None, factor: int = 2, gain: float = 1.0):
    """Fused upsample + conv (StyleGAN2; the JAX package's `upsample_conv_2d`):
    a stride-`factor` transposed conv, then the FIR. The JAX code correlates
    the zero-stuffed x, padded by kh-1, with w; a transposed conv does the
    same with w flipped and its I and O swapped. Output (in*factor)."""
    convH, convW = w.shape[2], w.shape[3]
    if convH != convW:
        raise ValueError(f"upsample_conv_2d: conv kernel must be square, got {tuple(w.shape)}")
    if k is None:
        k = [1.0] * factor
    kk = setup_kernel(k) * (gain * (factor**2))
    p = (kk.shape[0] - factor) - (convW - 1)
    x = F.conv_transpose2d(x, w.transpose(0, 1).flip(2, 3), stride=factor)
    return upfirdn2d(x, kk, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x, w, k=None, factor: int = 2, gain: float = 1.0):
    """Fused FIR + strided conv (StyleGAN2; the JAX package's
    `conv_downsample_2d`): the FIR padded by (kernel - factor + kh - 1), then
    a stride-`factor` VALID conv with w. Output (in/factor)."""
    convH, convW = w.shape[2], w.shape[3]
    if convH != convW:
        raise ValueError(f"conv_downsample_2d: conv kernel must be square, got {tuple(w.shape)}")
    if k is None:
        k = [1.0] * factor
    kk = setup_kernel(k) * gain
    p = (kk.shape[0] - factor) + (convW - 1)
    x = upfirdn2d(x, kk, pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w, stride=factor)
