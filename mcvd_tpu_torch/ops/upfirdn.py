"""The polyphase FIR upsample (counterpart of `mcvd_tpu/ops/upfirdn.py`).

`models.resample.upsample_2d` zero-stuffs its input 2x and convolves it
with the 4x4 FIR, so 3 of every 4 taps meet a zero. Here each of the four
output phases (row and column parity) is its own depthwise convolution of
the input with the 2x2 taps that meet data, and the phases are interleaved:
4x fewer multiply-adds and no zero-stuffed tensor. Plain PyTorch (cuDNN's
depthwise convolution on the card); no model calls it, as in the JAX
package, where it is held against the zero-stuffing path too.

Derivation: out[o] = sum_t kf[t] u[o + t], u the pad0-shifted zero-stuffed
input, so only taps with (o + t - pad0) even contribute; for output phase
p = o mod 2 they read consecutive inputs s = (p + t - pad0) / 2.

Tensors are the port's (B, C, H, W), channels_last on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.resample import setup_kernel, upsample_2d

_WEIGHTS: Dict[tuple, torch.Tensor] = {}


def _phase_weight(sub: np.ndarray, C: int, dtype, device) -> torch.Tensor:
    """`sub` as a (C, 1, Ly, Lx) depthwise weight, made once per (taps, C,
    dtype, device) and outside inference mode (see `resample._fir_weight`)."""
    key = (sub.tobytes(), sub.shape, C, dtype, device)
    w = _WEIGHTS.get(key)
    if w is None:
        with torch.inference_mode(False):
            w = torch.as_tensor(np.ascontiguousarray(sub), dtype=dtype, device=device)
            w = w[None, None].expand(C, 1, *sub.shape).contiguous()
        _WEIGHTS[key] = w
    return w


def upfirdn2d_up2(x: torch.Tensor, kernel, pad: Tuple[int, int]) -> torch.Tensor:
    """`resample.upfirdn2d(x, kernel, up=2, down=1, pad)` by its four
    polyphase components; x (B, C, H, W), kernel a square 2D array."""
    B, C, H, W = x.shape
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    pad0, pad1 = pad
    out_h = 2 * H + pad0 + pad1 - kh + 1
    out_w = 2 * W + pad0 + pad1 - kw + 1
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"upfirdn2d_up2: a {kh}x{kw} kernel leaves no output of {H}x{W} "
                         f"with pad {pad}")
    kf = np.flip(kernel, (0, 1))
    out = torch.empty((B, C, out_h, out_w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    for py in (0, 1):
        ty = [t for t in range(kh) if (py + t - pad0) % 2 == 0]
        sy0 = (py + ty[0] - pad0) // 2
        n_y = (out_h - py + 1) // 2
        for px in (0, 1):
            tx = [t for t in range(kw) if (px + t - pad0) % 2 == 0]
            sx0 = (px + tx[0] - pad0) // 2
            n_x = (out_w - px + 1) // 2
            if n_y <= 0 or n_x <= 0:   # a 1-wide output has no odd phase
                continue
            sub = kf[np.ix_(ty, tx)]
            Ly, Lx = sub.shape
            lo_y, lo_x = max(0, -sy0), max(0, -sx0)
            hi_y = max(0, (n_y - 1 + sy0 + Ly - 1) - (H - 1))
            hi_x = max(0, (n_x - 1 + sx0 + Lx - 1) - (W - 1))
            y = F.conv2d(F.pad(x, (lo_x, hi_x, lo_y, hi_y)),
                         _phase_weight(sub, C, x.dtype, x.device), groups=C)
            y0, x0 = sy0 + lo_y, sx0 + lo_x
            out[:, :, py::2, px::2] = y[:, :, y0:y0 + n_y, x0:x0 + n_x]
    return out


def upsample_2d_fast(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0):
    """`resample.upsample_2d` by the polyphase path at factor 2 (other
    factors take `upsample_2d` itself)."""
    if factor != 2:
        return upsample_2d(x, k, factor, gain)
    if k is None:
        k = [1.0] * factor
    kk = setup_kernel(k) * (gain * (factor ** 2))
    p = kk.shape[0] - factor
    return upfirdn2d_up2(x, kk, pad=((p + 1) // 2 + factor - 1, p // 2))
