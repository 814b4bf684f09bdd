"""Per-frame video metrics: MSE, PSNR, SSIM (counterpart of
`mcvd_tpu/eval/metrics.py`, copied: numpy and `scipy.ndimage`).

Upstream protocol (runners/ncsn_runner.py:1581-1609, 2196-2204):
  * MSE per frame on [0, 1] floats; PSNR = 10*log10(1/MSE);
  * SSIM per frame on 8-bit grayscale with skimage's structural_similarity
    settings (data_range=255, gaussian_weights=True,
    use_sample_covariance=False), implemented from its formula (Wang et al.
    2004) with the same gaussian window (sigma 1.5, truncate 3.5: 11x11) and
    crop; the MNIST family rounds to black and white first;
  * best-of-preds_per_test selection happens in the harness.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rgb_to_grayscale_uint8(frame: np.ndarray) -> np.ndarray:
    """float [0,1] HWC -> uint8 grayscale HW using PIL's ITU-R 601-2 weights
    (the reference goes through ToPILImage().convert('L'))."""
    arr = np.clip(np.round(frame * 255.0), 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        return arr[..., 0]
    r, g, b = arr[..., 0].astype(np.int64), arr[..., 1].astype(np.int64), arr[..., 2].astype(np.int64)
    return ((r * 299 + g * 587 + b * 114) // 1000).astype(np.uint8)


def ssim_grayscale(img1: np.ndarray, img2: np.ndarray, data_range: float = 255.0,
                   sigma: float = 1.5, truncate: float = 3.5) -> float:
    """SSIM on 2D grayscale arrays, skimage-compatible settings
    (gaussian_weights=True, use_sample_covariance=False). The final crop of
    `pad` border pixels means no retained pixel's window touches padding, so
    the filter's boundary mode is immaterial."""
    from scipy.ndimage import gaussian_filter

    x = img1.astype(np.float64)
    y = img2.astype(np.float64)
    pad = int(truncate * sigma + 0.5)

    def f(a):
        return gaussian_filter(a, sigma, truncate=truncate)

    ux = f(x)
    uy = f(y)
    uxx = f(x * x)
    uyy = f(y * y)
    uxy = f(x * y)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy

    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))
    # skimage crops `pad` pixels on each side before averaging
    return float(S[pad:-pad, pad:-pad].mean())


def mse_and_psnr(real: np.ndarray, pred: np.ndarray) -> Tuple[float, float]:
    """Per-video mean frame MSE on [0,1] floats and PSNR=10*log10(1/mse)."""
    mse = float(np.mean((real.astype(np.float64) - pred.astype(np.float64)) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-20))
    return mse, psnr


def video_metrics_batch(
    real: np.ndarray,          # (B, T, H, W, C) in [0,1]
    pred: np.ndarray,          # (B, T, H, W, C) in [0,1]
    *,
    is_mnist: bool = False,
    calc_ssim: bool = True,
) -> dict:
    """Per-video metrics averaged over frames (reference loop:
    ncsn_runner.py:1581-1609). Returns dict of lists of per-video values."""
    B, T = real.shape[:2]
    out = {"mse": [], "psnr": [], "ssim": []}
    for b in range(B):
        mse_acc = 0.0
        ssim_acc = 0.0
        for t in range(T):
            r, p = real[b, t], pred[b, t]
            mse_acc += float(np.mean((r.astype(np.float64) - p.astype(np.float64)) ** 2))
            if calc_ssim:
                if is_mnist:
                    # round to B/W before SSIM (extreme sensitivity otherwise)
                    rg = rgb_to_grayscale_uint8(np.round(r))
                    pg = rgb_to_grayscale_uint8(np.round(p))
                else:
                    rg = rgb_to_grayscale_uint8(r)
                    pg = rgb_to_grayscale_uint8(p)
                ssim_acc += ssim_grayscale(pg, rg)
        mse = mse_acc / T
        out["mse"].append(mse)
        out["psnr"].append(10 * np.log10(1.0 / max(mse, 1e-20)))
        out["ssim"].append(ssim_acc / T if calc_ssim else float("nan"))
    return out
