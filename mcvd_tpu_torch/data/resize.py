"""The two resizes the image paths run, bit for bit, without PIL or cv2.

`resize_bilinear` is Pillow's `Image.resize(size, Image.BILINEAR)` of a
uint8 image (Resample.c): antialiased, the triangle filter's support
widened by the downscale factor; coefficients normalised in double, then
rounded to 22-bit fixed point (`PRECISION_BITS = 32 - 8 - 2`, negative ones
rounded the other way); a horizontal pass over the rows the vertical pass
needs, rounded and clipped to uint8, then the vertical pass. The
coefficient tables are computed in float64 in the order Resample.c adds
them, so the doubles are the same; the integer passes run in host C++
(`csrc/host/resize.cpp`), which releases the GIL, so loader threads resize
in parallel. `torch.nn.functional.interpolate` (antialias=True) is not
bit-equal to it.

`resize_area` is cv2's `INTER_AREA` at an integer factor (its
`resize_area_fast`): each output is the mean of a factor x factor block, a
uint8 2x2 block as (sum + 2) >> 2 (cv2's vector path), any other factor as
the float32 sum times float32(1 / area), rounded half to even.
"""

from __future__ import annotations

import functools

import numpy as np

from . import native

PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the
    bilinear filter: (xmin, xmax, fixed-point weights (out, k)), kept per
    size pair (a dataset resizes to few)."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xx = np.arange(out_size, dtype=np.float64)
    center = 0.0 + (xx + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):
        arg = (x + xmin - center + 0.5) * ss
        w = np.where(np.abs(arg) < 1.0, 1.0 - np.abs(arg), 0.0)
        w = np.where(x < xmax, w, 0.0)
        k[:, x] = w
        ww += w            # in order, as the C loop adds
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    k = np.where(np.arange(ksize)[None, :] < xmax[:, None], k, 0.0)
    scaled = k * (1 << PRECISION_BITS)
    fixed = np.where(k < 0, (-0.5 + scaled), (0.5 + scaled))
    out = xmin, xmax, np.trunc(fixed).astype(np.int64)
    for a in out:   # shared by every caller through the cache
        a.setflags(write=False)
    return out


def _pass(img: np.ndarray, axis: int, xmin, xmax, kk) -> np.ndarray:
    """One 8-bit pass along `axis` (0 rows, 1 columns) of (H, W, C) uint8,
    in host C++ (`csrc/host/resize.cpp`, Resample.c's integer loops)."""
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    n_out = kk.shape[0]
    bounds = np.ascontiguousarray(np.stack([xmin, xmax], 1), np.int32)
    k32 = np.ascontiguousarray(kk, np.int32)
    lib = native.load_library()
    if axis == 1:
        out = np.empty((h, n_out, c), np.uint8)
        lib.resample_horizontal(img.ctypes.data, h, w, c, out.ctypes.data, n_out,
                                bounds.ctypes.data, k32.ctypes.data, k32.shape[1])
    else:
        out = np.empty((n_out, w, c), np.uint8)
        lib.resample_vertical(img.ctypes.data, h, w, c, out.ctypes.data, n_out,
                              bounds.ctypes.data, k32.ctypes.data, k32.shape[1])
    return out


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """Pillow's BILINEAR resize of (H, W, C) uint8 to `size` = (width,
    height), as `Image.fromarray(img).resize(size, Image.BILINEAR)`."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bilinear takes (H, W, C) uint8, got {img.dtype} {img.shape}")
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize_bilinear: size {size}")
    need_h, need_v = out_w != w, out_h != h
    vmin, vmax, vk = _coeffs(h, out_h)
    if need_h:
        first = int(vmin[0])
        last = int(vmin[-1] + vmax[-1])
        hmin, hmax, hk = _coeffs(w, out_w)
        img = _pass(img[first:last], 1, hmin, hmax, hk)
        vmin = vmin - first
    if need_v:
        img = _pass(img, 0, vmin, vmax, vk)
    return np.ascontiguousarray(img)


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """cv2's INTER_AREA of (H, W, C) or (H, W) uint8 to `size` = (width,
    height), where H and W are that size times one integer factor each."""
    img = np.asarray(img)
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if img.dtype != np.uint8 or h % out_h or w % out_w:
        raise ValueError(f"resize_area takes uint8 at an integer factor: {img.shape} -> "
                         f"{(out_h, out_w)}")
    fy, fx = h // out_h, w // out_w
    if fy == 1 and fx == 1:
        return img.copy()
    blocks = img.reshape(out_h, fy, out_w, fx, *img.shape[2:]).astype(np.int32)
    total = blocks.sum(axis=(1, 3))
    if fy == 2 and fx == 2 and (img.ndim == 2 or img.shape[2] in (1, 3, 4)):
        return ((total + 2) >> 2).astype(np.uint8)
    mean = total.astype(np.float32) * np.float32(1.0 / (fy * fx))
    return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
