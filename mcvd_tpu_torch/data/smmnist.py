"""Stochastic Moving MNIST synthesized on the fly (counterpart of
`mcvd_tpu/data/smmnist.py`; upstream datasets/stochastic_moving_mnist.py:24-128):
two 32 px digits bouncing in a 64x64 canvas with velocity resampling at the
walls. MNIST digits are read from the standard idx files under data_path
(MNIST/raw/... or directly); if absent and `synthetic_ok`, procedurally
generated glyph blobs are used.

The JAX package's code as it is, with its two generators: `dataset[i]`, the
per-item numpy path, and `get_batch(indices)`, the loader's batch path, on
the host C++ synthesizer (`native.smmnist_synthesize_batch`, splitmix64
draws, other clips than the per-item path's). Each is bit-equal to the JAX
package's. Unlike the JAX package, `get_batch` does not fall back to the
per-item path: without g++ it raises.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from . import native


def _find_idx_file(data_path: str, name: str) -> Optional[str]:
    candidates = [
        os.path.join(data_path, name),
        os.path.join(data_path, name + ".gz"),
        os.path.join(data_path, "MNIST", "raw", name),
        os.path.join(data_path, "MNIST", "raw", name + ".gz"),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def load_mnist_images(data_path: str, train: bool = True) -> Optional[np.ndarray]:
    """Read MNIST idx3 images -> (N, 28, 28) uint8, or None if not found."""
    name = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    path = _find_idx_file(data_path, name)
    if path is None:
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def _synthetic_digits(n: int = 256, size: int = 28, seed: int = 0) -> np.ndarray:
    """Procedural digit-like blobs for MNIST-free smoke tests."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    digits = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        img = np.zeros((size, size), np.float32)
        for _ in range(rng.integers(2, 5)):
            cx, cy = rng.uniform(6, size - 6, 2)
            sx, sy = rng.uniform(1.5, 4.0, 2)
            img += np.exp(-(((xs - cx) / sx) ** 2 + ((ys - cy) / sy) ** 2))
        img = np.clip(img / max(img.max(), 1e-6), 0, 1)
        digits[i] = (img * 255).astype(np.uint8)
    return digits


def _bilinear_resize(img: np.ndarray, out_hw: int) -> np.ndarray:
    """Simple bilinear resize (align_corners=False convention) for digit
    28->32 scaling; float32 in [0,1]."""
    H, W = img.shape
    scale_y, scale_x = H / out_hw, W / out_hw
    y = (np.arange(out_hw) + 0.5) * scale_y - 0.5
    x = (np.arange(out_hw) + 0.5) * scale_x - 0.5
    y0 = np.clip(np.floor(y).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(y - y0, 0, 1)[:, None]
    wx = np.clip(x - x0, 0, 1)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (
        a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
    ).astype(np.float32)


class StochasticMovingMNIST:
    """Bouncing-MNIST synthesizer (reference semantics preserved: random
    start/velocity, resample-at-wall, additive compositing clipped to 1)."""

    def __init__(self, data_root, train=True, seq_len=20, num_digits=2,
                 image_size=64, deterministic=False, step_length=0.1,
                 total_videos=-1, with_target=False, seed=0, synthetic_ok=True):
        self.seq_len = seq_len
        self.num_digits = num_digits
        self.image_size = image_size
        self.deterministic = deterministic
        self.with_target = with_target
        self.digit_size = 32
        self.channels = 1
        self._seed = seed
        self._epoch = 0

        raw = load_mnist_images(data_root, train=train)
        if raw is None:
            if not synthetic_ok:
                raise FileNotFoundError(
                    f"MNIST idx files not found under {data_root}; place "
                    "train-images-idx3-ubyte[.gz] there (or MNIST/raw/)"
                )
            raw = _synthetic_digits(512 if train else 128, seed=0 if train else 1)
        # pre-resize all digits to 32x32 float [0,1]
        self.digits = np.stack(
            [_bilinear_resize(d.astype(np.float32) / 255.0, self.digit_size) for d in raw]
        )
        self.N = len(self.digits) if total_videos == -1 else total_videos

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return self.N

    def get_batch(self, indices):
        """(clips (B, T, sz, sz, 1), targets) of the items `indices`, from the
        host synthesizer: the loader's batch path."""
        out = native.smmnist_synthesize_batch(
            self.digits, indices, seed=self._seed, epoch=self._epoch, seq_len=self.seq_len,
            image_size=self.image_size, num_digits=self.num_digits,
            deterministic=self.deterministic)
        if self.with_target:
            return out, (out >= 0.5).astype(np.float32)
        return out, np.zeros(len(indices), np.int64)

    def __getitem__(self, index):
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, self._epoch, int(index)])
        )
        sz, ds = self.image_size, self.digit_size
        x = np.zeros((self.seq_len, sz, sz, self.channels), np.float32)
        for _ in range(self.num_digits):
            digit = self.digits[rng.integers(len(self.digits))]
            sx = int(rng.integers(max(sz - ds, 1)))
            sy = int(rng.integers(max(sz - ds, 1)))
            dx = int(rng.integers(-4, 5))
            dy = int(rng.integers(-4, 5))
            for t in range(self.seq_len):
                if sy < 0:
                    sy = 0
                    if self.deterministic:
                        dy = -dy
                    else:
                        dy = int(rng.integers(1, 5))
                        dx = int(rng.integers(-4, 5))
                elif sy >= sz - ds:
                    sy = sz - ds - 1
                    if self.deterministic:
                        dy = -dy
                    else:
                        dy = int(rng.integers(-4, 0))
                        dx = int(rng.integers(-4, 5))
                if sx < 0:
                    sx = 0
                    if self.deterministic:
                        dx = -dx
                    else:
                        dx = int(rng.integers(1, 5))
                        dy = int(rng.integers(-4, 5))
                elif sx >= sz - ds:
                    sx = sz - ds - 1
                    if self.deterministic:
                        dx = -dx
                    else:
                        dx = int(rng.integers(-4, 0))
                        dy = int(rng.integers(-4, 5))
                x[t, sy : sy + ds, sx : sx + ds, 0] += digit
                sy += dy
                sx += dx
        np.clip(x, 0.0, 1.0, out=x)
        if self.with_target:
            return x, (x >= 0.5).astype(np.float32)
        return x, 0
