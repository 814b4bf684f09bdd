"""Image datasets as single-frame videos (counterpart of
`mcvd_tpu/data/image_datasets.py`; upstream datasets/__init__.py:53-159):
each __getitem__ returns a (1, H, W, C) float32 "video" in [0,1] and a
target, so the image configs run through the video pipeline (num_frames=1,
num_frames_cond=0 is unconditional image diffusion).

CIFAR-10 (its python pickles) is ported. CelebA, LSUN and ImageFolder
decode JPEG/PNG through PIL, and FFHQ reads TFRecords for an ncsnv2 config;
`get_dataset` refuses them (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def _to_video(img: np.ndarray) -> np.ndarray:
    """HWC uint8/float -> (1, H, W, C) float32 in [0,1]."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)[None]


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return arr[top:top + size, left:left + size]


class _ImageBase:
    """Shared flip/rng plumbing (mirrors the video datasets' contract)."""

    def __init__(self, seed: int = 0, random_flip: bool = False):
        self._seed = seed
        self._epoch = 0
        self.random_flip = random_flip

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _rng(self, index: int):
        return np.random.default_rng(
            np.random.SeedSequence([self._seed, self._epoch, int(index)]))

    def _maybe_flip(self, video: np.ndarray, index: int) -> np.ndarray:
        if self.random_flip and self._rng(index).integers(2) == 0:
            return video[:, :, ::-1].copy()
        return video


class CIFAR10Dataset(_ImageBase):
    """Standard CIFAR-10 python pickles (cifar-10-batches-py/data_batch_*,
    test_batch), upstream's torchvision CIFAR10 (datasets/__init__.py:54-57)
    without its download."""

    def __init__(self, data_path: str, train: bool = True,
                 random_flip: bool = False, seed: int = 0):
        super().__init__(seed, random_flip)
        base = os.path.join(data_path, "cifar-10-batches-py")
        if not os.path.isdir(base):
            base = data_path
        names = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        datas, labels = [], []
        for n in names:
            with open(os.path.join(base, n), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            datas.append(np.asarray(d[b"data"], np.uint8))
            labels.extend(d.get(b"labels", d.get(b"fine_labels", [])))
        # (N, 3072) row-major CHW -> (N, 32, 32, 3)
        self.images = np.concatenate(datas).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)
        self.targets = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        video = self._maybe_flip(_to_video(self.images[index]), index)
        return video, int(self.targets[index])
