"""Datasets, loader, transforms and conditioning (counterpart of
`mcvd_tpu/data`; upstream datasets/__init__.py:20-227).

Video datasets give (T, H, W, C) float32 clips in [0, 1]. Ported readers:
StochasticMovingMNIST and MovingMNIST (its deterministic bounce), KTH, BAIR,
Cityscapes and UCF101 (the sharded HDF5 store, read in numpy by `h5.py`)
and CIFAR10 (single-frame videos). CelebA, LSUN, FFHQ and ImageNet raise
NotImplementedError (ROADMAP Queue 1 item 9: they need an image decoder).
"""

from __future__ import annotations

import os

from .conditioning import conditioning_fn, fold_frames, get_mode, unfold_frames
from .h5 import HDF5Dataset, HDF5Maker, KTHMaker, UCFMaker
from .image_datasets import CIFAR10Dataset
from .loader import DataLoader, prefetch_to_device
from .smmnist import StochasticMovingMNIST
from .transforms import data_transform, inverse_data_transform
from .video_datasets import BAIRDataset, CityscapesDataset, KTHDataset, UCF101Dataset

DATASETS = ["CIFAR10", "CELEBA", "LSUN", "FFHQ", "IMAGENET", "MOVINGMNIST",
            "STOCHASTICMOVINGMNIST", "KTH", "BAIR", "CITYSCAPES", "UCF101"]


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def set_epoch(self, epoch):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)


def get_dataset(data_path, config, video_frames_pred=0, start_at=0, seed=0):
    """(train_dataset, test_dataset), clips of num_frames_cond +
    num_frames_future + video_frames_pred frames (upstream
    datasets/__init__.py:162-211), each cut to `data.subset` /
    `data.test_subset` clips where those are > 0. `start_at` is the first
    frame of KTH's test clips."""
    name = config.data.dataset.upper()
    if name not in DATASETS:
        raise ValueError(f"dataset must be one of {DATASETS}, got {name}")
    future = getattr(config.data, "num_frames_future", 0)
    frames_per_sample = config.data.num_frames_cond + future + video_frames_pred
    cache_mb = getattr(config.data, "cache_mb", 1024)

    if name in ("STOCHASTICMOVINGMNIST", "MOVINGMNIST"):
        kw = dict(seq_len=frames_per_sample, num_digits=getattr(config.data, "num_digits", 2),
                  image_size=config.data.image_size, step_length=config.data.step_length,
                  deterministic=name == "MOVINGMNIST")
        dataset = StochasticMovingMNIST(data_path, train=True, seed=seed, **kw)
        test_dataset = StochasticMovingMNIST(data_path, train=False, total_videos=256,
                                             seed=seed + 1, **kw)
    elif name == "KTH":
        dataset = KTHDataset(
            data_path, frames_per_sample=frames_per_sample, train=True, random_time=True,
            random_horizontal_flip=config.data.random_flip, seed=seed, cache_mb=cache_mb)
        test_dataset = KTHDataset(
            data_path, frames_per_sample=frames_per_sample, train=False, random_time=True,
            random_horizontal_flip=False, total_videos=256, start_at=start_at,
            seed=seed + 1, cache_mb=cache_mb)
    elif name in ("BAIR", "CITYSCAPES"):
        cls = BAIRDataset if name == "BAIR" else CityscapesDataset
        dataset = cls(
            os.path.join(data_path, "train"), frames_per_sample=frames_per_sample,
            random_time=True, random_horizontal_flip=config.data.random_flip,
            color_jitter=getattr(config.data, "color_jitter", 0.0), seed=seed,
            cache_mb=cache_mb)
        # the JAX package caps Cityscapes' test split at 256 clips, not BAIR's
        test_dataset = cls(
            os.path.join(data_path, "test"), frames_per_sample=frames_per_sample,
            random_time=True, random_horizontal_flip=False, color_jitter=0.0,
            total_videos=256 if name == "CITYSCAPES" else -1, seed=seed + 1)
    elif name == "UCF101":
        kw = dict(frames_per_sample=frames_per_sample, image_size=config.data.image_size,
                  random_time=True)
        dataset = UCF101Dataset(data_path, train=True,
                                random_horizontal_flip=config.data.random_flip, seed=seed,
                                cache_mb=cache_mb, **kw)
        test_dataset = UCF101Dataset(data_path, train=False, random_horizontal_flip=False,
                                     total_videos=256, seed=seed + 1, **kw)
    elif name == "CIFAR10":
        dataset = CIFAR10Dataset(data_path, train=True, random_flip=config.data.random_flip,
                                 seed=seed)
        test_dataset = CIFAR10Dataset(data_path, train=False, seed=seed + 1)
    else:
        raise NotImplementedError(
            f"dataset {name}: not ported yet (ROADMAP Queue 1 item 9: its images are "
            "decoded by PIL or read from TFRecords)")

    # clamp to the split: a larger subset would fail mid-epoch
    subset_num = getattr(config.data, "subset", -1)
    if subset_num > 0:
        dataset = Subset(dataset, list(range(min(subset_num, len(dataset)))))
    test_subset_num = getattr(config.data, "test_subset", -1)
    if test_subset_num > 0:
        test_dataset = Subset(test_dataset,
                              list(range(min(test_subset_num, len(test_dataset)))))
    return dataset, test_dataset


__all__ = ["BAIRDataset", "CIFAR10Dataset", "CityscapesDataset", "DATASETS", "DataLoader",
           "HDF5Dataset", "HDF5Maker", "KTHDataset", "KTHMaker", "StochasticMovingMNIST",
           "Subset", "UCF101Dataset", "UCFMaker", "conditioning_fn", "data_transform",
           "fold_frames", "get_dataset", "get_mode", "inverse_data_transform",
           "prefetch_to_device", "unfold_frames"]
