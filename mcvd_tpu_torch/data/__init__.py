"""Datasets, loader, transforms and conditioning (counterpart of
`mcvd_tpu/data`; upstream datasets/__init__.py:20-227).

Video datasets give (T, H, W, C) float32 clips in [0, 1]. Ported readers:
StochasticMovingMNIST and MovingMNIST (its deterministic bounce); the
others raise NotImplementedError (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from .conditioning import conditioning_fn, fold_frames, get_mode, unfold_frames
from .loader import DataLoader, prefetch_to_device
from .smmnist import StochasticMovingMNIST
from .transforms import data_transform, inverse_data_transform

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
    `data.test_subset` clips where those are > 0. `start_at` is the KTH
    reader's, which is not ported."""
    name = config.data.dataset.upper()
    if name not in DATASETS:
        raise ValueError(f"dataset must be one of {DATASETS}, got {name}")
    if name not in ("STOCHASTICMOVINGMNIST", "MOVINGMNIST"):
        raise NotImplementedError(
            f"dataset {name}: not ported yet (ROADMAP Queue 1 item 9: the data readers)")
    future = getattr(config.data, "num_frames_future", 0)
    frames_per_sample = config.data.num_frames_cond + future + video_frames_pred
    kw = dict(seq_len=frames_per_sample, num_digits=getattr(config.data, "num_digits", 2),
              image_size=config.data.image_size, step_length=config.data.step_length,
              deterministic=name == "MOVINGMNIST")
    dataset = StochasticMovingMNIST(data_path, train=True, seed=seed, **kw)
    test_dataset = StochasticMovingMNIST(data_path, train=False, total_videos=256,
                                         seed=seed + 1, **kw)
    # clamp to the split: a larger subset would fail mid-epoch
    subset_num = getattr(config.data, "subset", -1)
    if subset_num > 0:
        dataset = Subset(dataset, list(range(min(subset_num, len(dataset)))))
    test_subset_num = getattr(config.data, "test_subset", -1)
    if test_subset_num > 0:
        test_dataset = Subset(test_dataset,
                              list(range(min(test_subset_num, len(test_dataset)))))
    return dataset, test_dataset


__all__ = ["DATASETS", "DataLoader", "StochasticMovingMNIST", "Subset", "conditioning_fn",
           "data_transform", "fold_frames", "get_dataset", "get_mode",
           "inverse_data_transform", "prefetch_to_device", "unfold_frames"]
