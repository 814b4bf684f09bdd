"""Real-video datasets over the sharded HDF5 store (counterpart of
`mcvd_tpu/data/video_datasets.py`, the JAX package's code as it is on the
port's numpy HDF5 reader, `h5.py`, so a clip is bit-equal to the JAX
package's; upstream datasets/kth.py, bair.py, cityscapes.py, ucf101.py).

Each __getitem__ returns (video (T, H, W, C) float32 in [0,1], target int).
The frame window is drawn per access from a generator seeded by (seed,
epoch, index), so any number of loader workers gives the same clips.
"""

from __future__ import annotations

import collections
import os
import pickle
import threading

import numpy as np

from .h5 import HDF5Dataset


def _to_float01(img: np.ndarray) -> np.ndarray:
    """uint8 HW[C] -> float32 HWC in [0,1] (torchvision ToTensor semantics)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


def _hflip(frames: np.ndarray) -> np.ndarray:
    return frames[:, :, ::-1, :]


def _hue_jitter(video: np.ndarray, max_hue: float, rng) -> np.ndarray:
    """ColorJitter(hue=h): rotate hue by u~U(-h, h) (h in [0, 0.5])."""
    if max_hue <= 0:
        return video
    shift = rng.uniform(-max_hue, max_hue)
    r, g, b = video[..., 0], video[..., 1], video[..., 2]
    maxc = video.max(axis=-1)
    minc = video.min(axis=-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0.0)
    dc = np.where(deltac == 0, 1.0, deltac)
    rc = (maxc - r) / dc
    gc = (maxc - g) / dc
    bc = (maxc - b) / dc
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = (h + shift) % 1.0
    # hsv -> rgb
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.stack(
        [
            np.choose(i, [v, q, p, p, t, v]),
            np.choose(i, [t, v, v, q, p, p]),
            np.choose(i, [p, p, t, v, v, q]),
        ],
        axis=-1,
    )
    return out.astype(np.float32)


class _BaseVideoDataset:
    def __init__(self, seed: int = 0, cache_mb: int = 1024):
        self._seed = seed
        self._epoch = 0
        # decoded-video LRU cache: the store keeps every frame as its own
        # LZF dataset, so a random 15-frame window costs ~15 dataset reads
        # and decodes. Decoding the whole video once and caching it spreads
        # that over the epochs. Budgeted in MB, thread safe (the loader's
        # worker pool shares the dataset).
        self._cache_budget = int(cache_mb * 1e6)
        self._cache = collections.OrderedDict()
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _rng(self, index: int):
        return np.random.default_rng(
            np.random.SeedSequence([self._seed, self._epoch, int(index)])
        )

    def _pick_window(self, rng, n_frames: int, time_idx: int, start_at: int = 0):
        """Sample the temporal window. Call AFTER the flip draw — the rng
        consumption order (flip, then window) is part of the reproducibility
        contract, identical in the cached and windowed-read paths. The end
        bound is n_frames - start_at, NOT n_frames (reference kth.py quirk)."""
        avail = n_frames - start_at
        if self.random_time and avail > self.frames_per_sample:
            time_idx = int(rng.choice(avail - self.frames_per_sample))
        time_idx += start_at
        end = min(time_idx + self.frames_per_sample, avail)
        return time_idx, end

    def _cached_video(self, key, load_fn):
        """load_fn() -> tuple whose np.ndarray members count toward the
        budget. LRU-evicted under the byte budget; budget<=0 disables (the
        caller must then use a windowed read, not a whole-video decode)."""
        with self._cache_lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        val = load_fn()  # outside the lock: slow h5 reads run concurrently
        nbytes = sum(v.nbytes for v in val if isinstance(v, np.ndarray))
        with self._cache_lock:
            if key not in self._cache:
                self._cache[key] = val
                self._cache_bytes += nbytes
                while self._cache_bytes > self._cache_budget and len(self._cache) > 1:
                    _, old = self._cache.popitem(last=False)
                    self._cache_bytes -= sum(
                        v.nbytes for v in old if isinstance(v, np.ndarray))
        return val


class KTHDataset(_BaseVideoDataset):
    """Reference: datasets/kth.py:14-81. Person-based split via persons.pkl;
    grayscale 64x64."""

    def __init__(self, data_dir, frames_per_sample=5, train=True, random_time=True,
                 random_horizontal_flip=True, total_videos=-1, with_target=True,
                 start_at=0, seed=0, cache_mb=1024):
        super().__init__(seed, cache_mb=cache_mb)
        self.data_dir = data_dir
        self.train = train
        self.frames_per_sample = frames_per_sample
        self.random_time = random_time
        self.random_horizontal_flip = random_horizontal_flip
        self.total_videos = total_videos
        self.with_target = with_target
        self.start_at = start_at
        self.videos_ds = HDF5Dataset(data_dir)
        with open(os.path.join(data_dir, "persons.pkl"), "rb") as f:
            self.persons = pickle.load(f)
        self.train_idx = sum([self.persons[p] for p in range(1, 21)], [])
        self.test_idx = sum([self.persons[p] for p in range(21, 26)], [])

    def __len__(self):
        if self.total_videos > 0:
            return self.total_videos
        return len(self.train_idx) if self.train else len(self.test_idx)

    def max_index(self):
        return len(self.train_idx) if self.train else len(self.test_idx)

    def __getitem__(self, index, time_idx=0):
        rng = self._rng(index)
        video_index = round(index / max(len(self) - 1, 1) * (self.max_index() - 1))
        shard_idx, idx_in_shard = self.videos_ds.get_indices(video_index)
        idx = (self.train_idx if self.train else self.test_idx)[int(idx_in_shard)]

        flip = rng.integers(2) == 0 if self.random_horizontal_flip else False

        if self._cache_budget <= 0:
            # cache disabled: decode only the sampled frame window
            with self.videos_ds.opener(self.videos_ds.shard_paths[shard_idx]) as f:
                n = int(f["len"][str(idx)][()])
                time_idx, end = self._pick_window(rng, n, time_idx, self.start_at)
                frames = np.stack(
                    [f[str(idx)][str(i)][()] for i in range(time_idx, end)])
                target = int(f["target"][str(idx)][()])
        else:
            def load():
                with self.videos_ds.opener(self.videos_ds.shard_paths[shard_idx]) as f:
                    n = int(f["len"][str(idx)][()])
                    frames = np.stack([f[str(idx)][str(i)][()] for i in range(n)])
                    target = int(f["target"][str(idx)][()])
                return frames, target

            frames_all, target = self._cached_video((shard_idx, idx), load)
            time_idx, end = self._pick_window(
                rng, frames_all.shape[0], time_idx, self.start_at)
            frames = frames_all[time_idx:end]
        video = np.stack([_to_float01(fr) for fr in frames])
        if flip:
            video = _hflip(video)
        return (video, target) if self.with_target else video


class BAIRDataset(_BaseVideoDataset):
    """Reference: datasets/bair.py:12-76. RGB 64x64, train/test subdirs."""

    def __init__(self, data_path, frames_per_sample=5, random_time=True,
                 random_horizontal_flip=True, color_jitter=0.0, total_videos=-1,
                 with_target=True, seed=0, cache_mb=1024):
        super().__init__(seed, cache_mb=cache_mb)
        self.frames_per_sample = frames_per_sample
        self.random_time = random_time
        self.random_horizontal_flip = random_horizontal_flip
        self.color_jitter = color_jitter
        self.total_videos = total_videos
        self.with_target = with_target
        self.videos_ds = HDF5Dataset(data_path)

    def __len__(self):
        return self.total_videos if self.total_videos > 0 else len(self.videos_ds)

    def max_index(self):
        return len(self.videos_ds)

    def __getitem__(self, index, time_idx=0):
        rng = self._rng(index)
        video_index = round(index / max(len(self) - 1, 1) * (self.max_index() - 1))
        shard_idx, idx_in_shard = self.videos_ds.get_indices(video_index)
        flip = rng.integers(2) == 0 if self.random_horizontal_flip else False

        if self._cache_budget <= 0:
            with self.videos_ds.opener(self.videos_ds.shard_paths[shard_idx]) as f:
                n = int(f["len"][str(idx_in_shard)][()])
                time_idx, end = self._pick_window(rng, n, time_idx)
                frames = np.stack(
                    [f[str(idx_in_shard)][str(i)][()] for i in range(time_idx, end)])
        else:
            def load():
                with self.videos_ds.opener(self.videos_ds.shard_paths[shard_idx]) as f:
                    n = int(f["len"][str(idx_in_shard)][()])
                    frames = np.stack(
                        [f[str(idx_in_shard)][str(i)][()] for i in range(n)])
                return (frames,)

            (frames_all,) = self._cached_video((shard_idx, idx_in_shard), load)
            time_idx, end = self._pick_window(rng, frames_all.shape[0], time_idx)
            frames = frames_all[time_idx:end]
        video = np.stack([_to_float01(fr) for fr in frames])
        if flip:
            video = _hflip(video)
        video = _hue_jitter(video, self.color_jitter, rng)
        return (video, 1) if self.with_target else video


class CityscapesDataset(BAIRDataset):
    """Reference: datasets/cityscapes.py — identical access pattern to BAIR."""


class UCF101Dataset(_BaseVideoDataset):
    """Reference: datasets/ucf101.py:14-86. Frames stored 240x~320-scaled;
    random (train) / center (test) horizontal crop to image_size; test uses
    every 10th video after the train block."""

    def __init__(self, data_path, frames_per_sample=5, image_size=64, train=True,
                 random_time=True, random_horizontal_flip=True, total_videos=-1,
                 skip_videos=0, with_target=True, seed=0, cache_mb=1024):
        super().__init__(seed, cache_mb=cache_mb)
        self.train = train
        self.frames_per_sample = frames_per_sample
        self.image_size = image_size
        self.random_time = random_time
        self.random_horizontal_flip = random_horizontal_flip
        self.total_videos = total_videos
        self.with_target = with_target
        self.videos_ds = HDF5Dataset(data_path)
        with self.videos_ds.opener(self.videos_ds.shard_paths[0]) as f:
            self.num_train_vids = int(f["num_train"][()])
            self.num_test_vids = int(f["num_test"][()]) // 10

    def __len__(self):
        if self.total_videos > 0:
            return self.total_videos
        return self.num_train_vids if self.train else self.num_test_vids

    def max_index(self):
        return self.num_train_vids if self.train else self.num_test_vids

    def __getitem__(self, index, time_idx=0):
        rng = self._rng(index)
        video_index = round(index / max(len(self) - 1, 1) * (self.max_index() - 1))
        if not self.train:
            video_index = video_index * 10 + self.num_train_vids
        shard_idx, idx_in_shard = self.videos_ds.get_indices(video_index)

        width = int(self.image_size / 240 * 320)
        if self.train:
            crop_c = int(rng.integers(width - self.image_size))
        else:
            crop_c = int((width - self.image_size) / 2)
        flip = rng.integers(2) == 0 if self.random_horizontal_flip else False

        if self._cache_budget <= 0:
            with self.videos_ds.opener(self.videos_ds.shard_paths[shard_idx]) as f:
                target = int(f["target"][str(idx_in_shard)][()])
                n = int(f["len"][str(idx_in_shard)][()])
                time_idx, end = self._pick_window(rng, n, time_idx)
                frames = np.stack(
                    [f[str(idx_in_shard)][str(i)][()] for i in range(time_idx, end)])
        else:
            def load():
                with self.videos_ds.opener(self.videos_ds.shard_paths[shard_idx]) as f:
                    target = int(f["target"][str(idx_in_shard)][()])
                    n = int(f["len"][str(idx_in_shard)][()])
                    frames = np.stack(
                        [f[str(idx_in_shard)][str(i)][()] for i in range(n)])
                return frames, target

            frames_all, target = self._cached_video((shard_idx, idx_in_shard), load)
            time_idx, end = self._pick_window(rng, frames_all.shape[0], time_idx)
            frames = frames_all[time_idx:end]
        video = np.stack(
            [_to_float01(fr[:, crop_c : crop_c + self.image_size])
             for fr in frames])
        if flip:
            video = _hflip(video)
        return (video, target) if self.with_target else video
