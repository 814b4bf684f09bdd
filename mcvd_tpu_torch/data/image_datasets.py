"""Image datasets as single-frame videos (counterpart of
`mcvd_tpu/data/image_datasets.py`; upstream datasets/__init__.py:53-159):
each __getitem__ returns a (1, H, W, C) float32 "video" in [0,1] and a
target, so the image configs run through the video pipeline (num_frames=1,
num_frames_cond=0 is unconditional image diffusion).

CIFAR-10 (its python pickles), FFHQ (StyleGAN's TFRecords of raw CHW
uint8, through the pure-Python reader `tfrecord.py`), CelebA (JPEG files),
LSUN (encoded images in LMDB, through `lmdb_io.py`) and ImageFolder trees
(ImageNet's layout). The encoded images go through `codecs.decode_image`
and `resize.resize_bilinear`, which give PIL's `convert("RGB")` and
BILINEAR resize bit for bit, so every item equals the JAX package's.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from .codecs import decode_image
from .lmdb_io import LMDBReader
from .resize import resize_bilinear
from .tfrecord import read_examples


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


class FFHQTFRecordsDataset(_ImageBase):
    """StyleGAN's FFHQ shards, `*r{resolution:02d}.tfrecords` (else any
    `*.tfrecords`) under `data_path`: each example's bytes feature 'data'
    holds raw CHW uint8 and its int64 'shape' the shape (upstream
    datasets/ffhq_tfrecords.py, which needs TensorFlow). Every image is read
    at construction."""

    def __init__(self, data_path: str, resolution: int = 256, random_flip: bool = False,
                 seed: int = 0):
        super().__init__(seed, random_flip)
        paths = sorted(glob.glob(os.path.join(data_path, f"*r{resolution:02d}.tfrecords"))
                       or glob.glob(os.path.join(data_path, "*.tfrecords")))
        if not paths:
            raise FileNotFoundError(f"no .tfrecords under {data_path}")
        self.images = []
        for p in paths:
            for ex in read_examples(p):
                shape = [int(d) for d in ex["shape"]]
                arr = np.frombuffer(b"".join(ex["data"]), np.uint8).reshape(shape)
                self.images.append(arr.transpose(1, 2, 0))   # CHW -> HWC

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        return self._maybe_flip(_to_video(self.images[index]), index), 0


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _resize_short_side_crop(arr: np.ndarray, size: int) -> np.ndarray:
    """Resize so the short side is `size` (BILINEAR, the long side rounded
    as Python rounds), then centre-crop to size x size."""
    h, w = arr.shape[:2]
    scale = size / min(w, h)
    arr = resize_bilinear(arr, (max(size, round(w * scale)), max(size, round(h * scale))))
    return _center_crop(arr, size)


class CelebADataset(_ImageBase):
    """torchvision's CelebA layout: <root>/celeba/img_align_celeba/*.jpg and
    list_eval_partition.txt (0 train, 1 valid, 2 test). Upstream's transform
    (datasets/__init__.py:60-84): CenterCrop(140), Resize(image_size)
    [, RandomHorizontalFlip]."""

    _SPLITS = {"train": 0, "valid": 1, "test": 2}

    def __init__(self, data_path: str, split: str = "train", image_size: int = 64,
                 random_flip: bool = False, seed: int = 0):
        super().__init__(seed, random_flip)
        base = os.path.join(data_path, "celeba")
        if not os.path.isdir(base):
            base = data_path
        self.img_dir = os.path.join(base, "img_align_celeba")
        self.image_size = image_size
        want = self._SPLITS[split]
        self.files = []
        with open(os.path.join(base, "list_eval_partition.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2 and int(parts[1]) == want:
                    self.files.append(parts[0])

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        arr = _center_crop(decode_image(_read(os.path.join(self.img_dir, self.files[index]))),
                           140)
        arr = resize_bilinear(arr, (self.image_size, self.image_size))
        return self._maybe_flip(_to_video(arr), index), 0


class LSUNDataset(_ImageBase):
    """LSUN categories from their LMDB environments
    (`<root>/<category>_<split>_lmdb/data.mdb`, values encoded images: WebP
    in LSUN's own export, PNG or JPEG elsewhere). Upstream: torchvision
    `datasets.LSUN` (datasets/__init__.py:87-114) with Resize(image_size),
    CenterCrop(image_size) [, RandomHorizontalFlip]. As torchvision does, the
    key list is walked once (keys only) and kept beside the environment in
    `_keys_cache.pkl`."""

    def __init__(self, data_path: str, category: str, split: str = "train",
                 image_size: int = 64, random_flip: bool = False, seed: int = 0):
        super().__init__(seed, random_flip)
        env_dir = os.path.join(data_path, f"{category}_{split}_lmdb")
        if not os.path.isdir(env_dir) and os.path.isdir(data_path) \
                and data_path.endswith("_lmdb"):
            env_dir = data_path
        self._db = LMDBReader(env_dir)
        self.image_size = image_size
        cache = os.path.join(env_dir, "_keys_cache.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                self.keys = pickle.load(f)
        else:
            self.keys = list(self._db.keys())
            try:
                with open(cache, "wb") as f:
                    pickle.dump(self.keys, f)
            except OSError:
                pass   # read-only media: walk the keys again next time

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        arr = _resize_short_side_crop(decode_image(self._db.get(self.keys[index])),
                                      self.image_size)
        return self._maybe_flip(_to_video(arr), index), 0


class ImageFolderDataset(_ImageBase):
    """<root>/<class>/*.{png,jpg,jpeg,bmp,webp} (ImageNet's layout; upstream
    datasets/imagenet.py): classes in sorted order, optionally kept to
    `classes` (indices or names), files sorted; each image resized on its
    short side to image_size, centre-cropped (upstream's val transform; the
    JAX package replaces the train RandomResizedCrop by it) [, flipped]."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

    def __init__(self, data_path: str, image_size: int = 64, random_flip: bool = False,
                 seed: int = 0, classes=None):
        super().__init__(seed, random_flip)
        self.image_size = image_size
        self.samples = []
        class_names = sorted(d for d in os.listdir(data_path)
                             if os.path.isdir(os.path.join(data_path, d)))
        if classes is not None:
            keep = set(classes)
            class_names = [c for i, c in enumerate(class_names) if i in keep or c in keep]
        for ci, cname in enumerate(class_names):
            cdir = os.path.join(data_path, cname)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(self.EXTS):
                    self.samples.append((os.path.join(cdir, fn), ci))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        path, target = self.samples[index]
        arr = _resize_short_side_crop(decode_image(_read(path)), self.image_size)
        return self._maybe_flip(_to_video(arr), index), target
