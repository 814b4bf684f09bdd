"""Dataset converters to the sharded HDF5 store (counterpart of
`mcvd_tpu/data/converters.py`; upstream datasets/bair_convert.py and
cityscapes_convert.py), written by the port's `h5.HDF5Maker`. Run as
`python -m mcvd_tpu_torch.tools.convert_dataset {bair,cityscapes}`.

- BAIR: the TFRecords (pure-Python reader, `tfrecord.py`), each example's
  `{t}/image_aux1/encoded` frames (else `image_main`), PNG or JPEG decoded
  by `codecs.decode_image` (as RGB), or raw 64x64x3 bytes.
- Cityscapes: `leftImg8bit_sequence/<split>/<city>/*.png`, one video per
  (city, sequence), each frame centre-cropped to a square and resized to
  `image_size` with cv2's INTER_AREA (`resize.resize_area`: the frame side
  must be a multiple of it, as 1024 is of 128).

The AVI converters (KTH, UCF101, Kinetics-600) are not ported: they need a
video decoder. Shards written by the JAX package's converters on any host
with cv2 are the port's input as they are.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .codecs import FormatError, decode_image
from .h5 import HDF5Maker
from .resize import resize_area
from .tfrecord import read_examples


def _frame_keys(ex, kind):
    return sorted((k for k in ex if k.endswith(f"{kind}/encoded")),
                  key=lambda s: int(s.split("/")[0]))


def bair_convert(bair_dir: str, out_dir: str, split: str = "train",
                 vids_per_shard: int = 100000, force: bool = False) -> int:
    """BAIR TFRecords under `bair_dir/split` -> shards in `out_dir/split`;
    returns the number of videos."""
    maker = HDF5Maker(os.path.join(out_dir, split), num_per_shard=vids_per_shard, force=force,
                      video=True)
    records = sorted(set(glob.glob(os.path.join(bair_dir, split, "*.tfrecord*"))))
    if not records:
        raise FileNotFoundError(f"no tfrecords under {bair_dir}/{split}")
    count = 0
    for rec in records:
        for ex in read_examples(rec):
            keys = _frame_keys(ex, "image_aux1") or _frame_keys(ex, "image_main")
            if not keys:
                continue
            frames = []
            for k in keys:
                raw = ex[k][0]
                try:
                    frames.append(decode_image(raw))
                except FormatError:   # raw RGB bytes
                    frames.append(np.frombuffer(raw, np.uint8).reshape(64, 64, 3))
            maker.add_data(frames, dtype="uint8")
            count += 1
    maker.close()
    return count


def cityscapes_convert(city_dir: str, out_dir: str, split: str = "train",
                       image_size: int = 128, vids_per_shard: int = 100000,
                       force: bool = False) -> int:
    """Cityscapes leftImg8bit_sequence frames -> shards in `out_dir/split`,
    one video per (city, sequence); returns the number of videos."""
    seq_dir = os.path.join(city_dir, "leftImg8bit_sequence", split)
    pngs = sorted(glob.glob(os.path.join(seq_dir, "*", "*.png")))
    if not pngs:
        raise FileNotFoundError(f"no frames under {seq_dir}")
    groups = {}
    for p in pngs:
        city, seq = os.path.basename(p).split("_")[:2]   # city_seq_frame_leftImg8bit.png
        groups.setdefault((city, seq), []).append(p)
    maker = HDF5Maker(os.path.join(out_dir, split), num_per_shard=vids_per_shard, force=force,
                      video=True)
    for key in sorted(groups):
        frames = []
        for p in sorted(groups[key]):
            with open(p, "rb") as f:
                img = decode_image(f.read())
            h, w = img.shape[:2]
            w0 = (w - h) // 2
            frames.append(resize_area(img[:, w0:w0 + h], (image_size, image_size)))
        maker.add_data(frames, dtype="uint8")
    maker.close()
    return len(groups)
