"""Convert a raw dataset to the sharded HDF5 store the video readers take
(counterpart of `tools/convert_dataset.py` for the formats the port
decodes):

    python -m mcvd_tpu_torch.tools.convert_dataset bair --in BAIR --out BAIR_h5 --split train
    python -m mcvd_tpu_torch.tools.convert_dataset cityscapes --in CS --out CS_h5 --split train

KTH and UCF101 (AVI) are converted by the JAX package's tool on a host with
cv2; its shards are read by the port as they are.
"""

from __future__ import annotations

import argparse

from ..data import converters


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dataset", choices=["bair", "cityscapes"])
    p.add_argument("--in", dest="in_dir", required=True)
    p.add_argument("--out", dest="out_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--image_size", type=int, default=128, help="cityscapes frame size")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    if args.dataset == "bair":
        n = converters.bair_convert(args.in_dir, args.out_dir, split=args.split,
                                    force=args.force)
    else:
        n = converters.cityscapes_convert(args.in_dir, args.out_dir, split=args.split,
                                          image_size=args.image_size, force=args.force)
    print("converted:", n)


if __name__ == "__main__":
    main()
