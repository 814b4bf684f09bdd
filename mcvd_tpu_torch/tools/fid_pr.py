"""FID and kNN precision/recall between two sample sets (counterpart of
`tools/fid_pr.py`; upstream evaluation/fid_score_OLD.py, pr.py and
nearest_neighbor.py through one entry point):

    python -m mcvd_tpu_torch.tools.fid_pr REAL GEN [--weights inception.pt]
        [--k 3] [--batch 50] [--no-pr] [--nn K --nn-samples 10
        --nn-out nearest_neighbors.png] [--device cpu]

REAL and GEN are each a .npy/.npz of (N, H, W, C) images (in [0, 1], or 0-255
if the largest value passes 1.5) or a directory of png/jpg/jpeg/bmp files,
decoded by `data.codecs` as PIL's convert("RGB") would. The Inception
network (`eval.fid.make_inception_embedder`) runs on the card unless
`--device cpu`. The weights come from --weights, else $MCVD_WEIGHTS_DIR,
else `weights/` in the temporary directory (`eval/weights.py`; for a run
without the real file, `eval.standins.write_standins` writes a seeded
stand-in). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..data.codecs import decode_image, encode_png


def load_images(path: str) -> np.ndarray:
    """A .npy/.npz file or a directory of images -> (N, H, W, C) float32 in
    [0, 1]."""
    if os.path.isfile(path) and path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if isinstance(arr, np.lib.npyio.NpzFile):
            arr = arr[list(arr.files)[0]]
        arr = np.asarray(arr, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return arr
    files = sorted(f for ext in ("png", "jpg", "jpeg", "bmp")
                   for f in glob.glob(os.path.join(path, f"*.{ext}")))
    if not files:
        raise FileNotFoundError(f"no images or arrays at {path}")
    imgs = []
    for f in files:
        with open(f, "rb") as fh:
            imgs.append(decode_image(fh.read()).astype(np.float32) / 255.0)
    return np.stack(imgs)


def nearest_neighbor_grid(real: np.ndarray, gen: np.ndarray, feats_real: np.ndarray,
                          feats_gen: np.ndarray, feats_gen_flip: np.ndarray, k: int,
                          n_samples: int, out_path: str) -> np.ndarray:
    """Memorisation check (upstream evaluation/nearest_neighbor.py:70-113):
    for each of the first `n_samples` generated samples, its k nearest real
    images by Inception-feature distance (the smaller over the sample and its
    horizontal flip), written as a PNG grid, a row [sample, nn_1..nn_k] per
    sample. Returns the (n, k) neighbour indices."""
    n = min(n_samples, len(gen))
    d = np.linalg.norm(feats_gen[:n, None] - feats_real[None], axis=-1)
    d_flip = np.linalg.norm(feats_gen_flip[:n, None] - feats_real[None], axis=-1)
    nn_idx = np.argsort(np.minimum(d, d_flip), axis=1)[:, :k]
    rows = [np.concatenate([gen[i]] + [real[j] for j in nn_idx[i]], axis=1) for i in range(n)]
    grid = (np.clip(np.concatenate(rows, axis=0), 0, 1) * 255).astype(np.uint8)
    with open(out_path, "wb") as f:
        f.write(encode_png(grid))
    return nn_idx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("real")
    ap.add_argument("gen")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--no-pr", action="store_true")
    ap.add_argument("--nn", type=int, default=0, metavar="K",
                    help="also write a grid of each sample's K nearest real images")
    ap.add_argument("--nn-samples", type=int, default=10)
    ap.add_argument("--nn-out", default="nearest_neighbors.png")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..eval import weights as W
    from ..eval.fid import (activation_statistics, calculate_frechet_distance, get_fid_pr,
                            make_inception_embedder)

    path = W.find_weights(args.weights, W.INCEPTION)
    if path is None:
        raise SystemExit("no inception weights found (--weights / $MCVD_WEIGHTS_DIR / "
                         "$TMPDIR/weights); eval.standins.write_standins writes a stand-in")
    embed = make_inception_embedder(path, device=args.device, batch_size=args.batch)
    real, gen = load_images(args.real), load_images(args.gen)
    fr, fg = np.asarray(embed(real)), np.asarray(embed(gen))
    if args.no_pr:
        fid = calculate_frechet_distance(*activation_statistics(fr), *activation_statistics(fg))
        out = {"fid": round(float(fid), 4), "n_real": len(real), "n_gen": len(gen)}
    else:
        m = get_fid_pr(fr, fg, k=args.k)
        out = {"fid": round(float(m["fid"]), 4), "n_real": len(real), "n_gen": len(gen),
               "precision": round(float(m["precision"]), 4),
               "recall": round(float(m["recall"]), 4), "k": args.k}
    if args.nn > 0:
        fg_flip = np.asarray(embed(gen[:, :, ::-1]))
        nearest_neighbor_grid(real, gen, fr, fg, fg_flip, k=args.nn, n_samples=args.nn_samples,
                              out_path=args.nn_out)
        out["nn_grid"] = args.nn_out
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
