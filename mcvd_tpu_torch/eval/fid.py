"""FID with kNN precision and recall, and the Inception embedder
(counterpart of `mcvd_tpu/eval/fid.py` and of
`mcvd_tpu/eval/i3d.make_jax_inception_embedder`; upstream
evaluation/fid_PR.py).

The Frechet distance and the kNN manifold precision/recall are numpy on the
host, as in the JAX package; the Frechet math itself is
`video_gen.frechet_from_stats`, shared with FVD. The embedder runs on the
caller's device: a file in the minimal 2d schema becomes
`i3d.SimpleScriptEmbedder2d`; any other TorchScript archive or pickled module
(pt_inception, say) runs as it is, moved to that device. The JAX package runs
that second case as a torch-CPU sidecar; the port has no reason to.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .i3d import build_embedder_from_state_dict, detect_schema, load_embedder_spec
from .video_gen import frechet_from_stats


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID from precomputed statistics (upstream fid_PR.py:53-100): a square
    root that is not finite is taken again with eps*I on both covariances."""
    return frechet_from_stats(mu1, sigma1, mu2, sigma2, eps=eps)


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def _cdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aa = np.sum(a * a, axis=1)[:, None]
    bb = np.sum(b * b, axis=1)[None, :]
    return np.sqrt(np.maximum(aa + bb - 2 * (a @ b.T), 0.0))


def calculate_precision_recall(feat_r: np.ndarray, feat_g: np.ndarray, k: int = 3
                               ) -> Tuple[float, float]:
    """kNN manifold precision and recall (upstream fid_PR.py:250-262,
    Kynkaanniemi et al.): a generated sample is precise if it lies within
    the k-th neighbour radius of some real sample; recall the other way."""
    # the (k+1)-th smallest distance, the first being the sample's own 0
    nnk_r = np.sort(_cdist(feat_r, feat_r), axis=1)[:, k]
    nnk_g = np.sort(_cdist(feat_g, feat_g), axis=1)[:, k]
    d_gr = _cdist(feat_g, feat_r)
    precision = float((d_gr <= nnk_r[None, :]).any(axis=1).mean())
    recall = float((d_gr.T <= nnk_g[None, :]).any(axis=1).mean())
    return precision, recall


def get_fid_pr(feat_r: np.ndarray, feat_g: np.ndarray, k: int = 3):
    """{"fid", "precision", "recall"} of two feature sets (upstream
    get_fid_PR, fid_PR.py:282-321)."""
    mu_r, sig_r = activation_statistics(feat_r)
    mu_g, sig_g = activation_statistics(feat_g)
    precision, recall = calculate_precision_recall(feat_r, feat_g, k=k)
    return {"fid": calculate_frechet_distance(mu_r, sig_r, mu_g, sig_g),
            "precision": precision, "recall": recall}


def make_inception_embedder(weights_path: str, device=DEFAULT_DEVICE,
                            batch_size: int = 50) -> Callable:
    """embed(images (B, H, W, C) numpy in [0, 1]) -> (B, F) numpy features,
    the network on `device` (the card unless device="cpu"), fed NCHW with
    grayscale repeated to 3 channels. A file that does not load raises."""
    device = resolve_device(device, "make_inception_embedder")
    sd, spec, mod = load_embedder_spec(weights_path)
    try:
        simple = detect_schema(sd) == "simple2d"
    except ValueError:
        simple = False
    if simple:
        net = build_embedder_from_state_dict(sd, spec)
    elif mod is not None:
        net = mod
    else:
        raise ValueError(f"{weights_path}: a state dict that is not in the simple 2d "
                         "schema; an Inception network must come as a TorchScript "
                         "archive or a pickled module")
    net = net.to(device).eval()

    def embed(images: np.ndarray) -> np.ndarray:
        feats = []
        with torch.inference_mode():
            for i in range(0, len(images), batch_size):
                x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch_size],
                                                          np.float32)).to(device)
                x = x.permute(0, 3, 1, 2)
                if x.shape[1] == 1:
                    x = x.expand(-1, 3, -1, -1)
                out = net(x.contiguous())
                if isinstance(out, (list, tuple)):
                    out = out[0]
                feats.append(out.reshape(len(x), -1).float().cpu().numpy())
        return np.concatenate(feats)

    return embed
