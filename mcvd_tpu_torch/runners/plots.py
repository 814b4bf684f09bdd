"""Metric-curve plots and sample-grid artifacts (counterpart of
`mcvd_tpu/runners/plots.py`; upstream ncsn_runner.py plot_graphs:740-797,
plot_video_graphs:799-904 and the grid dumps :626-697, 1995-2190).

matplotlib and PIL are optional here: the card machine may lack them. Without
matplotlib the curves are not drawn (logged once; the meters pickle, which
holds the same series, is written either way); without PIL a sample grid is
written as the same uint8 array in a `.npy` file.
"""

from __future__ import annotations

import importlib.util
import logging
import multiprocessing
import os
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _plot_series(ax, meter, label):
    if not meter.vals:
        return
    xs = meter.steps if len(meter.steps) == len(meter.vals) else range(len(meter.vals))
    ax.plot(list(xs), meter.vals, label=label)


def plot_graphs(meters: Dict, log_path: str) -> None:
    """Loss, grad norm, lr and ms/step curves -> <log_path>/curves.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 4, figsize=(19, 4))
    _plot_series(axes[0], meters["losses_train"], "train")
    _plot_series(axes[0], meters["losses_test"], "test")
    axes[0].set_title("DSM loss")
    axes[0].set_yscale("log")
    axes[0].legend()
    _plot_series(axes[1], meters["grad_norm"], "grad norm")
    axes[1].set_title("grad norm")
    _plot_series(axes[2], meters["lr_meter"], "lr")
    axes[2].set_title("lr")
    _plot_series(axes[3], meters["time_train"], "ms/step")
    axes[3].set_title("ms/step")
    fig.tight_layout()
    fig.savefig(os.path.join(log_path, "curves.png"), dpi=100)
    plt.close(fig)


def plot_video_graphs(meters: Dict, log_path: str) -> None:
    """Per-task metric curves with the best point marked ->
    <log_path>/video_metrics.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = ["mse", "psnr", "ssim", "lpips", "fvd"]
    fig, axes = plt.subplots(1, len(names), figsize=(4 * len(names), 3.5))
    for ax, name in zip(axes, names):
        m = meters.get(f"{name}_meter")
        if m is None or not m.vals:
            ax.set_visible(False)
            continue
        _plot_series(ax, m, name)
        vals = np.asarray(m.vals)
        best = vals.argmax() if name in ("psnr", "ssim") else vals.argmin()
        xs = m.steps if len(m.steps) == len(m.vals) else list(range(len(m.vals)))
        ax.scatter([xs[best]], [vals[best]], color="red", zorder=3)
        ax.annotate(f"{vals[best]:.4g}", (xs[best], vals[best]))
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(os.path.join(log_path, "video_metrics.png"), dpi=100)
    plt.close(fig)


def _plot_all(meters, log_path):
    plot_graphs(meters, log_path)
    plot_video_graphs(meters, log_path)


def plot_graphs_process(meters: Dict, log_path: str) -> Optional[multiprocessing.Process]:
    """Draw the curves in a spawned daemon process, so the train loop never
    waits on matplotlib (upstream ncsn_runner.py:483-487); None, and nothing
    started, without matplotlib. Spawned, not forked: the caller has
    threads and a CUDA context."""
    if importlib.util.find_spec("matplotlib") is None:
        logger.info("matplotlib not installed: curves not drawn (meters.pkl holds them)")
        return None
    p = multiprocessing.get_context("spawn").Process(target=_plot_all,
                                                     args=(meters, log_path), daemon=True)
    p.start()
    return p


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def _rgb(frames: np.ndarray) -> np.ndarray:
    frames = _to_uint8(frames)
    return np.repeat(frames, 3, axis=-1) if frames.shape[-1] == 1 else frames


def video_grid(*, pred: np.ndarray, real: Optional[np.ndarray] = None,
               cond: Optional[np.ndarray] = None, max_videos: int = 8) -> np.ndarray:
    """The cond | real | pred grid, uint8 (rows of H, T*W, 3): for each of the
    first `max_videos` videos its bands stacked, frames along the width."""
    rows = []
    for b in range(min(len(pred), max_videos)):
        strips = [np.concatenate(list(_rgb(v[b])), axis=1)
                  for v in (cond, real, pred) if v is not None]
        w_max = max(s.shape[1] for s in strips)
        strips = [np.pad(s, ((0, 0), (0, w_max - s.shape[1]), (0, 0))) for s in strips]
        rows.append(np.concatenate(strips, axis=0))
    return np.concatenate(rows, axis=0)


def save_video_grid(path_prefix: str, *, pred: np.ndarray,
                    real: Optional[np.ndarray] = None,
                    cond: Optional[np.ndarray] = None,
                    max_videos: int = 8, fps: int = 4) -> str:
    """The `video_grid` of (B, T, H, W, C) arrays in [0, 1] as a PNG and an
    animated GIF (real over pred, videos side by side, over T); without PIL
    the grid as `.npy`. Returns the grid's path."""
    grid = video_grid(pred=pred, real=real, cond=cond, max_videos=max_videos)
    if importlib.util.find_spec("PIL") is None:
        np.save(path_prefix + ".npy", grid)
        logger.info("PIL not installed: sample grid written as %s.npy", path_prefix)
        return path_prefix + ".npy"
    from PIL import Image

    Image.fromarray(grid).save(path_prefix + ".png")
    B = min(len(pred), max_videos)
    gif_frames = []
    for t in range(pred.shape[1]):
        cols = []
        for b in range(B):
            fr = _rgb(pred[b, t])
            if real is not None and t < real.shape[1]:
                fr = np.concatenate([_rgb(real[b, t]), fr], axis=0)
            cols.append(fr)
        gif_frames.append(Image.fromarray(np.concatenate(cols, axis=1)))
    gif_frames[0].save(path_prefix + ".gif", save_all=True, append_images=gif_frames[1:],
                       duration=int(1000 / fps), loop=0)
    return path_prefix + ".png"
