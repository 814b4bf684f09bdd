"""Resumable running-average meters (counterpart of
`mcvd_tpu/runners/meters.py`, copied; upstream ncsn_runner.py:79-101,
2716-2853). Pickled beside the checkpoints so metric curves survive a
restart."""

from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List, Optional


class RunningAverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.vals: List[float] = []
        self.steps: List[int] = []

    def update(self, val: float, step: Optional[int] = None):
        self.val = val
        self.sum += val
        self.count += 1
        self.avg = self.sum / self.count
        self.vals.append(val)
        if step is not None:
            self.steps.append(step)


def init_meters() -> Dict[str, RunningAverageMeter]:
    names = [
        "losses_train", "losses_test", "lr_meter", "grad_norm", "time_train",
        "epochs",
    ]
    # per-task best-metric meters (reference: ncsn_runner.py:2716-2748)
    for task in ("", "2", "3"):
        for metric in ("mse", "psnr", "ssim", "lpips", "fvd"):
            names.append(f"{metric}{task}_meter")
    meters: Dict = {n: RunningAverageMeter() for n in names}
    # best-ever per metric with the step it occurred (reference:
    # ncsn_runner.py:542-584, 2296-2365) — the "which checkpoint is best"
    # signal for model selection
    meters["best"] = {}
    return meters


# lower-is-better unless listed here
_HIGHER_BETTER = {"psnr", "ssim"}


def update_best(meters: Dict, metrics: Dict, step: int) -> Dict:
    """Track best-ever value+step per metric key (mse, psnr, ssim2, fvd3...).
    Returns the dict of bests. Tolerates meters pickled before this field
    existed."""
    best = meters.setdefault("best", {})
    for name, val in metrics.items():
        base = name.rstrip("23")
        if base not in ("mse", "psnr", "ssim", "lpips", "fvd"):
            continue
        try:
            val = float(val)
        except (TypeError, ValueError):
            continue
        if math.isnan(val):
            continue  # NaN would win every comparison thereafter
        hi = base in _HIGHER_BETTER
        cur = best.get(name)
        if (cur is None or math.isnan(cur["value"])
                or (val > cur["value"] if hi else val < cur["value"])):
            best[name] = {"value": val, "step": int(step)}
    return best


def save_meters(meters: Dict, log_path: str):
    with open(os.path.join(log_path, "meters.pkl"), "wb") as f:
        pickle.dump(meters, f)


def load_meters(log_path: str) -> Optional[Dict]:
    p = os.path.join(log_path, "meters.pkl")
    if not os.path.isfile(p):
        return None
    with open(p, "rb") as f:
        return pickle.load(f)
