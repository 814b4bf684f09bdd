"""Checkpoints of {params, opt_state, ema_params, step, epoch} (counterpart
of `mcvd_tpu/train/checkpoints.py`).

The same naming as the JAX package (upstream ncsn_runner.py:424-439): a
rolling "checkpoint", rewritten every `checkpoint_freq` steps, and numbered
"checkpoint_{step}" at each snapshot, in the experiment's log directory.
Each is one `torch.save` file, written under a temporary name and renamed
over the old one with `os.replace`, so a run killed while saving leaves the
previous checkpoint whole (Orbax renames a finished directory the same
way). The JAX package's Orbax checkpoints are not read here.

`load_checkpoint(target=state)` copies the saved tensors into the target's
own tensors (`copy_`): `TrainState.params` are the model's parameters, so
the model, the optimizer's slots and the EMA all hold the loaded values.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import torch

from .state import TrainState


def _to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def save_checkpoint(ckpt_dir: str, state: TrainState, name: str = "checkpoint") -> str:
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"params": _to_cpu(state.params), "opt_state": _to_cpu(state.opt_state),
               "ema_params": _to_cpu(state.ema_params), "step": int(state.step),
               "epoch": int(state.epoch)}
    tmp = os.path.join(os.path.dirname(path), f".{name}.tmp{os.getpid()}")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _copy_into(dst: Any, src: Any, where: str) -> Any:
    """dst with src's values: tensors copied in place, other leaves taken."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise ValueError(f"checkpoint does not match the state at {where}: other keys")
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k], f"{where}.{k}")
        return dst
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            raise ValueError(f"checkpoint does not match the state at {where}: "
                             f"{getattr(src, 'shape', type(src))} vs {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
        return dst
    return src


def load_checkpoint(ckpt_dir: str, name: str = "checkpoint",
                    target: Optional[TrainState] = None) -> TrainState:
    """The checkpoint `name` in `ckpt_dir`. With `target`, its values are
    copied into target's tensors (which keep their device and dtype) and its
    step and epoch set; target is returned. Without, a TrainState of CPU
    tensors."""
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if target is None:
        return TrainState(**saved)
    _copy_into(target.params, saved["params"], "params")
    _copy_into(target.opt_state, saved["opt_state"], "opt_state")
    _copy_into(target.ema_params, saved["ema_params"], "ema_params")
    target.step, target.epoch = int(saved["step"]), int(saved["epoch"])
    return target


def numbered_steps(ckpt_dir: str) -> List[int]:
    """The steps of the `checkpoint_{step}` files in `ckpt_dir`, sorted."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("checkpoint_"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def latest_numbered_step(ckpt_dir: str) -> Optional[int]:
    steps = numbered_steps(ckpt_dir)
    return steps[-1] if steps else None
