"""Import a JAX package checkpoint into the port, from the `.npz` that
`tools/export_jax_checkpoint.py` writes where jax and orbax are installed.
numpy and torch only.

    python -m mcvd_tpu_torch.compat.jax_ckpt IN.npz LOG_DIR [--config CFG]
        [--config_mod section.key=value ...]

writes the port checkpoints `LOG_DIR/checkpoint_{step}` and
`LOG_DIR/checkpoint` (`train.checkpoints.save_checkpoint`) and
`LOG_DIR/config.yml`, so every CLI mode (`--exp` the directory above
LOG_DIR) takes the run as the JAX package left it. The config is CFG with
its mods, or the one the export names (`__config__`).

The export's leaves map as the weight bridge maps params
(`bridge.torch_state_dict_from_flax`, layouts included): `params` to the
model's parameters, `ema_params` to the EMA, and the param-shaped moments
of the optax state (`mu`, `nu`, amsgrad's `nu_max`, SGD's `trace`) to the
port optimizer's slots of the same name (`train.state.Optimizer`); the
optax counts (Adam's and the schedule's, equal) to `opt_state["count"]`;
`step` and `epoch` as they are. A leaf it cannot place raises and names the
leaf: nothing is dropped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .bridge import torch_state_dict_from_flax

SLOTS = ("mu", "nu", "nu_max", "trace")   # optax field names = the port's slot names


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        *mods, last = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[last] = leaf
    return tree


def read_export(path: str) -> Tuple[Dict, Dict]:
    """(parts, config dict) of an export: parts holds "params" and
    "ema_params" (flax param trees), "opt" ({slot: flax param tree}),
    "count", "step" and "epoch". Raises on a leaf it cannot place."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    config = json.loads(str(flat.pop("__config__"))) if "__config__" in flat else None
    flat.pop("__source__", None)
    groups: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "ema_params": {}}
    opt: Dict[str, Dict[str, np.ndarray]] = {}
    counts = []
    parts: Dict = {}
    for key, leaf in flat.items():
        head, _, rest = key.partition("/")
        if head in groups and rest:
            groups[head][rest] = leaf
        elif head in ("step", "epoch") and not rest:
            parts[head] = int(leaf)
        elif head == "opt_state":
            segs = rest.split("/")
            at = next((i for i, s in enumerate(segs) if s in SLOTS + ("count",)), None)
            if at is None or (segs[at] == "count") != (at == len(segs) - 1):
                raise KeyError(f"jax_ckpt: export leaf {key!r} is not an optax count or "
                               f"moment the port's optimizer keeps {SLOTS}")
            if segs[at] == "count":
                counts.append(int(leaf))
            else:
                opt.setdefault(segs[at], {})["/".join(segs[at + 1:])] = leaf
        else:
            raise KeyError(f"jax_ckpt: export leaf {key!r} has no place in a port checkpoint")
    missing = {"params", "ema_params"} - {k for k, v in groups.items() if v} | (
        {"step", "epoch"} - set(parts))
    if missing or not counts:
        raise KeyError(f"jax_ckpt: export lacks {sorted(missing) or ['an optax count']}")
    if len(set(counts)) != 1:
        raise ValueError(f"jax_ckpt: the optax counts differ: {counts}")
    parts.update(params=_unflatten(groups["params"]),
                 ema_params=_unflatten(groups["ema_params"]),
                 opt={slot: _unflatten(t) for slot, t in opt.items()}, count=counts[0])
    return parts, config


def _copy_named(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor],
                what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"jax_ckpt: {what} do not match the model: missing "
                       f"{sorted(set(dst) - set(src))}, unexpected {sorted(set(src) - set(dst))}")
    with torch.no_grad():
        for k, t in dst.items():
            if tuple(t.shape) != tuple(src[k].shape):
                raise ValueError(f"jax_ckpt: {what} {k}: {tuple(src[k].shape)} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(src[k])


def train_state_from_export(path: str, config, device="cpu", parts=None):
    """The port's TrainState (model, state) of an export (its `read_export`
    parts, when the caller has read them), on `device`."""
    from ..models import get_model
    from ..train import create_train_state
    from .bridge import layout_of, load_flax_params

    parts = parts or read_export(path)[0]
    model = get_model(config, device="cpu")
    load_flax_params(model, parts["params"])
    state = create_train_state(config, model, device=device)
    layout = layout_of(model)
    _copy_named(state.ema_params, torch_state_dict_from_flax(parts["ema_params"], layout),
                "ema_params")
    slots = set(state.opt_state) - {"count"}
    if set(parts["opt"]) != slots:
        raise KeyError(f"jax_ckpt: the export's optax moments {sorted(parts['opt'])} are not "
                       f"the config's optimizer's {sorted(slots)}")
    for slot in slots:
        _copy_named(state.opt_state[slot],
                    torch_state_dict_from_flax(parts["opt"][slot], layout), f"opt_state {slot}")
    state.opt_state["count"] = parts["count"]
    state.step, state.epoch = parts["step"], parts["epoch"]
    return model, state


def import_checkpoint(path: str, log_dir: str, config=None) -> int:
    """Write the export at `path` as the port checkpoints `checkpoint_{step}`
    and `checkpoint` of `log_dir`, with `config.yml` (`config`, or the one
    the export names); returns the step."""
    from ..config import dict2namespace, save_config
    from ..train.checkpoints import save_checkpoint

    parts, named = read_export(path)
    if config is None:
        if named is None:
            raise ValueError(f"jax_ckpt: {path} names no config; pass one")
        config = dict2namespace(named)
    _, state = train_state_from_export(path, config, parts=parts)
    os.makedirs(log_dir, exist_ok=True)
    save_checkpoint(log_dir, state, name=f"checkpoint_{state.step}")
    save_checkpoint(log_dir, state, name="checkpoint")
    save_config(config, os.path.join(log_dir, "config.yml"))
    return state.step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Import a JAX checkpoint export into the port.")
    p.add_argument("export", help="the .npz of tools/export_jax_checkpoint.py")
    p.add_argument("log_dir", help="the port run's log dir (EXP/logs)")
    p.add_argument("--config", help="the run's yml (default: the config the export names)")
    p.add_argument("--config_mod", nargs="*", default=[])
    args = p.parse_args(argv)
    config = None
    if args.config:
        from ..config import load_config

        config = load_config(args.config, args.config_mod)
    step = import_checkpoint(args.export, args.log_dir, config)
    print(f"wrote checkpoint_{step} and checkpoint to {args.log_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
