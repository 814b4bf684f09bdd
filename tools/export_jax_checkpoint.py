"""Export a JAX package checkpoint (Orbax, `mcvd_tpu.train.checkpoints`) to
one `.npz` that the PyTorch port imports with `mcvd_tpu_torch.compat.jax_ckpt`
on any host, the card machine included (it has no jax, orbax or tensorstore).

    python tools/export_jax_checkpoint.py --config configs/X.yml \\
        --ckpt_dir EXP/logs [--name checkpoint_N] --out OUT.npz \\
        [--config_mod section.key=value ...]

It restores the TrainState with `mcvd_tpu.train.checkpoints.load_checkpoint`
and writes every leaf under its flattened path, '/'-joined: `params/...` and
`ema_params/...` (flax param paths), the optax state as it is nested,
`opt_state/<i>/<j>/<field>/...` (Adam's `count`, `mu`, `nu` in
`ScaleByAdamState` inside `optax.chain(clip_by_global_norm, adam)`, the
schedule's `count`, amsgrad's `nu_max`, RMSProp's `nu`, SGD's `trace`), and
`step` and `epoch`. `__config__` holds the config it was given, as JSON, and
`__source__` the checkpoint it read. Runs where jax and orbax are installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def flatten_state(state) -> dict:
    """{'/'-joined path: numpy array} of every leaf of a restored TrainState
    (a dict of dicts and lists, as Orbax restores it without a target)."""
    import jax

    def name(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)

    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        flat["/".join(name(k) for k in path)] = np.asarray(leaf)
    return flat


def export_checkpoint(config, ckpt_dir: str, out: str, name: str = "checkpoint") -> dict:
    """Restore checkpoint `name` of `ckpt_dir` and write it to `out`; returns
    the flat arrays written."""
    from mcvd_tpu.config import namespace2dict
    from mcvd_tpu.train.checkpoints import load_checkpoint

    restored = load_checkpoint(ckpt_dir, name=name)
    state = restored if isinstance(restored, dict) else {
        k: getattr(restored, k) for k in ("params", "opt_state", "ema_params", "step",
                                           "epoch")}
    flat = flatten_state(state)
    flat["__config__"] = np.array(json.dumps(namespace2dict(config), sort_keys=True))
    flat["__source__"] = np.array(f"{os.path.basename(os.path.abspath(ckpt_dir))}/{name}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **flat)
    return flat


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="the run's yml")
    p.add_argument("--config_mod", nargs="*", default=[])
    p.add_argument("--ckpt_dir", required=True, help="the run's log dir (EXP/logs)")
    p.add_argument("--name", default="checkpoint", help="checkpoint or checkpoint_N")
    p.add_argument("--out", required=True, help="the .npz to write")
    args = p.parse_args(argv)
    from mcvd_tpu.config import load_config

    config = load_config(args.config, args.config_mod)
    flat = export_checkpoint(config, args.ckpt_dir, args.out, args.name)
    print(f"wrote {len(flat)} arrays at step {int(flat['step'])} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
