"""flax params -> port state dict: `mcvd_tpu/compat/torch_ckpt.py` run
backwards.

`flax_names.flax_path_to_torch` (the port's copy of the JAX package's map)
names each flax leaf's upstream torch key and layout kind; this module
applies the inverse layout transform:

  Dense kernel (in,out)        -> Linear weight (out,in)
  Conv kernel (kh,kw,I,O)      -> Conv2d weight (O,I,kh,kw)
  NIN W/b                      -> as is
  GroupNorm scale/bias         -> weight/bias
  ActNorm Norm_0_scale/_bias   -> Norm_0.weight/.bias
  Embed embedding              -> weight

Input is plain nested dicts of numpy arrays (the `params` collection).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .flax_names import flax_path_to_torch


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def torch_state_dict_from_flax(params_numpy: Mapping) -> Dict[str, torch.Tensor]:
    """{torch key: tensor} for every leaf of a flax `params` tree; raises on a
    leaf it cannot map or on two leaves mapping to one key."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params_numpy):
        key, kind, _ = flax_path_to_torch(path)
        key = key.lstrip(".")  # a leaf of the root module has an empty base
        w = np.asarray(leaf, dtype=np.float32)
        if kind == "conv_or_dense":
            if w.ndim == 2:
                w = w.T
            elif w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)
            else:
                raise NotImplementedError(
                    f"{'/'.join(path)}: {w.ndim}-D kernel belongs to a model "
                    "variant not ported yet (ROADMAP Queue 1 item 13)")
        elif kind not in ("direct", "embed"):
            raise NotImplementedError(
                f"{'/'.join(path)}: layout kind {kind!r} belongs to a model "
                "variant not ported yet (ROADMAP Queue 1 item 13)")
        if key in sd:
            raise KeyError(f"two flax leaves map to {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(w))
    return sd


def load_flax_params(model: torch.nn.Module, params_numpy: Mapping) -> None:
    """Load a flax `params` tree into `model`: every parameter must be set
    and every leaf used; only buffers (schedule tables) may stay as they are."""
    sd = torch_state_dict_from_flax(params_numpy)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    buffers = {n for n, _ in model.named_buffers()}
    if unexpected or set(missing) - buffers:
        raise KeyError(f"flax params do not match the model: missing "
                       f"{sorted(set(missing) - buffers)}, unexpected {sorted(unexpected)}")
