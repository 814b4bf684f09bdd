"""flax params -> port state dict: `mcvd_tpu/compat/torch_ckpt.py` run
backwards.

`flax_names.flax_path_to_torch` (the port's copy of the JAX package's map)
names each flax leaf's upstream torch key and layout kind; this module
applies the inverse layout transform:

  Dense kernel (in,out)             -> Linear weight (out,in)
  Conv kernel (kh,kw,I,O)           -> Conv2d weight (O,I,kh,kw)
  Conv kernel (k,I,O)               -> Conv1d weight (O,I,k) (pseudo-3D time_conv)
  UpDownConv2d weight (kh,kw,I,O)   -> weight (O,I,kh,kw)
  Conv3dFolded weight (kd,kh,kw,I,O), bias -> `.conv.weight` (O,I,kd,kh,kw), `.conv.bias`
  FrameConverter weight (Nin,Nout)  -> weight (Nout,Nin,1,1), upstream's 1x1 conv
  legacy Nin weights (in,out)       -> weights (out,in)
  NIN W/b                           -> as is
  GroupNorm scale/bias              -> weight/bias
  ActNorm Norm_0_scale/_bias        -> Norm_0.weight/.bias
  Embed embedding                   -> weight

The legacy ncsn models name their modules after the flax tree and carry
`flax_layout = "ncsn"`: their leaves map by `flax_names.ncsn_path_to_torch`,
the same layout kinds, the InstanceNorm++ scales and class tables as they
are (both packages store them around their 1.0 offsets).

Upstream wraps each Conv3d as `.conv` (layers3d.py MyConv3d), which the
flax tree does not name: a module whose `weight` is 5-D puts its weight and
bias under `.conv`, as the JAX package's converter looks them up there.
Input is plain nested dicts of numpy arrays (the `params` collection).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .flax_names import LAYOUTS


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    """(path, leaf, the dict holding it) of every leaf."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v, tree


def torch_layout(path: Tuple[str, ...], w: np.ndarray, kind: str) -> np.ndarray:
    """A flax leaf in the torch layout of its layout kind."""
    if kind == "conv_or_dense":
        if w.ndim == 2:
            return w.T
        if w.ndim == 3:
            return w.transpose(2, 1, 0)
        if w.ndim == 4:
            return w.transpose(3, 2, 0, 1)
    elif kind == "special_weight":
        if w.ndim == 5:      # Conv3dFolded
            return w.transpose(4, 3, 0, 1, 2)
        if w.ndim == 4:      # UpDownConv2d
            return w.transpose(3, 2, 0, 1)
        if w.ndim == 2:      # FrameConverter
            return w.T[:, :, None, None]
    elif kind == "transpose2d" and w.ndim == 2:
        return w.T
    elif kind in ("direct", "embed"):
        return w
    raise ValueError(f"{'/'.join(path)}: no torch layout for a {w.ndim}-D leaf of kind "
                     f"{kind!r}")


def layout_of(model: torch.nn.Module) -> str:
    """The flax naming of `model`: its `flax_layout`, else "upstream"."""
    return getattr(model, "flax_layout", "upstream")


def torch_state_dict_from_flax(params_numpy: Mapping,
                               layout: str = "upstream") -> Dict[str, torch.Tensor]:
    """{torch key: tensor} for every leaf of a flax `params` tree, named by
    `layout` ("upstream" or "ncsn", `flax_names.LAYOUTS`); raises on a leaf
    it cannot map or on two leaves mapping to one key."""
    names = LAYOUTS[layout]
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf, parent in _leaves(params_numpy):
        key, kind, base = names(path)
        w = torch_layout(path, np.asarray(leaf, dtype=np.float32), kind)
        if np.ndim(parent.get("weight")) == 5 and path[-1] in ("weight", "bias"):
            key = f"{base}.conv.{path[-1]}"
        key = key.lstrip(".")  # a leaf of the root module has an empty base
        if key in sd:
            raise KeyError(f"two flax leaves map to {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(w))
    return sd


def load_flax_params(model: torch.nn.Module, params_numpy: Mapping) -> None:
    """Load a flax `params` tree into `model`: every parameter must be set
    and every leaf used; only buffers (schedule tables) may stay as they are."""
    sd = torch_state_dict_from_flax(params_numpy, layout_of(model))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    buffers = {n for n, _ in model.named_buffers()}
    if unexpected or set(missing) - buffers:
        raise KeyError(f"flax params do not match the model: missing "
                       f"{sorted(set(missing) - buffers)}, unexpected {sorted(unexpected)}")
