"""flax param path -> the port's torch key and layout kind.

`flax_path_to_torch` is the port's own copy of
`mcvd_tpu/compat/torch_ckpt.py::_flax_path_to_torch` (the port imports
nothing of `mcvd_tpu`), the map to upstream's torch names; a CPU test feeds
every param path of the tiny and the flagship JAX init to both and asserts
equal results. `ncsn_path_to_torch` names the legacy ncsn models, which
have no upstream torch model: the port names their modules after the flax
tree (`models/legacy_blocks.py`). `LAYOUTS` picks one by a model's
`flax_layout` ("upstream" where the model has none).
"""

from __future__ import annotations

from typing import Tuple

# flax names of list members, `<name>_<i>`; torch names them `<name>.<i>`
_LISTY = ("all_modules_", "downblocks_", "middleblocks_", "upblocks_")
# torch attribute names whose flax module wraps an inner nn.Conv named Conv_0
_CONV_WRAPPERS = ("Conv_0", "Conv_1", "Conv_2", "mlp_shared", "mlp_gamma", "mlp_beta",
                  "out", "conv", "conv0", "conv1")


def flax_path_to_torch(path: Tuple[str, ...]) -> Tuple[str, str, str]:
    """Map a flax param path, e.g. ('all_modules_3', 'Conv_0', 'Conv_0',
    'kernel'), to (torch key, layout kind, torch module path). The kind
    selects the layout transform."""
    *mods, leaf = path
    segs = []
    for m in mods:
        if m.startswith(_LISTY):
            name, idx = m.rsplit("_", 1)
            segs.append(f"{name}.{idx}")
        elif m == "mlp_shared":
            # torch MySPADE: mlp_shared = Sequential(conv, act) -> conv is .0
            segs.append("mlp_shared.0")
        elif m == "temb_dense_0":
            # legacy UNet temb_dense = Sequential(Linear, act, Linear, act)
            segs.append("temb_dense.0")
        elif m == "temb_dense_1":
            segs.append("temb_dense.2")
        else:
            segs.append(m)

    # Conv2dSame and its kin wrap an nn.Conv named Conv_0, where the torch
    # module is itself the conv: <attr>/Conv_0/<leaf> collapses to <attr>.
    # A torch attribute named Conv_0 then appears as Conv_0/Conv_0/<leaf>.
    if (leaf in ("kernel", "bias") and len(segs) >= 2 and segs[-1] == "Conv_0"
            and segs[-2].rsplit(".", 1)[-1] in _CONV_WRAPPERS):
        segs = segs[:-1]

    base = ".".join(segs)
    if leaf == "kernel":
        return f"{base}.weight", "conv_or_dense", base
    if leaf == "embedding":
        return f"{base}.weight", "embed", base
    if leaf == "scale":
        return f"{base}.weight", "direct", base
    if leaf == "Norm_0_scale":
        return f"{base}.Norm_0.weight", "direct", base
    if leaf == "Norm_0_bias":
        return f"{base}.Norm_0.bias", "direct", base
    if leaf == "weight":
        return f"{base}.weight", "special_weight", base
    if leaf in ("bias", "b"):
        return f"{base}.{leaf}", "direct", base
    if leaf == "W":
        return f"{base}.W", "direct", base
    if leaf == "weights":
        # legacy UNet Nin stores (out, in)
        return f"{base}.weights", "transpose2d", base
    raise KeyError(f"unmapped flax leaf {path}")


# the legacy ncsn norms' leaves, copied as they are
_NCSN_DIRECT = ("bias", "alpha", "gamma", "beta")


def ncsn_path_to_torch(path: Tuple[str, ...]) -> Tuple[str, str, str]:
    """Map a flax param path of the ncsn models, e.g. ('refine1',
    'adapt_convs_0', '1_1_conv', 'Conv_0', 'kernel'), to (torch key, layout
    kind, torch module path): the flax `Conv2d` wrapper's inner `Conv_0` is
    dropped, every other module keeps its flax name."""
    *mods, leaf = path
    base = ".".join(m for m in mods if m != "Conv_0")
    if leaf == "kernel":
        return f"{base}.weight", "conv_or_dense", base
    if leaf == "embedding":
        return f"{base}.weight", "embed", base
    if leaf == "scale":    # the GroupNorm option's layers.GroupNorm
        return f"{base}.weight", "direct", base
    if leaf in _NCSN_DIRECT:
        return f"{base}.{leaf}", "direct", base
    raise KeyError(f"unmapped flax leaf {path}")


LAYOUTS = {"upstream": flax_path_to_torch, "ncsn": ncsn_path_to_torch}
