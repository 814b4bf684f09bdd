"""flax param path -> upstream torch key and layout kind.

The port's own copy of `mcvd_tpu/compat/torch_ckpt.py::_flax_path_to_torch`
(the port imports nothing of `mcvd_tpu`); a CPU test feeds every param path
of the tiny and the flagship JAX init to both and asserts equal results.
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
