"""The GroupNorm and attention calls one evaluation of a model makes, read
from the model itself: its forward runs on the "meta" device (shapes only,
no data, no arithmetic) with `ops.groupnorm.group_norm` and
`ops.attention.attention_packed` replaced by recorders.

    python -m mcvd_tpu_torch.tools.gn_calls     # the flagship's, at B=16

`chip_smoke.py` checks and times the GroupNorm kernel at these shapes, and
the CPU tests check `ops.groupnorm.plan` on them.
"""

from __future__ import annotations

import json
import sys
from collections import Counter

import torch

from .. import ops
from ..config import flagship_config
from ..models import build


def model_calls(config=None, batch: int = 16) -> tuple:
    """(GroupNorm calls, attention calls) of one evaluation of `config`'s
    model (the flagship when None), in call order. A GroupNorm call: B
    (examples), C (channels of x, C*N), H, W, num_groups, eps, affine, adagn,
    act, frames_last. An attention call: B (sequences), T (tokens), heads,
    D."""
    config = config or flagship_config()
    model = build(config).to(device="meta")
    gn, attn = [], []

    def record_gn(x, num_groups, *, eps, gamma=None, beta=None, scale=None, shift=None,
                  frames_last=1, act=False):
        B, CN, H, W = x.shape
        gn.append(dict(B=B, C=CN, H=H, W=W, num_groups=num_groups, eps=eps,
                       affine=gamma is not None, adagn=scale is not None,
                       act=bool(act), frames_last=frames_last))
        return x

    def record_attn(qkv, n_heads, scale):
        B, T, C3 = qkv.shape
        attn.append(dict(B=B, T=T, heads=n_heads, D=C3 // 3 // n_heads))
        return qkv[..., :C3 // 3]

    d = config.data
    sz = d.image_size
    x = torch.empty(batch, d.channels * d.num_frames, sz, sz, device="meta")
    cond = torch.empty(batch, d.channels * d.num_frames_cond, sz, sz, device="meta")
    t = torch.zeros(batch, dtype=torch.long, device="meta")
    real = ops.groupnorm.group_norm, ops.attention.attention_packed
    ops.groupnorm.group_norm, ops.attention.attention_packed = record_gn, record_attn
    try:
        with torch.no_grad():
            model(x, t, cond)
    finally:
        ops.groupnorm.group_norm, ops.attention.attention_packed = real
    return gn, attn


def group_norm_calls(config=None, batch: int = 16) -> list:
    """The GroupNorm calls of `model_calls`."""
    return model_calls(config, batch)[0]


def form(call: dict) -> str:
    """The call site's form: `adagn_silu` (resblocks), `affine` (attention
    blocks) or `affine_silu` (the output head)."""
    name = "adagn" if call["adagn"] else "affine" if call["affine"] else "plain"
    return name + ("_silu" if call["act"] else "")


def main() -> int:
    calls = group_norm_calls()
    shapes = Counter((c["C"], c["H"], form(c)) for c in calls)
    print(json.dumps({"calls": len(calls),
                      "forms": Counter(form(c) for c in calls),
                      "shapes": [dict(C=C, H=H, form=f, count=n)
                                 for (C, H, f), n in sorted(shapes.items())]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
