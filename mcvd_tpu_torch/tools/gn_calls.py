"""The GroupNorm calls one evaluation of a model makes, read from the model
itself: its forward runs on the "meta" device (shapes only, no data, no
arithmetic) with `ops.groupnorm.group_norm` replaced by a recorder.

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
from ..models import UNetMoreDDPM


def group_norm_calls(config=None, batch: int = 16) -> list:
    """One dict per GroupNorm call of one evaluation of `config`'s model (the
    flagship when None), in call order: C (channels of x, C*N), H, W,
    num_groups, eps, affine, adagn, act, frames_last."""
    config = config or flagship_config()
    model = UNetMoreDDPM(config).to(device="meta", memory_format=torch.channels_last)
    calls = []

    def record(x, num_groups, *, eps, gamma=None, beta=None, scale=None, shift=None,
               frames_last=1, act=False):
        B, CN, H, W = x.shape
        calls.append(dict(C=CN, H=H, W=W, num_groups=num_groups, eps=eps,
                          affine=gamma is not None, adagn=scale is not None,
                          act=bool(act), frames_last=frames_last))
        return x

    d = config.data
    sz = d.image_size
    x = torch.empty(batch, d.channels * d.num_frames, sz, sz, device="meta")
    cond = torch.empty(batch, d.channels * d.num_frames_cond, sz, sz, device="meta")
    t = torch.zeros(batch, dtype=torch.long, device="meta")
    real = ops.groupnorm.group_norm
    ops.groupnorm.group_norm = record
    try:
        with torch.no_grad():
            model(x, t, cond)
    finally:
        ops.groupnorm.group_norm = real
    return calls


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
