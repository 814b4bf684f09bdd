"""The network forward's work from the configuration's shapes, read off the
benchmark's own reference (never off what the program launches): its FLOPs,
counted by `torch.utils.flop_counter.FlopCounterMode` over one forward on
the meta device (a multiply-add is 2 FLOPs; convolutions, including the
FIR's depthwise ones, matrix products and the attention's two batched
products; elementwise work is not counted), and the GroupNorm and attention
calls it makes, with their shapes."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import NCSNpp, Plan


@functools.lru_cache(maxsize=8)
def _forward(cfg_json: str, batch: int) -> dict:
    cfg = json.loads(cfg_json)
    d = cfg["data"]
    calls = []
    net = NCSNpp(cfg, record=calls)
    meta = torch.device("meta")
    w = {k: torch.empty(s, device=meta) for k, s in Plan(cfg).shapes().items()}
    sz, C = d["image_size"], d["channels"]
    x = torch.empty(batch, d["num_frames"] * C, sz, sz, device=meta)
    cond = torch.empty(batch, d["num_frames_cond"] * C, sz, sz, device=meta)
    t = torch.zeros(batch, dtype=torch.long, device=meta)
    with FlopCounterMode(display=False) as fc:
        net(w, x, t, cond)
    return {"flops": float(fc.get_total_flops()), "calls": calls}


def forward(cfg: dict, batch: int) -> dict:
    """{"flops": FLOPs of one forward at `batch` clips, "calls": [call, ...]}."""
    return _forward(json.dumps(cfg, sort_keys=True), batch)
