"""The attention kernels, the headline request and the training step of one
checkout of the port, measured with `chip_smoke.py`'s own cases, so that two
commits compare in one call on the same card.

    python3 mcvd_tpu_torch/tools/profile_attention.py [--tree DIR] [--only cases|d24|headline]

`--tree` names the checkout whose `mcvd_tpu_torch` runs (default: this one;
for example a parent commit unpacked with `git archive`). The cases, checks
and timings are this checkout's `chip_smoke.py`: `attn_fwd_case` and
`attn_bwd_case` at every `ATTN_CASES` shape, B=16, then at the six head-dim-24
calls of the 3D model (`smmnist_DDPM_small5_3d.yml`, read by
`tools.gn_calls.model_calls`) at B=64 clips, fp32 and bf16 (device ms beside
the plain version's, SDPA's and the bound; host us of enqueue a call on
tensors seen before and on new ones; each case's plan); then `headline`
(the flagship's bench request, two timed) and `train_steps` (five flagship
steps at B=64, fp32 and bf16). `--only cases` runs the cases, `--only d24`
the head-dim-24 ones alone, `--only headline` the rest. A tree from before
`ops.attention.attention_plan` runs every case as one tiled sequence a block,
and one from before `ops.attention.attention_route` on its one route,
mma.sync. One JSON line each, after `phase_env`'s line with the card's name
and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
D24_BATCH = 64   # clips: the 3D model's B=64 step


def _older_tree(cs, A) -> None:
    """Let this checkout's cases run on a tree from before the plans (PR 15
    and earlier: head dim 24 on mma.sync, one sequence a block)."""
    from math import ceil
    from typing import NamedTuple

    class Plan(NamedTuple):
        form: str
        seqs_per_tile: int
        tiles: int

    if not hasattr(A, "attention_route"):
        A.attention_route = lambda dtype, head_dim: "mma_sync"
    if not hasattr(A, "attention_plan"):
        A.attention_plan = lambda dtype, d, T, B, H=1: Plan("tiled", 1, H * B * ceil(T / 64))
        A.kernel_plan = lambda d, T, B, H=1: A.attention_plan(None, d, T, B, H)
    cs.ATTN_PATH.setdefault(("mma_sync", "bfloat16"), "mma.sync m16n8k16 bf16")
    cs.ATTN_PATH.setdefault(("mma_sync", "float32"), "mma.sync m16n8k8 3xTF32")


def d24_cases(cs):
    """(B, T, heads, D) of the 3D model's attention calls at D24_BATCH clips."""
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.tools.gn_calls import model_calls

    config = load_config(cs.repo_path(cs.SMALL5["small5_3d"][0]))
    return [(a["B"], a["T"], a["heads"], a["D"]) for a in model_calls(config, D24_BATCH)[1]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose mcvd_tpu_torch runs")
    ap.add_argument("--only", choices=("cases", "d24", "headline"), help="one part of the run")
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_attention: needs a CUDA card")
    from mcvd_tpu_torch.config import flagship_config
    from mcvd_tpu_torch.ops import _build
    from mcvd_tpu_torch.ops import attention as A

    _older_tree(cs, A)

    def emit(what, **payload):
        print(json.dumps({"tree": tree, "what": what, **payload}, default=str), flush=True)

    cs.phase_env()
    _build.load_library()
    if args.only != "headline":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        g = torch.Generator(device="cuda").manual_seed(0)
        cases = [] if args.only == "d24" else [(16, T, h, d) for T, h, d in cs.ATTN_CASES]
        for dtype in (torch.float32, torch.bfloat16):
            for B, T, h, d in cases + d24_cases(cs):
                emit("attention", **cs.attn_fwd_case(g, B, T, h, d, dtype))
                emit("attention_bwd", **cs.attn_bwd_case(g, B, T, h, d, dtype))
    if args.only not in ("cases", "d24"):
        emit("headline", **cs.headline(flagship_config(), n_timed=2))
        for dn in ("float32", "bfloat16"):
            emit("train_step", **cs.train_steps(flagship_config(), dn, 5, cs.TRAIN_LAUNCHES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
