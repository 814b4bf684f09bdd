"""Helpers of the benchmark's tests: a copy of the benchmark's root with
cells of the same modes at a size a test run holds, and a process-wide
thread cap (the tests run beside others)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "portbench"
SEED = 2 ** 31 + 77   # past 32 signed bits, as a run's seed may be


def _edit_config(root: Path, base: str, name: str, model: dict, data: dict, sampling=None):
    cf = json.loads((root / "configs" / f"{base}.json").read_text())
    cf["config"]["model"].update(model)
    cf["config"]["data"].update(data)
    cf["config"]["sampling"].update(sampling or {})
    (root / "configs" / f"{name}.json").write_text(json.dumps(cf))


def _edit_workload(root: Path, base: str, name: str, **kw):
    wl = json.loads((root / "workloads" / f"{base}.json").read_text())
    wl.update(kw)
    (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))


def tiny_root(tmp: Path) -> Path:
    """portbench copied under tmp, with small cells beside the real ones:
    tiny-sample (16 px, fp32, 3 steps + denoise, 2 blocks, B=4), tiny-train (16 px,
    clips from the device, B=4), tiny-train-loader (the SMMNIST loader's 64
    px at 2 + 2 frames, B=4). Each keeps its real cell's limits."""
    root = Path(tmp) / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    # heads 64 wide, a width the port's attention kernels take on the card
    small = dict(ngf=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8],
                 n_head_channels=64)
    # the small sampling cell computes in fp32: at 3 steps of a small network
    # bf16 alone reads near the full-size cells' limit (0.064 on the CPU)
    _edit_config(root, "smmnist_DDPM_big5", "tiny", small, {"image_size": 16},
                 {"subsample": 3, "compute_dtype": "float32"})
    _edit_config(root, "bair_big", "tiny_rgb", small, {"image_size": 16})
    _edit_config(root, "smmnist_DDPM_big5", "tiny64",
                 dict(small, attn_resolutions=[32]),
                 {"num_frames": 2, "num_frames_cond": 2})
    _edit_workload(root, "big5-sample-b100", "tiny-sample", config="tiny", batch=4,
                   frames_pred=10, check_rows=2)
    _edit_workload(root, "bairbig-train-b64", "tiny-train", config="tiny_rgb", batch=4)
    _edit_workload(root, "big5-train-b64", "tiny-train-loader", config="tiny64", batch=4)
    return root
