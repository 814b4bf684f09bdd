#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --kinds program,control,fault:half_batch [--seconds 0.1]

Each kind is a whole run of the cell (`cell.run_cell`, as `run.py` makes it,
with a short window: the request or the steps that the check reads) with
the system under test swapped:
  * `program`: the port, as a run drives it (the lower readings);
  * `control`: the mode's `Control`, the reference in the program's place
    computed in the precision below the configuration's (sampling bf16 ->
    fp8, training fp32 -> TF32) (the upper readings);
  * `fault:NAME`: the port with a fault planted (`harness.faults`).
One JSON line per seed and kind: every number the check read, and whether
the run came out `correct` under the workload's limits.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_jit")):
    os.environ[var] = os.path.join(os.path.dirname(HERE), "build", "portbench_cache", sub)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench.harness import cell, discovery, faults  # noqa: E402


def system_for(wl: dict, kind: str):
    mode = discovery.load_mode(wl["mode"])
    if kind == "program":
        return None
    if kind == "control":
        return mode.Control
    if kind.startswith("fault:"):
        make = faults.sample_port if wl["mode"] == "sample" else faults.train_port
        return make(mode, kind[len("fault:"):])
    raise ValueError(f"kind {kind!r} is not program, control or fault:NAME")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="program")
    ap.add_argument("--seconds", type=float, default=0.1)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("calibrate: needs the card")
    wl = discovery.load_workload(a.workload)
    kinds = a.kinds.split(",")
    systems = {k: system_for(wl, k) for k in kinds}
    for seed in (int(s) for s in a.seeds.split(",")):
        for kind in kinds:
            t = time.perf_counter()
            out = cell.run_cell(a.workload, seed, a.seconds, False, "cuda", t,
                                system=systems[kind])
            print(json.dumps({"cell": a.workload, "seed": seed, "kind": kind,
                              "correct": out["correct"], **out["_readings"],
                              "s": round(time.perf_counter() - t, 1)}), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
