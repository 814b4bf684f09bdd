"""The command line of `portbench/run.py`."""

from __future__ import annotations

import argparse
import json
import sys

from . import cell, discovery


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    ap.add_argument("--workload", required=True, help="cell name: workloads/<name>.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        wl = discovery.load_workload(args.workload)
    except discovery.UnknownName as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import time

    import torch

    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {args.workload} needs {chips} CUDA device(s), found {n}; "
              f"it does not run on the CPU", file=sys.stderr)
        return 1
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", t0)
    bad = cell.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 1
    print(f"portbench: {args.workload} seed {args.seed}: setup {result.pop('_setup_s'):.2f} s, "
          f"window {result.pop('_window_s'):.2f} s, run {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    per_unit = result.pop("_per_unit_s", None)
    if per_unit:
        print(f"portbench: s an evaluation or step: window {per_unit[0]!r}, "
              f"traced slice {per_unit[1]!r}", file=sys.stderr)
    print(f"portbench: readings {json.dumps(result.pop('_readings'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
