#!/usr/bin/env python3
"""Where the device's idle time falls among the program's spans: one
`--trace 1` run of a cell, with every idle bucket of its traced slice.

    python3 portbench/spans_report.py --workload <cell> --seed <n> --seconds <s>
    python3 portbench/spans_report.py --span-cost [--n 200000]

The first form makes the run `run.py --trace 1` makes (the result line's
metrics and checks under "result") and adds, from the traced slice:
"buckets_ms", the slice's idle ms by the innermost program span open when
each gap began ("-" for none: outside program spans), each also per unit
("per_unit_ms": per evaluation or step); "gaps_ms", the gaps between the
slice's first and last device activity, which the buckets sum to;
"span_counts"; and "clock": the first `gn_fused` kernel's start against the
first `sample.eval` or `train.forward` span's (a kernel launched only inside
the network starts after the first span that holds the network opened, on a
shared clock). The second form times a span with tracing off and on (a
torch.profiler session), in ns a span over a loop of `--n`. One JSON object
on the last line of standard output. Both forms need the card: without
one it exits 1 and prints nothing.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)
# run.py sets the build caches' paths and the thread counts as it is imported
import portbench.run  # noqa: E402,F401


def span_cost(n: int) -> dict:
    """ns a span with tracing off and on (a CUDA-activity profile, as the
    traced slice's), and of the bare loop, over n."""
    from torch.profiler import ProfilerActivity, profile

    from mcvd_tpu_torch import tracing

    def loop(with_span: bool) -> float:
        span = tracing.span
        t = time.perf_counter_ns()
        if with_span:
            for _ in range(n):
                with span("x"):
                    pass
        else:
            for _ in range(n):
                pass
        return (time.perf_counter_ns() - t) / n

    out = {"n": n, "bare_loop_ns": min(loop(False) for _ in range(3)),
           "off_ns": min(loop(True) for _ in range(3))}
    with profile(activities=[ProfilerActivity.CUDA]):
        out["on_ns"] = min(loop(True) for _ in range(3))
    out["recorded"] = len(tracing.spans())
    tracing.clear()
    return out


def report(workload: str, seed: int, seconds: float, root=None) -> dict:
    from mcvd_tpu_torch import tracing
    from portbench.harness import cell, discovery, spans

    root = discovery.ROOT if root is None else root
    wl = discovery.load_workload(workload, root)
    mode = discovery.load_mode(wl["mode"], root)
    box, run = {}, mode.run

    def keep(ctx):
        box["out"] = out = run(ctx)
        return out

    mode.run = keep
    try:
        tracing.clear()
        result = cell.run_cell(workload, seed, seconds, True, "cuda", T0, root=root)
    finally:
        mode.run = run
    out = box["out"]
    events = out.reading.device_events
    sliced = spans.slice_spans(SimpleNamespace(reading=out.reading)) or []
    b = spans.buckets(out.reading, sliced)
    units = out.traced_units
    names = sorted({s.name for s in sliced})
    gn = discovery.load_count("gn_fused", root).KERNELS
    gn_starts = [s for n, s, _ in events if re.search(gn, n)]
    net = [s.start_ns for s in sliced if s.name in ("sample.eval", "train.forward")]
    gaps = sum(t1 - t0 for t0, t1 in spans.gaps(out.reading))
    return {
        "workload": workload, "seed": seed, "card": _card(), "traced_units": units,
        "per_unit_s": result.get("_per_unit_s"),
        "buckets_ms": {("-" if k is None else k): v / 1e6 for k, v in sorted(
            b.items(), key=lambda kv: -kv[1])},
        "per_unit_ms": {("-" if k is None else k): v / 1e6 / units for k, v in b.items()},
        "gaps_ms": gaps / 1e6, "buckets_sum_ms": sum(b.values()) / 1e6,
        "busy_ms": out.reading.busy_s * 1e3, "slice_ms": out.reading.window_s * 1e3,
        "span_counts": {n: sum(1 for s in sliced if s.name == n) for n in names},
        "clock": {"first_gn_fused_ns": min(gn_starts) if gn_starts else None,
                  "first_network_span_ns": min(net) if net else None,
                  "ok": bool(gn_starts and net and min(gn_starts) >= min(net))},
        "result": {k: v for k, v in result.items() if not k.startswith("_")},
    }


def _card() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/spans_report.py", description=__doc__)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--n", type=int, default=200000)
    args = ap.parse_args(argv)
    if not (args.span_cost or args.workload):
        ap.error("--workload or --span-cost")
    import torch
    if not torch.cuda.is_available():
        print("portbench/spans_report.py: no CUDA device found; it times the card's "
              "profiler and does not run on the CPU", file=sys.stderr)
        return 1
    if args.span_cost:
        out = span_cost(args.n)
    else:
        out = report(args.workload, args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
