"""One run of one cell: set up, warm, measure, check, and the result line.

    run_cell(cell, seed, seconds, trace) -> result dict (the last line)

The cell's workload file names its mode and configuration; the mode's
`run(ctx)` sets the program up, warms the cell's shapes, measures the
window (`trace.Window`), frees the program and checks what the window
produced against the reference. With `trace` the window is followed by a
traced slice of whole evaluations or steps, and the per-layer metrics'
readers (`metrics/*.py`) take their numbers from the window and the slice;
without it the result holds the mode's end-to-end metrics and `setup_s`.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

from . import discovery

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mcvd_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX
    package's (compared whole: `mcvd_tpu_torch` is not `mcvd_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    """What a mode's `run` gets: the cell, its configuration (the `config` of
    its configuration file), the run's arguments, and `system`, the program
    under test (None: the mode's own wrapper of the port; the tests and the
    calibration put a broken port or the mode's `Control`, the reference in
    a lower precision, in its place)."""
    workload: dict
    config_file: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    root: Path = discovery.ROOT
    system: Any = None

    @property
    def config(self) -> dict:
        return self.config_file["config"]


@dataclass
class Outcome:
    """What a mode's `run` returns."""
    e2e: Dict[str, float]
    setup_s: float
    attempted: int
    failed: int
    window_s: float
    units: int                        # evaluations or steps completed in the window
    checks: Dict[str, List[float]]    # name: [value, limit], the numbers compared
    readings: Dict[str, float] = field(default_factory=dict)   # every number the check read
    memory_peak_bytes: int = 0
    reading: Any = None               # trace.Reading of the traced slice after the window
    traced_units: int = 0             # evaluations or steps in the traced slice
    extra: Dict[str, float] = field(default_factory=dict)


class Run:
    """What a per-layer metric's reader gets: the cell, its mode and compute
    dtype, the outcome (the untimed window's `units` and `window_s`) and the
    traced slice's reading (`reading`, over `traced_units`), the reference's calls of one
    forward pass at the cell's batch (`calls`) and the forward's FLOPs per
    clip (`forward_flops`), both from `counts/model_forward.py`."""

    def __init__(self, ctx: Context, outcome: Outcome):
        self.ctx, self.outcome = ctx, outcome
        self.workload, self.config = ctx.workload, ctx.config
        self.mode = ctx.workload["mode"]
        self.dtype = ctx.workload["dtype"]
        self.batch = ctx.workload["batch"]
        self.reading = outcome.reading
        self.traced_units = outcome.traced_units
        self._fwd = None

    def _forward(self):
        if self._fwd is None:
            fwd = discovery.load_count("model_forward", self.ctx.root)
            self._fwd = fwd.forward(self.config, self.batch)
        return self._fwd

    @property
    def calls(self) -> List[dict]:
        return self._forward()["calls"]

    @property
    def forward_flops(self) -> float:
        """The network forward's FLOPs for one clip."""
        return self._forward()["flops"] / self.batch

    def count(self, kernel: str):
        return discovery.load_count(kernel, self.ctx.root)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t0: float,
             root: Path = discovery.ROOT, system=None) -> dict:
    wl = discovery.load_workload(cell, root)
    ctx = Context(workload=wl, config_file=discovery.load_config(wl["config"], root), seed=seed,
                  seconds=seconds, trace=trace, device=device, t0=t0, root=root,
                  system=system)
    mode = discovery.load_mode(wl["mode"], root)
    out: Outcome = mode.run(ctx)
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    correct = bool(checks) and all(_finite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks.values())
    if trace:
        run = Run(ctx, out)
        metrics = {}
        for name, reader in discovery.metric_readers(root).items():
            v = reader.read(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": reader.UNIT}
    else:
        metrics = {k: {"value": v, "unit": mode.E2E[k]} for k, v in out.e2e.items()}
        metrics["setup_s"] = {"value": out.setup_s, "unit": "s"}
    dev = {"platform": "gpu" if str(device).startswith("cuda") else str(device),
           "kind": _device_name(device), "count": int(wl.get("chips", 1)),
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev, "_setup_s": out.setup_s,
              "_window_s": out.window_s, "_readings": out.readings}
    if trace and out.reading is not None:
        dev["busy_s"] = out.reading.busy_s
        dev["window_s"] = out.reading.window_s
        result["_per_unit_s"] = [out.window_s / out.units,
                                 out.reading.window_s / out.traced_units]
        result["breakdown"] = {"device_ops": out.reading.top_ops(10),
                               "idle_gaps": out.reading.idle_gaps(10)}
    result["checks"] = checks
    return result   # the keys that start with `_` are for the log; the result line drops them


def _device_name(device) -> str:
    import torch
    if str(device).startswith("cuda"):
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"
