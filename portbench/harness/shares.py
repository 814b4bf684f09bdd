"""Shares of the card's peaks and the device's idle share, for the
per-layer metrics' readers: what the device did a unit (an evaluation or a
step) from the traced slice, what a unit took from the untraced window. A
reader that finds nothing to read gets None, never 0."""

from __future__ import annotations

from typing import Optional

from .peaks import FLOPS


def roofline(run, kernel: str) -> Optional[float]:
    """100 * least time / device time of `kernel` over the traced slice:
    the least time summed over the slice's calls (each forward's calls of
    the kernel's kind, from the reference's shapes at the cell's batch,
    times the forwards or steps in the slice), the device time summed over
    the launches whose names `counts/<kernel>.py` matches."""
    if run.reading is None or not run.traced_units:
        return None
    count = run.count(kernel)
    seconds, launches = run.reading.kernel_seconds(count.KERNELS)
    if launches == 0 or seconds <= 0:
        return None
    least = sum(count.least(c, run.dtype) for c in run.calls if c["kernel"] == count.CALLS)
    return 100.0 * least * run.traced_units / seconds


def mfu(run, passes: int) -> Optional[float]:
    """100 * model FLOPs of the work completed / window / peak: `passes`
    forwards' worth a clip (1 for an evaluation, 3 for a training step:
    forward and backward, no recomputation), over the untraced window."""
    if not run.outcome.units or run.outcome.window_s <= 0:
        return None
    flops = passes * run.forward_flops * run.batch * run.outcome.units
    return 100.0 * flops / run.outcome.window_s / FLOPS[run.dtype]


def idle(run) -> Optional[float]:
    """100 * (1 - busy / window) of the untraced window, its busy time the
    traced slice's union of device activity a unit times the window's
    units."""
    r, out = run.reading, run.outcome
    if r is None or not run.traced_units or r.busy_s <= 0 or out.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / run.traced_units * out.units / out.window_s)


def per_unit(run, n: float) -> Optional[float]:
    """n (a count from the traced slice) per evaluation or step of the slice."""
    if run.reading is None or not run.traced_units or not n:
        return None
    return n / run.traced_units
