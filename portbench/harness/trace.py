"""The timed window, and the traced slice: torch.profiler over whole
evaluations or steps, read in memory (no trace file is written).

`Window` times work by the host clock, synchronised at both ends; with
`trace=True` it also runs the profiler and reduces its events to a
`Reading`. A mode times its window untraced and, in a `--trace 1` run,
traces a slice of whole evaluations or steps after it: the tracer adds
host time to every launch (the flagship's sampling ran 24-35% slower
traced on an H100), so the slice gives what the device did an evaluation
or a step, and the untraced window what that took. A `Reading` holds
the device's activity intervals and their union (busy time),
each kernel's device time, the device operations that took most time, and
the longest idle gaps, each named by what the host was doing when it began
(the CUDA runtime call it was in, or host code between runtime calls) and
the device operation that ended it.

The profiler records CUDA activity only (kernels, copies, sets and the
runtime calls that issue them): recording every host operation as well
slowed the flagship's B=64 training step on an H100 from 221 ms (untraced;
225 ms with CUDA activity alone) to 265-296 ms and raised its idle share
from 15.7% to 28-36%, so the trace measured itself.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else 1000 * getattr(e, f"{what}_us")()


class Reading:
    """Device activity of one traced window (times in seconds)."""

    def __init__(self, device_events: List[Tuple[str, int, int]],
                 host_events: List[Tuple[int, int, str]], window_s: float):
        """device_events (name, start_ns, end_ns); host_events (start_ns,
        end_ns, name) of the thread that issued the work."""
        self.window_s = window_s
        self.device_events = device_events            # (name, start_ns, end_ns)
        spans = sorted((s, e) for _, s, e in device_events)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        self._merged = merged
        self._host = sorted(host_events)               # (start_ns, end_ns, name)
        by_start = sorted((s, n) for n, s, _ in device_events)
        self._starts = [s for s, _ in by_start]
        self._names = [n for _, n in by_start]

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [e - s for n, s, e in self.device_events if rx.search(n)]
        return sum(hits) / 1e9, len(hits)

    @property
    def n_kernels(self) -> int:
        return sum(1 for n, _, _ in self.device_events if not n.startswith(("Memcpy", "Memset")))

    def top_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(int)
        for n, s, e in self.device_events:
            by[n] += e - s
        return [[n[:200], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def _host_at(self, t: int) -> str:
        i = bisect.bisect_right(self._host, (t, float("inf"), ""))
        for j in range(i - 1, max(i - 64, -1), -1):
            s, e, n = self._host[j]
            if e >= t:
                return n
        return "host code"

    def _device_after(self, t: int) -> str:
        i = bisect.bisect_left(self._starts, t)
        return self._names[i] if i < len(self._names) else "end"

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest gaps between device activity, as ["<what the host was
        doing when it began> -> <the device operation that ended it>",
        seconds]."""
        m = self._merged
        gaps = sorted(((m[i + 1][0] - m[i][1], m[i][1], m[i + 1][0])
                       for i in range(len(m) - 1)), reverse=True)[:k]
        return [[f"{self._host_at(t0)[:80]} -> {self._device_after(t1)[:110]}", g / 1e9]
                for g, t0, t1 in gaps]


class Window:
    """with Window(device[, trace=True]) as w: ...work...; then w.seconds
    (host clock, synchronised at both ends) and, traced, w.reading."""

    def __init__(self, device, trace: bool = False):
        self.device, self.trace = device, trace
        self.reading: Optional[Reading] = None
        self._prof = None

    def __enter__(self):
        _sync(self.device)
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            cuda = torch.device(self.device).type == "cuda"
            self._prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                             else ProfilerActivity.CPU])
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.seconds = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.reading = self._read(self._prof)
            self._prof = None
        return False

    def _read(self, prof) -> Reading:
        from torch.autograd import DeviceType
        dev, host = [], defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            s = _ns(e, "start")
            d = _ns(e, "duration")
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.name(), s, s + d))
            else:
                host[e.start_thread_id()].append((s, s + d, e.name()))
        issuer = max(host.values(), key=len) if host else []   # the thread that launched
        return Reading(dev, issuer, self.seconds)
