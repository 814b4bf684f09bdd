"""The device's idle gaps put down to the program's spans.

The program (`mcvd_tpu_torch.tracing`) records spans while a
torch.profiler session is active, on the clock of the profiler's events,
so the spans of the traced slice share the slice's timeline. The rule, the
same for every idle metric:

  1. take the union of the slice's device activity intervals (the merged
     intervals `trace.Reading` keeps);
  2. give each gap between merged intervals to the innermost program span
     open when the gap began (start <= t < end), among the spans of the
     threads that opened root spans (the backward's kernels are issued on
     autograd's own thread while the main thread sits in `train.backward`);
     a gap that began in no such span goes to no span (`None`);
  3. divide by the number of spans of the unit.

A reader that finds no spans, or no device activity, returns None: the
program before its spans, and a trace on the CPU.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Gap = Tuple[int, int]          # (start_ns, end_ns)


def gaps(reading) -> List[Gap]:
    """The gaps between the reading's merged device intervals (the union
    `trace.Reading` takes its busy time from), first to last."""
    m = reading._merged
    return [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1) if m[i + 1][0] > m[i][1]]


def counted(spans: Sequence) -> list:
    """The spans of the threads that opened a root span."""
    threads = {s.thread for s in spans if s.parent is None}
    return [s for s in spans if s.thread in threads]


def innermost(gap_starts: Sequence[int], spans: Sequence) -> list:
    """For each time, the innermost span open at it (start <= t < end), or
    None; spans nest within a thread, and across threads the one opened
    last wins."""
    out = [None] * len(gap_starts)
    order = sorted(range(len(gap_starts)), key=lambda i: gap_starts[i])
    by_thread = defaultdict(list)
    for s in spans:
        by_thread[s.thread].append(s)
    for ss in by_thread.values():
        ss.sort(key=lambda s: (s.start_ns, -s.end_ns))
        stack, j = [], 0
        for i in order:
            t = gap_starts[i]
            while j < len(ss) and ss[j].start_ns <= t:
                while stack and stack[-1].end_ns <= ss[j].start_ns:
                    stack.pop()
                stack.append(ss[j])
                j += 1
            while stack and stack[-1].end_ns <= t:
                stack.pop()
            if stack and (out[i] is None or stack[-1].start_ns > out[i].start_ns):
                out[i] = stack[-1]
    return out


def buckets(reading, spans: Sequence) -> Dict[Optional[str], int]:
    """Idle ns of a `trace.Reading` by the name of the innermost counted span
    open when each gap began (None: in none). The values sum to the gaps
    between the first and the last device activity."""
    gs = gaps(reading)
    owner = innermost([g[0] for g in gs], counted(spans))
    out: Dict[Optional[str], int] = defaultdict(int)
    for (t0, t1), s in zip(gs, owner):
        out[None if s is None else s.name] += t1 - t0
    return dict(out)


def program_spans():
    """Every span the program recorded, or None where it records none: a
    checkout of the program from before its spans, with these readers laid
    over it (`mcvd_tpu_torch.tracing` missing), reads None and does not
    raise."""
    try:
        from mcvd_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def slice_spans(run) -> Optional[list]:
    """The program's spans of the traced slice: those that overlap the
    slice's window (its wall time back from its last device activity, with
    1% to spare), so a process that traced before keeps its own apart.
    None without spans or device activity."""
    r = run.reading
    found = program_spans()
    if r is None or not r.device_events or not found:
        return None
    end = max(e for _, _, e in r.device_events)
    start = end - 1.01e9 * r.window_s
    inside = [s for s in found if s.end_ns > start and s.start_ns < end]
    return inside or None


def idle_ms(run, names: Sequence[str], unit: str) -> Optional[float]:
    """ms of the slice's idle gaps that began with a span of `names`
    innermost, per span named `unit` in the slice."""
    sp = slice_spans(run)
    if sp is None:
        return None
    sp = counted(sp)
    n = sum(1 for s in sp if s.name == unit)
    if not n:
        return None
    b = buckets(run.reading, sp)
    return sum(b.get(k, 0) for k in names) / 1e6 / n


def mean_ms(run, name: str) -> Optional[float]:
    """The mean duration of the slice's spans named `name`, in ms."""
    sp = slice_spans(run)
    d = [s.end_ns - s.start_ns for s in counted(sp or ()) if s.name == name]
    return sum(d) / len(d) / 1e6 if d else None
