"""Spans and counters of the port, read beside a `torch.profiler` trace.

A span, `with span(name): ...`, marks one phase of the program on the host:
a sampling request, a block, a network evaluation (`eval.video_gen`), a
training step and its forward, backward, optimizer and EMA (`train.step`),
the loader's wait (`data.prefetch_to_device`). Each records its name, an
id, its parent's id (the innermost span open on the same thread), its
root's id (the outermost one: shared by every span of one request or one
step), the thread and its start and end in ns.

Spans record only while a `torch.profiler` session is active (`enabled()`),
and then on the clock of the profiler's events, `time.time_ns()` (the
system clock: a profiled op's `start_ns()` falls inside a `time.time_ns()`
bracket around it, and a kernel launch's CUDA runtime event inside a span
around the launch, on the CPU and on an H100), so the spans and the device
trace of one session share a timeline. Off, a span costs one flag read and
allocates nothing; on, two clock reads and an append. A span never touches
the device: no CUDA event, no sync, no allocation on the card. Spans are
kept in memory; no file is written. `take()` returns them and empties the
store, which is how a caller reads one profiler session; `spans()` reads
without emptying (several readers of one session) and `clear()` empties.
The store keeps the newest `MAX_SPANS`, so a long run profiled on a
repeating schedule and never read holds a bounded number (the train step
opens six a step, the loader one a batch), and spans of an earlier session
that was not taken stay until then.

Counters are always on: plain integer adds into a family's dict, read as
`counters()` ("<family>.<key>" -> int). The families: `launch`, one counter
per hand-written kernel, bumped where its wrapper launches it (`ops.LAUNCHES`
is this family's dict); `data`, `batches` and `wait_ns`, bumped where
`prefetch_to_device` hands a batch over.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterable, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]    # None for a root span
    root: int
    thread: int              # threading.get_ident() of the thread that opened it
    start_ns: int            # time.time_ns(), the profiler's clock
    end_ns: int


MAX_SPANS = 1 << 18    # the newest spans kept (about 75 MB of them)
_SPANS: Deque[Span] = deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_LOCAL = threading.local()


def enabled() -> bool:
    """True while a torch.profiler session is active (the flag torch keeps
    for fast checks from Python)."""
    return _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "parent", "root", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _LOCAL.stack.pop()
        _SPANS.append(Span(self.name, self.id, self.parent, self.root,
                           threading.get_ident(), self.start, end))
        return False


def span(name: str):
    """A context manager that records the block as a span named `name` while
    a torch.profiler session is active, and does nothing otherwise."""
    if not enabled():
        return _OFF
    return _Open(name)


def spans() -> List[Span]:
    """The recorded spans, in the order they were opened."""
    return sorted(_SPANS, key=lambda s: s.id)


def clear() -> None:
    """Drop the recorded spans."""
    _SPANS.clear()


def take() -> List[Span]:
    """The recorded spans, in the order they were opened, and empty the
    store: read a profiler session's spans with this once it ends."""
    out = spans()
    clear()
    return out


_COUNTERS: Dict[str, Dict[str, int]] = {}


def family(name: str, keys: Iterable[str] = ()) -> Dict[str, int]:
    """The counters of family `name`: one plain dict (key -> int), made on
    first use, the same object at every call; `keys` are set to 0 where
    missing. Count with `d[key] += n`."""
    d = _COUNTERS.setdefault(name, {})
    for k in keys:
        d.setdefault(k, 0)
    return d


def counters() -> Dict[str, int]:
    """Every counter, as "<family>.<key>" -> value."""
    return {f"{f}.{k}": v for f, d in _COUNTERS.items() for k, v in d.items()}


def reset(name: str) -> None:
    """Set every counter of family `name` to 0."""
    d = _COUNTERS.get(name, {})
    for k in d:
        d[k] = 0
