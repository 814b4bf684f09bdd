"""The readers that put the device's idle gaps down to the program's spans
(`harness/spans.py` and the metrics that use it), fed synthetic device
intervals and spans: a gap goes to the innermost open span, the spans of a
thread that opened no root span are ignored, a gap outside every span goes
to no metric, and no spans read None."""

import sys
from collections import namedtuple
from types import SimpleNamespace

import pytest

import pbtest_tiny  # noqa: F401  (puts the repository on the path)
from portbench.harness import discovery, spans
from portbench.harness.trace import Reading

MS = 1_000_000   # ns
T0 = 1_700_000_000 * 10 ** 9   # a system-clock time, as the profiler's events carry
S = namedtuple("S", "name id parent root thread start_ns end_ns")


def _span(name, id, parent, root, start, end, thread=1):
    return S(name, id, parent, root, thread, T0 + start * MS, T0 + end * MS)


def _dev(*intervals):
    return [("k", T0 + a * MS, T0 + b * MS) for a, b in intervals]


def _reading(events, window_s=1.0):
    return Reading(events, [], window_s)


def _run(mode, events, window_s=1.0):
    return SimpleNamespace(mode=mode, reading=_reading(events, window_s))


def _read(metric, run):
    return discovery.load_metric(metric).read(run)


# a request of one block of two evaluations; device work around them
SAMPLE = [_span("sample.request", 1, None, 1, 0, 100),
          _span("sample.block", 2, 1, 1, 5, 95),
          _span("sample.eval", 3, 2, 1, 10, 40),
          _span("sample.eval", 4, 2, 1, 50, 80)]
# gaps begin at 8 (block), 20 (eval), 45 (block), 70 (eval), 110 (no span)
SAMPLE_DEV = _dev((0, 8), (12, 20), (30, 45), (60, 70), (85, 110), (120, 130))


@pytest.fixture
def recorded(monkeypatch):
    box = {"spans": []}
    monkeypatch.setattr(spans, "program_spans", lambda: box["spans"])
    return box


def test_a_gap_goes_to_the_innermost_open_span(recorded):
    recorded["spans"] = SAMPLE
    b = spans.buckets(_reading(SAMPLE_DEV), SAMPLE)
    assert b == {"sample.block": 4 * MS + 15 * MS, "sample.eval": 10 * MS + 15 * MS,
                 None: 10 * MS}
    run = _run("sample", SAMPLE_DEV)
    assert _read("eval_idle_ms.sample", run) == pytest.approx(25 / 2)
    assert _read("edge_idle_ms.sample", run) == pytest.approx(19 / 1)
    assert _read("forward_idle_ms.train", run) is None   # a sampling run


def test_the_buckets_sum_to_the_gaps_between_first_and_last_activity():
    total = sum(b - a for a, b in spans.gaps(_reading(SAMPLE_DEV)))
    assert total == (4 + 10 + 15 + 15 + 10) * MS
    assert sum(spans.buckets(_reading(SAMPLE_DEV), SAMPLE).values()) == total
    # overlapping device intervals merge before the gaps are taken
    merged = _reading(_dev((0, 10), (5, 20), (25, 30)))
    assert spans.gaps(merged) == [(T0 + 20 * MS, T0 + 25 * MS)]


def test_spans_of_a_thread_that_opened_no_root_are_ignored(recorded):
    # opened last and open at 45 and 70, but on a thread with no root span
    stray = _span("sample.eval", 9, 3, 1, 44, 75, thread=2)
    recorded["spans"] = SAMPLE + [stray]
    assert spans.counted(recorded["spans"]) == SAMPLE
    run = _run("sample", SAMPLE_DEV)
    assert _read("eval_idle_ms.sample", run) == pytest.approx(25 / 2)
    assert _read("edge_idle_ms.sample", run) == pytest.approx(19)
    # a second thread with its own root counts, and the span opened last wins
    other = [_span("sample.request", 10, None, 10, 42, 48, thread=3)]
    assert spans.buckets(_reading(SAMPLE_DEV), SAMPLE + other)["sample.request"] == 15 * MS


def test_gaps_outside_every_span_go_to_no_metric(recorded):
    recorded["spans"] = SAMPLE
    later = _dev((0, 8), (12, 20), (30, 45), (60, 70), (85, 110), (120, 130), (200, 210))
    run = _run("sample", later)
    assert _read("eval_idle_ms.sample", run) == pytest.approx(25 / 2)
    assert _read("edge_idle_ms.sample", run) == pytest.approx(19)
    assert spans.buckets(_reading(later), SAMPLE)[None] == 10 * MS + 70 * MS


def test_no_spans_or_no_device_activity_read_none(recorded, monkeypatch):
    names = ["eval_idle_ms.sample", "edge_idle_ms.sample", "forward_idle_ms.train",
             "backward_idle_ms.train", "update_idle_ms.train", "prefetch_wait_ms.train"]
    for spans_now in ([], None):
        recorded["spans"] = spans_now
        for name in names:
            mode = name.rsplit(".", 1)[1]
            assert _read(name, _run(mode, SAMPLE_DEV)) is None, name
    recorded["spans"] = SAMPLE
    assert _read("eval_idle_ms.sample", _run("sample", [])) is None
    # spans of an earlier traced slice, outside this slice's window, are left out
    old = [s._replace(start_ns=s.start_ns - 60 * 10 ** 9, end_ns=s.end_ns - 60 * 10 ** 9)
           for s in SAMPLE]
    recorded["spans"] = old
    assert _read("eval_idle_ms.sample", _run("sample", SAMPLE_DEV)) is None
    # the program before its spans: no tracing module to import
    monkeypatch.undo()
    import mcvd_tpu_torch
    monkeypatch.delattr(mcvd_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "mcvd_tpu_torch.tracing", None)
    assert spans.program_spans() is None


def test_the_train_step_readers(recorded):
    # two steps: forward, backward, optimizer, ema each; a data wait before each
    step = []
    for k, t in enumerate((0, 100)):
        r = 10 * k + 1
        step += [_span("data.wait", r + 9, None, r + 9, t - 4, t - 1),
                 _span("train.step", r, None, r, t, t + 90),
                 _span("train.forward", r + 1, r, r, t + 1, t + 30),
                 _span("train.backward", r + 2, r, r, t + 30, t + 60),
                 _span("train.optimizer", r + 3, r, r, t + 62, t + 70),
                 _span("train.ema", r + 4, r, r, t + 70, t + 88)]
    recorded["spans"] = step
    # per step: gaps at +20 (forward, 2), +50 (backward, 6), +61 (step, 1),
    # +65 (optimizer, 3), +80 (ema, 5); between steps, at 95 (none) and -2 (data.wait)
    dev = []
    for t in (0, 100):
        dev += [(t + 1, t + 20), (t + 22, t + 50), (t + 56, t + 61), (t + 62, t + 65),
                (t + 68, t + 80), (t + 85, t + 95)]
    dev.insert(6, (96, 98))
    run = _run("train", _dev(*dev))
    assert _read("forward_idle_ms.train", run) == pytest.approx(2)
    assert _read("backward_idle_ms.train", run) == pytest.approx(6)
    assert _read("update_idle_ms.train", run) == pytest.approx(3 + 5)
    assert _read("prefetch_wait_ms.train", run) == pytest.approx(3)
    assert _read("eval_idle_ms.sample", run) is None   # a training run
    b = spans.buckets(run.reading, step)
    assert b["train.step"] == 2 * MS and b[None] == 1 * MS and b["data.wait"] == 3 * MS
