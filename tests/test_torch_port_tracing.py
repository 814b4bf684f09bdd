"""The port's spans and counters (`mcvd_tpu_torch.tracing`): spans record
only under a torch.profiler session, on the profiler's clock, nested per
thread; the counters always count; the block sampler, the train step and
the device prefetch record one span per phase. On the CPU at a tiny size;
the `cuda` test holds a span to a kernel launch's runtime event on the
card."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcvd_tpu_torch import ops, tracing
from mcvd_tpu_torch.config import flagship_config
from mcvd_tpu_torch.data import prefetch_to_device
from mcvd_tpu_torch.diffusion import make_schedule
from mcvd_tpu_torch.diffusion.schedules import subsample_schedule
from mcvd_tpu_torch.eval import video_gen
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.train import create_train_state, make_train_step


@pytest.fixture(autouse=True)
def _fresh():
    tracing.clear()
    yield
    tracing.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _named(name):
    return [s for s in tracing.spans() if s.name == name]


def test_enabled_follows_the_profiler_session():
    assert tracing.enabled() is False
    with _cpu_profile():
        assert tracing.enabled() is True
    assert tracing.enabled() is False


def test_nothing_is_recorded_without_a_profiler_while_counters_count():
    before = tracing.counters()
    with tracing.span("outer"):
        with tracing.span("inner"):
            ops.count_launch("gn_fused")
    assert tracing.spans() == []
    after = tracing.counters()
    assert after["launch.gn_fused"] == before["launch.gn_fused"] + 1
    assert ops.LAUNCHES is tracing.family("launch")
    ops.reset_launches()
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert set(ops.LAUNCHES) == {"gn_fused", "gn_fused_bwd", "attention_fwd", "attention_bwd",
                                 "fused_leaky_relu", "gn_copy", "gn_variant"}


def test_a_span_off_is_one_shared_object():
    assert tracing.span("a") is tracing.span("b")
    with _cpu_profile():
        assert tracing.span("a") is not tracing.span("a")


def test_spans_nest_per_thread_and_bracket_the_profilers_events():
    x = torch.randn(64, 64)
    box = {}

    def other():
        with tracing.span("other"):
            box["thread"] = threading.get_ident()

    with _cpu_profile() as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                x @ x
            with tracing.span("second"):
                pass
            t = threading.Thread(target=other)
            t.start()
            t.join()
    outer, inner, second = (_named(n)[0] for n in ("outer", "inner", "second"))
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == outer.id and inner.root == outer.id
    assert second.parent == outer.id and second.root == outer.id
    assert inner.thread == outer.thread == threading.get_ident()
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns
    # a span on another thread opens a root of its own
    o = _named("other")[0]
    assert o.parent is None and o.root == o.id and o.thread == box["thread"] != outer.thread
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start = mm[0].start_ns()
    assert inner.start_ns <= start <= start + mm[0].duration_ns() <= inner.end_ns
    assert [s.name for s in tracing.spans()] == ["outer", "inner", "second", "other"]


def test_take_reads_a_session_once_and_the_store_keeps_the_newest(monkeypatch):
    with _cpu_profile():
        for name in ("a", "b"):
            with tracing.span(name):
                pass
    assert [s.name for s in tracing.take()] == ["a", "b"]
    assert tracing.spans() == [] and tracing.take() == []
    monkeypatch.setattr(tracing, "_SPANS", type(tracing._SPANS)(maxlen=3))
    with _cpu_profile():
        for k in range(5):
            with tracing.span(f"s{k}"):
                pass
    assert [s.name for s in tracing.take()] == ["s2", "s3", "s4"]


def _tiny(subsample=4):
    config = flagship_config(tiny=True)
    config.sampling.subsample = subsample
    config.model.dropout = 0.0
    return config


def test_the_block_sampler_records_a_request_its_blocks_and_evaluations():
    config = _tiny()
    model = get_model(config, device="cpu")
    sched = make_schedule(config)
    L = len(subsample_schedule(sched, config.sampling.subsample)[0])   # steps a block
    block = video_gen.make_block_sampler(config, model, sched)
    C, Fc, sz = config.data.channels, config.data.num_frames_cond, config.data.image_size
    cond = torch.rand(2, sz, sz, Fc * C) * 2 - 1
    gen = torch.Generator().manual_seed(0)
    n_blocks = 2
    with _cpu_profile():
        out = video_gen.autoregressive_predict(
            config, block, dict(model.named_parameters()), cond, None,
            n_blocks * config.data.num_frames, 0, sched, generator=gen)
    assert out.shape == (2, sz, sz, n_blocks * config.data.num_frames * C)
    (req,) = _named("sample.request")
    blocks, evals = _named("sample.block"), _named("sample.eval")
    assert len(blocks) == n_blocks
    assert len(evals) == n_blocks * (L + 1)   # L steps and the denoising evaluation
    assert all(b.parent == req.id and b.root == req.id for b in blocks)
    for b in blocks:
        inside = [e for e in evals if e.parent == b.id]
        assert len(inside) == L + 1
        assert all(b.start_ns <= e.start_ns <= e.end_ns <= b.end_ns and e.root == req.id
                   for e in inside)


def test_the_train_step_records_its_phases_in_order_under_one_step():
    config = _tiny()
    config.training.batch_size = 2
    model = get_model(config, device="cpu")
    state = create_train_state(config, model, device="cpu")
    step = make_train_step(model, make_schedule(config), config)
    d = config.data
    X = torch.rand(2, d.num_frames_cond + d.num_frames, d.image_size, d.image_size, d.channels)
    with _cpu_profile():
        state, metrics = step(state, X, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss"]))
    got = tracing.spans()
    assert [s.name for s in got] == ["train.step", "train.forward", "train.backward",
                                     "train.optimizer", "train.ema"]
    root, phases = got[0], got[1:]
    assert root.parent is None
    assert all(s.parent == root.id and s.root == root.id for s in phases)
    ends = [root.start_ns] + [t for s in phases for t in (s.start_ns, s.end_ns)] + [root.end_ns]
    assert ends == sorted(ends)


def test_prefetch_records_its_wait_and_counts_batches():
    def endless():
        i = 0
        while True:
            yield (np.full((2, 3), i, np.float32),)
            i += 1

    data = tracing.family("data")
    batches, wait = data["batches"], data["wait_ns"]
    with _cpu_profile():
        it = prefetch_to_device(endless(), "cpu", size=2)
        got = [int(next(it)[0][0, 0]) for _ in range(4)]
        it.close()
    assert got == [0, 1, 2, 3]
    waits = _named("data.wait")
    assert len(waits) == 4
    assert all(w.parent is None and w.thread == threading.get_ident() for w in waits)
    assert data["batches"] == batches + 4
    assert data["wait_ns"] > wait
    # off, the counters still count and no span is kept
    tracing.clear()
    it = prefetch_to_device(endless(), "cpu", size=2)
    next(it)
    it.close()
    assert data["batches"] == batches + 5 and tracing.spans() == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the runtime events of a launch exist only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_brackets_its_kernel_launch_on_the_card(cuda):
    x = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("launch"):
            y = x + 1
        torch.cuda.synchronize()
    assert float(y[0]) == 2.0
    (s,) = _named("launch")
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if "LaunchKernel" in e.name()]
    assert launches, sorted({e.name() for e in events})
    for e in launches:
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns
    kernels = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
               and "LaunchKernel" not in e.name()]
    assert kernels and all(e.start_ns() >= s.start_ns for e in kernels)
