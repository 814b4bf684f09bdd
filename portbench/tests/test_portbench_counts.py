"""The benchmark's counts: the network forward's FLOPs from the reference,
each kernel's operations and bytes against a hand count at one shape, the
peaks, and the shares computed from them."""

import math

import pytest

import pbtest_tiny  # noqa: F401  (puts the repository on sys.path)
from portbench.harness import cell, discovery, peaks, shares


@pytest.mark.parametrize("config,gflop", [("smmnist_DDPM_big5", 19.745), ("bair_big", 43.146)])
def test_forward_flops_per_clip(config, gflop):
    cfg = discovery.load_config(config)["config"]
    fwd = discovery.load_count("model_forward").forward(cfg, 2)
    assert round(fwd["flops"] / 2 / 1e9, 3) == gflop
    kinds = [c["kernel"] for c in fwd["calls"]]
    assert kinds.count("gn_fused") == 67 and kinds.count("attention_fwd") == 10


def test_peaks():
    assert peaks.FLOPS["float32"] == pytest.approx(165e12)
    assert peaks.FLOPS["bfloat16"] == 989e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.least_seconds(165e12, 0, "float32") == pytest.approx(1.0)
    assert peaks.least_seconds(1, 3.35e12, "bfloat16") == pytest.approx(1.0)


GN = dict(kernel="gn_fused", B=2, C=64, H=32, W=32, groups=16, affine=False, adagn=True,
          act=True)
ATTN = dict(kernel="attention_fwd", B=2, T=1024, H=2, D=64)


@pytest.mark.parametrize("kernel,call,dtype,flops,nbytes", [
    # n = 2*64*32*32 = 131,072 elements: 5 + 4 (SiLU) operations each; x in
    # and y out at 2 bytes, scale and shift 2 * 2 * 64 floats
    ("gn_fused", GN, "bfloat16", 9 * 131072, 4 * 131072 + 1024),
    # x, dy in and dx out at 4 bytes; scale/shift in and their gradients out
    ("gn_fused_bwd", dict(GN, affine=True), "float32", 16 * 131072,
     12 * 131072 + 2 * 4 * 2 * 64 + 2 * 4 * 2 * 2 * 64),
    # QK^T and PV: 2 * 2 * B H T^2 D; q, k, v in and o out
    ("attention_fwd", ATTN, "bfloat16", 4 * 2 * 2 * 1024 ** 2 * 64, 4 * 2 * 1024 * 2 * 64 * 2),
    # dV, dP, dQ, dK; q, k, v, o, dO in, dq, dk, dv out, the logsumexp in
    ("attention_bwd", ATTN, "float32", 8 * 2 * 2 * 1024 ** 2 * 64,
     8 * 2 * 1024 * 2 * 64 * 4 + 4 * 2 * 2 * 1024),
])
def test_kernel_counts_by_hand(kernel, call, dtype, flops, nbytes):
    count = discovery.load_count(kernel)
    assert count.work(call, dtype) == (flops, nbytes)
    assert count.least(call, dtype) == pytest.approx(
        max(flops / peaks.FLOPS[dtype], nbytes / peaks.HBM_BYTES_PER_S))


class FakeReading:
    def __init__(self, kernels, window_s, busy_s=None):
        self.device_events = [(n, 0, int(s * 1e9)) for n, s in kernels]
        self.window_s = window_s
        self.busy_s = busy_s

    def kernel_seconds(self, pattern):
        from portbench.harness.trace import Reading
        return Reading.kernel_seconds(self, pattern)


def fake_run(workload, kernels, window_s, units, traced=None):
    """A run whose untraced window took window_s for `units`, and whose traced
    slice (`traced`: its units, wall and busy seconds; by default the same
    units and wall) launched `kernels`."""
    wl = discovery.load_workload(workload)
    ctx = cell.Context(workload=wl, config_file=discovery.load_config(wl["config"]), seed=1,
                       seconds=1, trace=True, device="cpu", t0=0.0)
    t_units, t_wall, t_busy = traced or (units, window_s, None)
    out = cell.Outcome(e2e={}, setup_s=0, attempted=1, failed=0, window_s=window_s,
                       units=units, checks={}, reading=FakeReading(kernels, t_wall, t_busy),
                       traced_units=t_units)
    return cell.Run(ctx, out)


def test_roofline_share_from_counts_and_trace():
    name = "void attn_wg::fwd_kernel<__nv_bfloat16, 64, 2>(CUtensorMap_st)"
    run = fake_run("big5-sample-b100", [(name, 0.5), ("void other_kernel<>()", 9.0)], 10.0, 7)
    calls = [c for c in run.calls if c["kernel"] == "attention_fwd"]
    count = discovery.load_count("attention_fwd")
    least = sum(count.least(c, "bfloat16") for c in calls)
    assert all(c["B"] == 100 for c in calls)
    assert shares.roofline(run, "attention_fwd") == pytest.approx(100 * least * 7 / 0.5)
    assert shares.roofline(run, "gn_fused") is None   # no launch of it: nothing to read


def test_roofline_share_counts_the_traced_slice_alone():
    name = "void attn_wg::fwd_kernel<__nv_bfloat16, 64, 2>(CUtensorMap_st)"
    run = fake_run("big5-sample-b100", [(name, 0.5)], 30.0, 808, traced=(101, 5.0, 4.0))
    least = sum(discovery.load_count("attention_fwd").least(c, "bfloat16")
                for c in run.calls if c["kernel"] == "attention_fwd")
    assert shares.roofline(run, "attention_fwd") == pytest.approx(100 * least * 101 / 0.5)


def test_idle_share_is_the_untraced_windows():
    # the slice: 4 s busy over 8 steps (0.5 s a step), traced at 0.7 s a step;
    # the window: 40 steps in 25 s untraced, so 20 s busy and 20% idle
    run = fake_run("big5-train-b64", [("k", 4.0)], 25.0, 40, traced=(8, 5.6, 4.0))
    assert shares.idle(run) == pytest.approx(20.0)
    assert discovery.load_metric("idle_share.train").read(run) == pytest.approx(20.0)
    assert discovery.load_metric("idle_share.sample").read(run) is None
    assert shares.per_unit(run, 96) == 12
    assert shares.mfu(run, 3) == pytest.approx(
        100 * 3 * run.forward_flops * 64 * 40 / 25.0 / (495e12 / 3))


def test_mfu_uses_the_reference_flops_and_the_dtypes_peak():
    run = fake_run("bairbig-train-b64", [("k", 1.0)], 2.0, 10)
    want = 100 * 3 * 43.145945088e9 * 64 * 10 / 2.0 / (495e12 / 3)
    assert shares.mfu(run, 3) == pytest.approx(want, rel=1e-9)
    reader = discovery.load_metric("mfu.train")
    assert reader.read(run) == pytest.approx(want, rel=1e-9) and reader.UNIT == "%"
    assert discovery.load_metric("mfu.sample").read(run) is None
    assert math.isfinite(run.forward_flops)


def test_trace_reduction_from_one_timeline():
    from portbench.harness.trace import Reading

    dev = [("void attn_wg::fwd_kernel<>", 0, 10), ("k2", 20, 30), ("k2", 25, 40),
           ("Memcpy HtoD (Pinned -> Device)", 100, 110)]
    r = Reading(dev, [(5, 60, "cudaLaunchKernel"), (95, 99, "cudaMemcpyAsync")], 200e-9)
    assert r.busy_s == pytest.approx(40e-9)       # the union: overlaps counted once
    assert r.n_kernels == 3                        # copies and sets are not kernels
    assert r.kernel_seconds(r"attn_wg::fwd") == (pytest.approx(10e-9), 1)
    assert r.idle_gaps(2) == [["cudaLaunchKernel -> Memcpy HtoD (Pinned -> Device)",
                               pytest.approx(60e-9)],
                              ["cudaLaunchKernel -> k2", pytest.approx(10e-9)]]
    assert r.top_ops(1) == [["k2", pytest.approx(25e-9)]]
