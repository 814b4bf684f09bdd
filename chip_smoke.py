#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA toolkit) and triton; builds the port's
kernels from `mcvd_tpu_torch/csrc` and `mcvd_tpu_torch/ops` at first use.
Imports torch, numpy and `mcvd_tpu_torch` only (no jax). Phases, one JSON
line each:

  1. env       torch/CUDA versions and the card's name and power limit;
  2. build     the nvcc build and the first Triton compile, in seconds;
  3. kernels   each kernel against its plain PyTorch version at the main
               path's shapes, fp32 (TF32 off) and bf16: max abs error and
               median device ms of both, and of the one PyTorch call that
               computes the same function where there is one
               (`F.group_norm` for the affine GroupNorm,
               `F.scaled_dot_product_attention`), timed for comparison only;
  4. profile_gn2  the GroupNorm microbenchmark's kernels (`gn_copy`,
               `gn_variant`) and `fused_leaky_relu` against their plain
               versions at the tool's shapes, `gn_variant` against the port's
               GroupNorm; then the tool's own run
               (`mcvd_tpu_torch.tools.profile_gn2.measure`) and the
               `fused_leaky_relu` op at a main-path activation, with their
               launch counts: device ms and host us per call of each line;
  5. slice     one flagship block (ngf=64, 10 steps + denoise, B=4, fp32)
               through the kernels and under `ops.reference_ops()`, same
               weights and draws; the parameter count;
  6. headline  the bench protocol: B=16, 100-step DDPM + denoise, 16 frames
               of 64x64 predicted in 4 blocks of 5 on 5 cond frames, bf16
               score network; one warm-up, 3 timed requests, frames/s, and
               the launch counts of each request.

Then the per-kernel summary line (with each kernel's bound: the larger of
its bytes over the HBM rate and its operations over the peak rate for its
type), the card line, and last {"ok": true, "device": {...}}. Any failed
check raises: the exit code is nonzero and the last line is not printed.
"""

import json
import statistics
import sys
import time
from math import ceil

import torch
import torch.nn.functional as F

FLAGSHIP_PARAM_COUNT = 27_941_765   # jax.eval_shape of the JAX flagship init
GN_SHAPES = [(64, 64), (192, 64), (128, 32), (256, 8)]   # (C, H) at B=16
ATTN_SHAPES = [(1024, 2), (256, 3), (64, 4)]             # (T, heads), D=64, B=16
GN_FORMS = {  # name: (eps, affine, adagn, act)
    "adagn_silu": (1e-5, False, True, True),
    "affine": (1e-6, True, False, False),
    "affine_silu": (1e-5, True, False, True),
}
# Kernel vs plain, both computing in fp32. fp32: the sums run in another
# order (1e-4 over up to 4096*192 terms). bf16: both round the same fp32
# value once to bf16, so they differ by at most one rounding step where the
# two fp32 values straddle a boundary: two bf16 ulps relative.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 1.6e-2)}  # (atol, rtol)
# gn_variant vs its plain version: as TOL. With stats_bf16 each channel's
# fp32 sums, taken in another order, are rounded to bf16; where the two land
# on either side of a bf16 boundary a statistic moves by one bf16 step, which
# moves y by up to ~1e-2 at the tool's inputs.
STATS_BF16_TOL = (1e-2, 1.6e-2)
# fused_leaky_relu vs plain: both compute in fp32 and round once.
ACT_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (0.0, 2 ** -7)}
# Published H100 SXM peaks (NVIDIA's data sheet): dense FLOP/s of fp32 on
# the CUDA cores and of bf16 on the tensor cores (the HBM3 rate is the
# tool's, `profile_gn2.HBM_BYTES_PER_S`).
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
# The flagship block, fp32: 11 evaluations of the 27.9M-parameter network
# whose sums run in another order; the first steps divide eps by
# sqrt(alpha) ~ 0.0067 before the x0 clip.
SLICE_ATOL = 5e-3


def emit(phase, **payload):
    print(json.dumps({"phase": phase, **payload}), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def device_ms(fn, n=10, reps=5):
    """Median device time of one fn() call: the card first sleeps, so the
    host has enqueued all n calls before the card reaches them and the
    events time back-to-back work, not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(nbytes, flops, peak):
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once."""
    from mcvd_tpu_torch.tools.profile_gn2 import HBM_BYTES_PER_S

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_launches(launches, want, what):
    """The phase launched exactly `want` of its kernels and none of the rest."""
    full = {k: want.get(k, 0) for k in launches}
    check(launches == full, f"{what} launch counts {launches}, want {full}")


def max_err(got, want, dtype_name, tol=None):
    atol, rtol = tol or TOL[dtype_name]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    ok = bool((diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def record(summary, kernel, dtype_name, err):
    """Keep the largest error of each kernel, overall and in fp32."""
    s = summary[kernel]
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if dtype_name == "float32":
        s["max_abs_err_fp32"] = max(s["max_abs_err_fp32"], err)


def phase_env():
    from mcvd_tpu_torch.tools.profile_gn2 import nvidia_smi

    card = nvidia_smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), card=card)
    return card


def phase_build():
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    nvcc_s = time.perf_counter() - t0
    x = torch.randn(2, 64, 8, 8, device="cuda").contiguous(memory_format=torch.channels_last)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ops.groupnorm.group_norm(x, 32, eps=1e-5, act=True)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    emit("build", nvcc_s=nvcc_s, nvcc_compile_s=_build.BUILD_SECONDS[0],
         triton_first_compile_s=triton_s)


def phase_kernels(card):
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.models.layers import num_groups_for
    from mcvd_tpu_torch.ops import attention as A
    from mcvd_tpu_torch.ops import groupnorm as GN

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    B = 16
    cases = []
    summary = {k: {"max_abs_err": 0.0, "max_abs_err_fp32": 0.0} for k in ops.LAUNCHES}

    gn_cases = [(C, H, 1, form) for C, H in GN_SHAPES for form in GN_FORMS]
    gn_cases.append((64, 32, 2, "adagn_silu"))   # frames_last=2: C*N = 128
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for C, H, N, form in gn_cases:
                eps, affine, adagn, act = GN_FORMS[form]
                CN = C * N
                G = num_groups_for(C)
                x = (torch.randn(B, H, H, CN, generator=g, device=dev) * 2 + 0.5).to(dtype)
                x = x.permute(0, 3, 1, 2)   # channels_last NCHW
                kw = dict(eps=eps, frames_last=N, act=act)
                if affine:
                    kw["gamma"] = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
                    kw["beta"] = 0.1 * torch.randn(C, generator=g, device=dev)
                if adagn:
                    kw["scale"] = (0.1 * torch.randn(B, CN, generator=g, device=dev)).to(dtype)
                    kw["shift"] = (0.1 * torch.randn(B, CN, generator=g, device=dev)).to(dtype)
                # the whole GroupNorm: gn_stats + combine + gn_apply vs plain
                got = GN.group_norm(x, G, **kw)
                with ops.reference_ops():
                    want = GN.group_norm(x, G, **kw)
                err, ok = max_err(got, want, dn)
                check(ok, f"group_norm {form} C={C} H={H} N={N} {dn}: max err {err}")
                # gn_stats alone, as per-group mean and E[x^2]
                n = H * H * CN // G
                part = GN.gn_stats(x, G)
                ref = GN.gn_stats_reference(x, G)
                s_err = float((part.sum(1) / n - ref.sum(1) / n).abs().max())
                check(s_err <= 1e-5 * max(1.0, float((ref.sum(1) / n).abs().max())),
                      f"gn_stats C={C} H={H} N={N} {dn}: max err {s_err}")
                # gn_apply alone, on the same fp32 A, B
                Am, Bm = GN.fold_stats(ref, n, CN, eps=eps, frames_last=N,
                                       **{k: kw[k] for k in ("gamma", "beta", "scale", "shift")
                                          if k in kw})
                a_err, a_ok = max_err(GN.gn_apply(x, Am, Bm, act),
                                      GN.gn_apply_reference(x, Am, Bm, act), dn)
                check(a_ok, f"gn_apply C={C} H={H} N={N} {dn}: max err {a_err}")
                record(summary, "gn_stats", dn, s_err)
                record(summary, "gn_apply", dn, a_err)
                case = dict(op="group_norm", form=form, B=B, C=C, H=H, frames_last=N,
                            dtype=dn, max_abs_err=err, gn_stats_err=s_err,
                            gn_apply_err=a_err)
                if N == 1 and form in ("adagn_silu", "affine") or (C, H) == (192, 64):
                    case["ms"] = device_ms(lambda: GN.group_norm(x, G, **kw))
                    with ops.reference_ops():
                        case["plain_ms"] = device_ms(lambda: GN.group_norm(x, G, **kw))
                    case["gn_stats_ms"] = device_ms(lambda: GN.gn_stats(x, G))
                    case["gn_stats_plain_ms"] = device_ms(lambda: GN.gn_stats_reference(x, G))
                    case["gn_apply_ms"] = device_ms(lambda: GN.gn_apply(x, Am, Bm, act))
                    case["gn_apply_plain_ms"] = device_ms(
                        lambda: GN.gn_apply_reference(x, Am, Bm, act))
                    case["bound_ms"], case["bound_by"] = bound(
                        2 * nbytes(x), 8 * x.numel(), "fp32")
                    case["gn_stats_bound"] = bound(nbytes(x, part), 3 * x.numel(), "fp32")
                    case["gn_apply_bound"] = bound(nbytes(x, x, Am, Bm), 6 * x.numel(), "fp32")
                    if form == "affine":   # one PyTorch call computes it, for comparison
                        w, b = kw["gamma"].to(dtype), kw["beta"].to(dtype)
                        case["library_ms"] = device_ms(lambda: F.group_norm(x, G, w, b, eps))
                cases.append(case)

            for T, h in ATTN_SHAPES:
                qkv = torch.randn(B, T, 3 * h * 64, generator=g, device=dev).to(dtype)
                got = A.attention_packed(qkv, h, 0.125)
                with ops.reference_ops():
                    want = A.attention_packed(qkv, h, 0.125)
                err, ok = max_err(got, want, dn)
                check(ok, f"attention T={T} h={h} {dn}: max err {err}")
                record(summary, "attention_fwd", dn, err)
                case = dict(op="attention", B=B, T=T, heads=h, head_dim=64, dtype=dn,
                            max_abs_err=err,
                            ms=device_ms(lambda: A.attention_packed(qkv, h, 0.125)),
                            plain_ms=device_ms(
                                lambda: A.attention_packed_reference(qkv, h, 0.125)))
                # the one PyTorch call, on (B, h, T, D) made before timing
                q, k, v = (t.reshape(B, T, h, 64).transpose(1, 2).contiguous()
                           for t in qkv.split(h * 64, dim=-1))
                case["library_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125))
                case["bound_ms"], case["bound_by"] = bound(
                    nbytes(qkv) * 4 // 3, 4 * B * h * T * T * 64,
                    "bf16" if dtype == torch.bfloat16 else "fp32")
                cases.append(case)
    torch.cuda.synchronize()
    emit("kernels", card=card, cases=cases)
    return cases, summary


def phase_profile_gn2(card, summary):
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.ops import fused_act as FA
    from mcvd_tpu_torch.ops import groupnorm as GN
    from mcvd_tpu_torch.tools import profile_gn2 as P

    dev = "cuda"
    G = 32
    x64, x128, prm = P.inputs(dev, seed=1)
    v64, v128 = x64.permute(0, 3, 1, 2), x128.permute(0, 3, 1, 2)
    g = torch.Generator(device=dev).manual_seed(4)
    act_x = torch.randn(16, 64, 64, 64, generator=g, device=dev).permute(0, 3, 1, 2)
    act_b = torch.randn(64, generator=g, device=dev)
    cases, timing = [], {}

    def vs_plain(fn):
        got = fn()
        with ops.reference_ops():
            want = fn()
        return got, want

    with torch.inference_mode():
        # 1. each kernel against its plain version at the tool's shapes
        for x in (x64, x128):
            got, want = vs_plain(lambda: P.make_copy(x.shape)(x))
            check(torch.equal(got, want) and torch.equal(got, x),
                  f"gn_copy {tuple(x.shape)} is not exact")
            record(summary, "gn_copy", "bfloat16", 0.0)
            cases.append(dict(op="gn_copy", shape=list(x.shape), dtype="bfloat16",
                              max_abs_err=0.0))
        variants = [("baseline", v64, 64, {}), ("parallel", v64, 64, dict(parallel=True)),
                    ("hsplit4", v64, 64, dict(hsplit=4, parallel=True)),
                    ("stats_bf16", v64, 64, dict(stats_bf16=True, parallel=True)),
                    ("lane_full", v128, 128, {})]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for label, v, c, kw in variants:
                xv = v.to(dtype)
                got, want = vs_plain(lambda: P.gn_variant(xv, G, *prm[c], **kw))
                err, ok = max_err(got, want, dn, STATS_BF16_TOL if "stats_bf16" in kw else None)
                check(ok, f"gn_variant {label} {dn}: max err {err}")
                record(summary, "gn_variant", dn, err)
                case = dict(op="gn_variant", variant=label, shape=list(v.shape), dtype=dn,
                            max_abs_err=err)
                if "hsplit" not in kw:
                    # 2. the one-launch variant is the port's GroupNorm
                    gamma, beta, scale, shift = prm[c]
                    ref = GN.group_norm(xv, G, eps=P.EPS, gamma=gamma, beta=beta,
                                        scale=scale, shift=shift, act=True)
                    gerr, gok = max_err(got, ref, dn,
                                        STATS_BF16_TOL if "stats_bf16" in kw else None)
                    check(gok, f"gn_variant {label} {dn} vs group_norm: max err {gerr}")
                    case["vs_group_norm_err"] = gerr
                cases.append(case)
            xa = act_x.to(dtype)
            for b in (act_b, None):
                got, want = vs_plain(lambda: FA.fused_leaky_relu(xa, b, dim=1))
                err, ok = max_err(got, want, dn, ACT_TOL[dn])
                check(ok, f"fused_leaky_relu {dn} bias={b is not None}: max err {err}")
                record(summary, "fused_leaky_relu", dn, err)
                cases.append(dict(op="fused_leaky_relu", shape=list(xa.shape), dtype=dn,
                                  bias=b is not None, max_abs_err=err))

        # the kernels' times at the tool's bf16 shapes, beside plain and library
        xa = act_x.to(torch.bfloat16)
        timing["gn_copy"] = dict(
            ms=device_ms(lambda: P.gn_copy(x64)),
            plain_ms=device_ms(lambda: P.copy_reference(x64)),
            library_ms=device_ms(lambda: torch.mul(x64, 1.0000001)),
            bound=bound(2 * nbytes(x64), x64.numel(), "fp32"))
        timing["gn_variant"] = dict(
            ms=device_ms(lambda: P.gn_variant(v64, G, *prm[64])),
            plain_ms=device_ms(lambda: P.gn_variant_reference(v64, G, *prm[64])),
            library_ms=None,   # no one PyTorch call does GroupNorm + AdaGN + SiLU
            bound=bound(2 * nbytes(v64) + nbytes(*prm[64]), 13 * v64.numel(), "fp32"))
        timing["fused_leaky_relu"] = dict(
            ms=device_ms(lambda: FA.fused_leaky_relu(xa, act_b, dim=1)),
            plain_ms=device_ms(lambda: FA.fused_leaky_relu_reference(xa, act_b, dim=1)),
            library_ms=None,   # no one PyTorch call does bias + LeakyReLU + scale
            bound=bound(2 * nbytes(xa) + nbytes(act_b), 3 * xa.numel(), "fp32"))

    # 3. the slice's own paths: the tool's run, then the op at a main-path
    # activation (B=16, C=64, 64x64, bf16, channels_last)
    torch.cuda.synchronize()
    ops.reset_launches()
    lines = P.measure(dev)
    with torch.inference_mode():
        y = FA.fused_leaky_relu(xa, act_b, dim=1)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(bool(torch.isfinite(y.float()).all()), "fused_leaky_relu output not finite")
    for k in ("gn_copy", "gn_variant", "fused_leaky_relu", "gn_stats", "gn_apply"):
        check(launches[k] > 0, f"profile_gn2 launched no {k}: {launches}")
    check(launches["attention_fwd"] == 0, f"profile_gn2 launched attention: {launches}")
    for line in lines:
        check(line["ms"] > 0 and line["host_us"] > 0, f"profile_gn2 line {line}")
    emit("profile_gn2", card=card, device=torch.cuda.get_device_name(0),
         hbm_spec_gb_per_s=P.HBM_BYTES_PER_S / 1e9, cases=cases, lines=lines,
         launches=launches)
    return timing, launches


def phase_slice(card):
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.config import flagship_config
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.eval import make_block_sampler
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.models.layers import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = flagship_config()
    config.sampling.subsample = 10
    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == FLAGSHIP_PARAM_COUNT, f"{n_params} params, JAX has {FLAGSHIP_PARAM_COUNT}")
    # The zero-scale inits (each resblock's Conv_1, NIN_3, the output conv)
    # leave a fresh model's eps near 1e-9, which would hide the kernels from
    # this check: redraw those layers at scale 1.
    for m in model.modules():
        if getattr(m, "init_scale", None) == 0.0:
            m.init_scale = 1.0
    init_weights(model, torch.Generator().manual_seed(1))
    sched = make_schedule(config)
    block = make_block_sampler(config, model, sched)

    B, sz = 4, config.data.image_size
    g = torch.Generator(device="cuda").manual_seed(2)
    cond = torch.rand(B, sz, sz, 5, generator=g, device="cuda") * 2 - 1
    init = torch.randn(B, sz, sz, 5, generator=g, device="cuda")
    step_noise = torch.randn(10, B, sz, sz, 5, generator=g, device="cuda")
    with torch.inference_mode():
        eps = model(init.permute(0, 3, 1, 2), torch.zeros(B, dtype=torch.long, device="cuda"),
                    cond.permute(0, 3, 1, 2))
    eps_std = float(eps.float().std())
    check(eps_std > 0.05, f"eps std {eps_std}: the network output is degenerate")
    ops.reset_launches()
    got = block(init, cond, step_noise=step_noise)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_launches(launches, {"gn_stats": 67 * 11, "gn_apply": 67 * 11,
                              "attention_fwd": 10 * 11}, "slice")
    with ops.reference_ops():
        want = block(init, cond, step_noise=step_noise)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and got.shape == (B, sz, sz, 5),
          f"slice output {tuple(got.shape)} not finite")
    check(diff <= SLICE_ATOL, f"slice kernels vs plain max abs diff {diff} > {SLICE_ATOL}")
    emit("slice", card=card, B=B, steps=10, denoise=True, dtype="float32", params=n_params,
         eps_std=eps_std, max_abs_diff=diff, atol=SLICE_ATOL,
         out_range=[float(got.min()), float(got.max())], launches=launches)


def phase_headline(card):
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.config import flagship_config
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.eval import autoregressive_predict, make_block_sampler
    from mcvd_tpu_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = flagship_config()
    config.sampling.compute_dtype = "bfloat16"
    B, n_pred = 16, 16
    config.sampling.subsample = 100
    config.sampling.num_frames_pred = n_pred
    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
    sched = make_schedule(config)
    block = make_block_sampler(config, model, sched)
    sz, F = config.data.image_size, config.data.num_frames
    n_blocks = ceil(n_pred / F)
    evals = n_blocks * (config.sampling.subsample + 1)
    g = torch.Generator(device="cuda").manual_seed(3)
    cond = torch.randn(B, sz, sz, config.data.num_frames_cond, generator=g, device="cuda")

    def request():
        ops.reset_launches()
        t0 = time.perf_counter()
        out = autoregressive_predict(config, block, cond, None, n_pred, 0, sched, generator=g)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(ops.LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    _, warm_s, _ = request()
    want = {"gn_stats": 67 * evals, "gn_apply": 67 * evals, "attention_fwd": 10 * evals}
    times, launches = [], None
    for _ in range(3):
        out, dt, launches = request()
        check_launches(launches, want, "request")
        check(out.shape == (B, sz, sz, n_pred) and bool(torch.isfinite(out).all()),
              f"headline output {tuple(out.shape)} not finite")
        times.append(dt)
    fps = B * n_pred / statistics.mean(times)
    emit("headline", card=card, B=B, steps=config.sampling.subsample, denoise=True,
         frames_pred=n_pred, blocks=n_blocks, evals_per_request=evals, dtype="bfloat16",
         warmup_s=warm_s, request_s=times, frames_per_s=fps,
         ms_per_eval=1000 * statistics.mean(times) / evals,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import mcvd_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase_env()
    phase_build()
    cases, summary = phase_kernels(card)
    timing, tool_launches = phase_profile_gn2(card, summary)
    phase_slice(card)
    launches = phase_headline(card)
    check("jax" not in sys.modules, "jax was imported")

    # times of the GroupNorm and attention kernels at the heaviest main-path
    # shape, in the headline's bf16
    gn_big = next(c for c in cases if c["op"] == "group_norm" and c["dtype"] == "bfloat16"
                  and (c["C"], c["H"], c["form"]) == (192, 64, "adagn_silu"))
    attn_big = next(c for c in cases if c["op"] == "attention" and c["dtype"] == "bfloat16"
                    and c["T"] == 1024)
    timing["gn_stats"] = dict(ms=gn_big["gn_stats_ms"], plain_ms=gn_big["gn_stats_plain_ms"],
                              library_ms=None,   # no one call gives per-group sums
                              bound=gn_big["gn_stats_bound"])
    timing["gn_apply"] = dict(ms=gn_big["gn_apply_ms"], plain_ms=gn_big["gn_apply_plain_ms"],
                              library_ms=None,   # no one call does x*A + B then SiLU
                              bound=gn_big["gn_apply_bound"])
    timing["attention_fwd"] = dict(ms=attn_big["ms"], plain_ms=attn_big["plain_ms"],
                                   library_ms=attn_big["library_ms"],
                                   bound=(attn_big["bound_ms"], attn_big["bound_by"]))
    where = {   # name: (route, source, the TPU kernel it replaces, launches)
        "gn_stats": ("triton", "mcvd_tpu_torch/ops/groupnorm.py",
                     "mcvd_tpu/ops/lab/groupnorm.py:283", launches),
        "gn_apply": ("triton", "mcvd_tpu_torch/ops/groupnorm.py",
                     "mcvd_tpu/ops/lab/groupnorm.py:324", launches),
        "attention_fwd": ("cuda", "mcvd_tpu_torch/csrc/attention.cu",
                          "mcvd_tpu/ops/lab/attention.py:60", launches),
        "fused_leaky_relu": ("triton", "mcvd_tpu_torch/ops/fused_act.py",
                             "mcvd_tpu/ops/fused_act.py:46", tool_launches),
        "gn_copy": ("cuda", "mcvd_tpu_torch/csrc/profile_gn2.cu",
                    "tools/profile_gn2.py:65", tool_launches),
        "gn_variant": ("cuda", "mcvd_tpu_torch/csrc/profile_gn2.cu",
                       "tools/profile_gn2.py:145", tool_launches),
    }
    kernels = []
    for name, (route, source, replaces, counts) in where.items():
        t = timing[name]
        check(counts[name] > 0, f"{name} was not launched on its path")
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=counts[name], ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound"][0], bound_by=t["bound"][1],
                            library_ms=t["library_ms"], **summary[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
