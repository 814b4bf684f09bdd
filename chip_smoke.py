#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA toolkit) and triton; builds the port's
kernels from `mcvd_tpu_torch/csrc` and `mcvd_tpu_torch/ops` at first use.
Imports torch, numpy and `mcvd_tpu_torch` only (no jax). Phases, one JSON
line each:

  1. env       torch/CUDA versions and the card's name and power limit;
  2. build     the nvcc build (with ptxas' registers and spills per kernel)
               and the first Triton compile, in seconds;
  3. kernels   each kernel against its plain PyTorch version, fp32 (TF32
               off) and bf16: the GroupNorm `gn_fused` at every shape and
               form of one flagship evaluation (read from the model by
               `tools.gn_calls`), with its plan (cluster, blocks, rows,
               threads, shared memory, clusters resident at once);
               attention at the main path's T and a ragged T, and at the
               head dims 96 and 128 of the shipped configs with wider heads
               (`WIDE_ATTN_CASES`) (bf16 on mma.sync m16n8k16, fp32 as
               3xTF32 on m16n8k8), the bf16
               route held per element to the bound of rounding p to bf16
               and, tighter, to a plain emulation of its own arithmetic
               (`ops.attention.bf16_tolerances`). Max abs error, median
               device ms of
               kernel and plain version, host us of enqueue per GroupNorm
               call, and the one PyTorch call that computes the same
               function where there is one (`F.group_norm` for the affine
               GroupNorm, `F.scaled_dot_product_attention`), timed for
               comparison only; the GroupNorm totals of one evaluation;
  4. profile_gn2  the GroupNorm microbenchmark's kernels (`gn_copy`,
               `gn_variant`) and `fused_leaky_relu` against their plain
               versions at the tool's shapes, `gn_variant` against the port's
               GroupNorm; then the tool's own run
               (`mcvd_tpu_torch.tools.profile_gn2.measure`) and the
               `fused_leaky_relu` op at a main-path activation, with their
               launch counts: device ms and host us per call of each line;
  5. slice     one flagship block (ngf=64, 10 steps + denoise, B=4, fp32)
               through the kernels and under `ops.reference_ops()`, same
               weights (passed to the sampler per call) and draws; the
               parameter count;
  6. headline  the bench protocol: B=16, 100-step DDPM + denoise, 16 frames
               of 64x64 predicted in 4 blocks of 5 on 5 cond frames, bf16
               score network; one warm-up, 3 timed requests, frames/s, and
               the launch counts of each request;
  7. train_kernels  the backward kernels against the plain backward passes,
               fp32 (TF32 off) and bf16 at B=16: `gn_fused_bwd` at every
               GroupNorm shape and form of one flagship evaluation (and
               frames_last=2), through autograd with the inputs' and
               parameters' gradients, at C=192 64x64 also with L2 flushed
               before each call (`cold_ms`); `attention_bwd` at every
               attention case of phase 3, bf16 also per element within
               `ops.attention.bf16_bwd_tolerances` of the plain backward
               and, tighter, of `attention_bwd_tc_emulation` on the
               kernel's own forward, and both dtypes bit-identical over two
               calls. Max abs error, device ms of the
               kernel alone (from the forward's saved statistics or
               logsumexp) and of the plain backward, the bound, and the
               one PyTorch call for comparison (autograd of `F.group_norm`
               for the affine form, SDPA's backward), launches per call;
  8. train_slice  one flagship training step (B=4, fp32, TF32 off, dropout 0,
               warmup 0) through the kernels and under `ops.reference_ops()`
               from the same weights and draws: loss, grad_norm, every
               gradient (through Adam's first moment), the updated
               parameters and the EMA, and exact launch counts (67 GroupNorm
               and 10 attention calls, forward and backward);
  9. wide_heads  bair_big (D=96, 64 px) and cityscapes_big (D=128, 128 px)
               at full width, random weights from a seed (zero-scale layers
               redrawn): one fp32 network evaluation (B=4) and one fp32
               training step (B=4) through the kernels against
               `ops.reference_ops()` at train_slice's tolerances, with
               exact launch counts (the model's GroupNorm and attention
               calls) and the JAX init's parameter count;
 10. train_headline  the yml's training config at full width, B=64, fp32 and
               then bf16 compute: one warm-up step, 5 timed steps, ms per
               step, clips/s, peak memory and the launch counts per step.

Then the per-kernel summary line of the seven kernels (with each kernel's
bound: the larger of its bytes over the HBM rate and its operations over the
peak rate for its type; for fp32 attention the smaller of that on the CUDA
cores and of three TF32 products per product, the route the kernels take),
the card line, and last {"ok": true, "device":
{...}}. Any failed check raises: the exit code is nonzero and the last line
is not printed.
"""

import json
import statistics
import sys
import time
from math import ceil

import numpy as np
import torch
import torch.nn.functional as F

FLAGSHIP_PARAM_COUNT = 27_941_765   # jax.eval_shape of the JAX flagship init
ATTN_SHAPES = [(1024, 2), (256, 3), (64, 4)]             # (T, heads), D=64, B=16
# (T, heads, head dim) of the attention in the shipped configs with wider
# heads, at 32, 16 and 8 px: bair_big and kth64_big (D=96, 2/3/4 heads),
# ucf101 (D=96, 4/6/8 heads), cityscapes_big (D=128, 2/3/4 heads).
WIDE_ATTN_CASES = [(1024, 2, 96), (256, 3, 96), (64, 4, 96), (1024, 4, 96), (256, 6, 96),
                   (64, 8, 96), (1024, 2, 128), (256, 3, 128), (64, 4, 128)]
# Every attention case: the main path's, a ragged T, and the wider heads.
ATTN_CASES = [(T, h, 64) for T, h in ATTN_SHAPES] + [(100, 2, 64)] + WIDE_ATTN_CASES
# The full-width configs with wider heads (`wide_heads` phase): name ->
# (head dim, parameter count of jax.eval_shape of the JAX init).
WIDE_CONFIGS = {"bair_big": (96, 62_844_975), "cityscapes_big": (128, 116_551_695)}
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
# the CUDA cores and of bf16 and TF32 on the tensor cores (the HBM3 rate is
# the tool's, `profile_gn2.HBM_BYTES_PER_S`).
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12}
# The attention kernels' routes, by dtype.
ATTN_PATH = {"bfloat16": "mma.sync m16n8k16 bf16", "float32": "mma.sync m16n8k8 3xTF32"}
# The flagship block, fp32: 11 evaluations of the 27.9M-parameter network
# whose sums run in another order; the first steps divide eps by
# sqrt(alpha) ~ 0.0067 before the x0 clip.
SLICE_ATOL = 5e-3
# The training phases: each kernel once per GroupNorm and attention call of
# one step, forward and backward.
TRAIN_LAUNCHES = {"gn_fused": 67, "gn_fused_bwd": 67, "attention_fwd": 10, "attention_bwd": 10}
# attention_bwd against the plain backward, per d(q), d(k), d(v): the max
# error over the largest entry. fp32: summation order. bf16: one rounding of
# each gradient (2^-8 of its size) and the row term D = rowsum(dO * O) taken
# from the forward's output, whose p the tensor cores rounded to bf16 (2^-8
# relative): together within 2^-6.
ATTN_BWD_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# The fp32 training step, kernels against plain (same weights and draws):
# loss and grad_norm rtol 1e-4; gradients (mu = 0.1 g after the first step)
# 1e-3 of each tensor's largest entry, floored at 1e-6 of the model's
# largest gradient (the rounding noise of an exactly-zero gradient such as
# the key bias's); parameters after the Adam step 0.1*lr where |mu| >= 1e-2
# of its tensor's largest (the update's error is ~lr * error(mu) / |mu|),
# else 2*lr, the update's own bound; EMA 1e-3 of that plus 1e-6.
TRAIN_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-3


def emit(phase, **payload):
    print(json.dumps({"phase": phase, **payload}), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def bound(nbytes, flops, peak):
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once."""
    from mcvd_tpu_torch.tools.profile_gn2 import HBM_BYTES_PER_S

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_bound(nb, flops, dtype_name):
    """`bound` of an attention kernel: bf16 on the tensor cores; fp32 the
    smaller of the CUDA cores' fp32 rate and 3xTF32 (three TF32 products for
    each fp32 product), the route the fp32 kernels take."""
    if dtype_name == "bfloat16":
        return bound(nb, flops, "bf16")
    return min(bound(nb, flops, "fp32"), bound(nb, 3 * flops, "tf32"))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_launches(launches, want, what):
    """The phase launched exactly `want` of its kernels and none of the rest."""
    full = {k: want.get(k, 0) for k in launches}
    check(launches == full, f"{what} launch counts {launches}, want {full}")


def max_err(got, want, dtype_name, tol=None):
    """(max abs error, within tolerance): |got - want| <= atol + rtol*|want|
    everywhere; atol may be a tensor of want's shape (a bound per element)."""
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


def ptxas_summary(log):
    """Registers, shared memory and spills of each compiled kernel, from
    nvcc's -Xptxas -v output."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = {"entry": line.split("'")[1]}
            out.append(cur)
        elif cur is not None and "spill" in line:
            cur["spill"] = line.strip()
        elif cur is not None and "Used" in line:
            cur["used"] = line.split(":", 1)[1].strip()
    return out


def phase_build():
    from mcvd_tpu_torch.ops import _build
    from mcvd_tpu_torch.ops import fused_act as FA

    t0 = time.perf_counter()
    _build.load_library()
    nvcc_s = time.perf_counter() - t0
    x = torch.randn(2, 8, 8, 64, device="cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        FA.fused_leaky_relu(x, None)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    emit("build", nvcc_s=nvcc_s, nvcc_compile_s=_build.BUILD_SECONDS[0],
         triton_first_compile_s=triton_s, ptxas=ptxas_summary(_build.BUILD_LOG[0]))


def host_us(fn, n=100, reps=3):
    """Median host time of enqueueing one fn() call, in us (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def phase_kernels(card):
    from collections import Counter

    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.tools.profile_gn2 import device_ms
    from mcvd_tpu_torch.ops import attention as A
    from mcvd_tpu_torch.ops import groupnorm as GN
    from mcvd_tpu_torch.tools.gn_calls import form, group_norm_calls

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    B = 16
    cases = []
    summary = {k: {"max_abs_err": 0.0, "max_abs_err_fp32": 0.0} for k in ops.LAUNCHES}

    # every GroupNorm shape and form of one flagship evaluation, read from the
    # model; plus frames_last=2
    calls = group_norm_calls(batch=B)
    check(len(calls) == 67, f"{len(calls)} GroupNorm calls per evaluation, want 67")
    per_eval = Counter((c["C"], c["H"], form(c)) for c in calls)
    groups = {(c["C"], c["H"], form(c)): c["num_groups"] for c in calls}
    gn_cases = [(C, H, 1, f, groups[C, H, f]) for C, H, f in sorted(per_eval)]
    gn_cases.append((64, 32, 2, "adagn_silu", 16))   # frames_last=2: C*N = 128
    gn_eval = {"ms": 0.0, "plain_ms": 0.0, "host_us": 0.0, "plain_host_us": 0.0}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for C, H, N, fm, G in gn_cases:
                eps, affine, adagn, act = GN_FORMS[fm]
                CN = C * N
                x = (torch.randn(B, H, H, CN, generator=g, device=dev) * 2 + 0.5).to(dtype)
                x = x.permute(0, 3, 1, 2)   # channels_last NCHW
                kw = dict(eps=eps, frames_last=N, act=act)
                if affine:
                    kw["gamma"] = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
                    kw["beta"] = 0.1 * torch.randn(C, generator=g, device=dev)
                if adagn:   # as ActNorm passes them: chunks of one (B, 2*C*N) tensor
                    ss = (0.1 * torch.randn(B, 2 * CN, generator=g, device=dev)).to(dtype)
                    kw["scale"], kw["shift"] = ss.chunk(2, dim=1)
                p = GN.plan(CN, H, H, dtype, G)
                before = ops.LAUNCHES["gn_fused"]
                got = GN.group_norm(x, G, **kw)
                check(ops.LAUNCHES["gn_fused"] == before + 1, "group_norm launched no gn_fused")
                with ops.reference_ops():
                    want = GN.group_norm(x, G, **kw)
                err, ok = max_err(got, want, dn)
                check(ok, f"group_norm {fm} C={C} H={H} N={N} {dn}: max err {err}")
                record(summary, "gn_fused", dn, err)
                case = dict(op="group_norm", form=fm, B=B, C=C, H=H, frames_last=N, dtype=dn,
                            max_abs_err=err, cluster=p.cluster,
                            blocks=p.cluster * B, rows_per_block=p.rows, threads=p.threads,
                            smem=p.smem, max_active_clusters=GN.max_active_clusters(x, p, G),
                            calls_per_eval=per_eval.get((C, H, fm), 0) if N == 1 else 0)
                case["ms"] = device_ms(lambda: GN.group_norm(x, G, **kw))
                if dn == "bfloat16" or (C, H) == (192, 64):
                    case["host_us"] = host_us(lambda: GN.group_norm(x, G, **kw))
                    with ops.reference_ops():
                        case["plain_ms"] = device_ms(lambda: GN.group_norm(x, G, **kw))
                        case["plain_host_us"] = host_us(lambda: GN.group_norm(x, G, **kw))
                    case["bound_ms"], case["bound_by"] = bound(
                        2 * nbytes(x), 8 * x.numel(), "fp32")
                    case["library_ms"] = None   # no one PyTorch call does AdaGN or the SiLU
                    if fm == "affine":   # one PyTorch call computes it, for comparison
                        w, b = kw["gamma"].to(dtype), kw["beta"].to(dtype)
                        case["library_ms"] = device_ms(lambda: F.group_norm(x, G, w, b, eps))
                    if dn == "bfloat16" and N == 1:
                        for k in gn_eval:
                            gn_eval[k] += case["calls_per_eval"] * case[k]
                cases.append(case)

    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for T, h, d in ATTN_CASES:
                scale = d ** -0.5
                qkv = torch.randn(B, T, 3 * h * d, generator=g, device=dev).to(dtype)
                got = A.attention_packed(qkv, h, scale)
                with ops.reference_ops():
                    want = A.attention_packed(qkv, h, scale)
                tols = (A.bf16_tolerances(qkv, h, scale) if dn == "bfloat16"
                        else {"plain": TOL[dn]})
                tol = tols["plain"]
                err, ok = max_err(got, want, dn, tol)
                check(ok, f"attention T={T} h={h} D={d} {dn}: max err {err}")
                record(summary, "attention_fwd", dn, err)
                # (B*h, T, d) views of q, k, v, made before timing
                q, k, v = (t.reshape(B, T, h, d).transpose(1, 2).reshape(B * h, T, d)
                           .contiguous() for t in qkv.split(h * d, dim=-1))
                case = dict(op="attention", B=B, T=T, heads=h, head_dim=d, dtype=dn,
                            path=ATTN_PATH[dn],
                            max_abs_err=err, max_atol=float(torch.as_tensor(tol[0]).max()),
                            rtol=tol[1])
                if dn == "bfloat16":   # the kernel's own arithmetic in plain torch
                    emu = A.attention_tc_emulation(q, k, v, scale)
                    emu = emu.reshape(B, h, T, d).transpose(1, 2).reshape(B, T, h * d)
                    e_err, e_ok = max_err(got, emu, dn, tols["emulation"])
                    check(e_ok, f"attention T={T} h={h} D={d} bf16 vs its emulation: "
                                f"max err {e_err}")
                    case.update(emulation_err=e_err,
                                emulation_max_atol=float(tols["emulation"][0].max()),
                                emulation_rtol=tols["emulation"][1])
                if T != 100:   # every case but the ragged T is timed
                    case["ms"] = device_ms(lambda: A.attention_packed(qkv, h, scale))
                    case["plain_ms"] = device_ms(
                        lambda: A.attention_packed_reference(qkv, h, scale))
                    # the one PyTorch call, on (B, h, T, D)
                    q4, k4, v4 = (t.view(B, h, T, d) for t in (q, k, v))
                    case["library_ms"] = device_ms(
                        lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
                    flops = 4 * B * h * T * T * d
                    case["bound_ms"], case["bound_by"] = attn_bound(
                        nbytes(qkv) * 4 // 3, flops, dn)
                    case["tflops"] = flops / case["ms"] / 1e9
                cases.append(case)
    torch.cuda.synchronize()
    emit("kernels", card=card, cases=cases, gn_per_eval_bf16=gn_eval)
    return cases, summary


def phase_profile_gn2(card, summary):
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.tools.profile_gn2 import device_ms
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
    for k in ("gn_copy", "gn_variant", "fused_leaky_relu", "gn_fused"):
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
    params = dict(model.named_parameters())
    ops.reset_launches()
    got = block(params, init, cond, step_noise=step_noise)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_launches(launches, {"gn_fused": 67 * 11, "attention_fwd": 10 * 11}, "slice")
    with ops.reference_ops():
        want = block(params, init, cond, step_noise=step_noise)
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
    params = dict(model.named_parameters())
    sz, F = config.data.image_size, config.data.num_frames
    n_blocks = ceil(n_pred / F)
    evals = n_blocks * (config.sampling.subsample + 1)
    g = torch.Generator(device="cuda").manual_seed(3)
    cond = torch.randn(B, sz, sz, config.data.num_frames_cond, generator=g, device="cuda")

    def request():
        ops.reset_launches()
        t0 = time.perf_counter()
        out = autoregressive_predict(config, block, params, cond, None, n_pred, 0, sched,
                                     generator=g)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(ops.LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    _, warm_s, _ = request()
    want = {"gn_fused": 67 * evals, "attention_fwd": 10 * evals}
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


def grad_err(got, want, dtype_name):
    """(max abs error, within tolerance) of a gradient against the plain
    backward's: fp32 1e-4 of the larger of 1 and its largest entry (the sums
    run in another order, over up to B*H*W terms); bf16 that plus two bf16
    steps per element (both round one fp32 value)."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "non-finite gradient")
    diff = (got - want).abs()
    atol = 1e-4 * max(1.0, float(want.abs().max()))
    rtol = 0.0 if dtype_name == "float32" else 1.6e-2
    return float(diff.max()), bool((diff <= atol + rtol * want.abs()).all())


def phase_train_kernels(card, summary):
    from collections import Counter

    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.ops import attention as A
    from mcvd_tpu_torch.ops import groupnorm as GN
    from mcvd_tpu_torch.tools.gn_calls import form, group_norm_calls
    from mcvd_tpu_torch.tools.profile_gn2 import device_ms
    from mcvd_tpu_torch.tools.profile_gn_bwd import cold_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    dev, B = "cuda", 16
    cases = []
    calls = group_norm_calls(batch=B)
    per_eval = Counter((c["C"], c["H"], form(c)) for c in calls)
    groups = {(c["C"], c["H"], form(c)): c["num_groups"] for c in calls}
    gn_cases = [(C, H, 1, f, groups[C, H, f]) for C, H, f in sorted(per_eval)]
    gn_cases.append((64, 32, 2, "adagn_silu", 16))   # frames_last=2: C*N = 128
    gn_step = {"float32": 0.0, "bfloat16": 0.0}      # device ms of the 67 backwards
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for C, H, N, fm, G in gn_cases:
            eps, affine, adagn, act = GN_FORMS[fm]
            CN = C * N
            x = (torch.randn(B, H, H, CN, generator=g, device=dev) * 2 + 0.5).to(dtype)
            x = x.permute(0, 3, 1, 2)   # channels_last NCHW
            dy = torch.randn(B, H, H, CN, generator=g, device=dev).to(dtype).permute(0, 3, 1, 2)
            prm = {"gamma": None, "beta": None, "scale": None, "shift": None}
            if affine:   # in the compute dtype, as the bf16 step casts the parameters
                prm["gamma"] = (1 + 0.1 * torch.randn(C, generator=g, device=dev)).to(dtype)
                prm["beta"] = (0.1 * torch.randn(C, generator=g, device=dev)).to(dtype)
                leaves = [x, prm["gamma"], prm["beta"]]
            if adagn:   # as ActNorm passes them: chunks of one (B, 2*C*N) tensor
                ss = (0.1 * torch.randn(B, 2 * CN, generator=g, device=dev)).to(dtype)
                leaves = [x, ss]
            for t in leaves:
                t.requires_grad_()
            if adagn:
                prm["scale"], prm["shift"] = ss.chunk(2, dim=1)
            kw = dict(eps=eps, frames_last=N, act=act, **prm)
            before = dict(ops.LAUNCHES)
            got = torch.autograd.grad(GN.group_norm(x, G, **kw), leaves, dy)
            check(ops.LAUNCHES["gn_fused"] == before["gn_fused"] + 1 and
                  ops.LAUNCHES["gn_fused_bwd"] == before["gn_fused_bwd"] + 1,
                  "group_norm's backward did not run gn_fused then gn_fused_bwd")
            with ops.reference_ops():
                want = torch.autograd.grad(GN.group_norm(x, G, **kw), leaves, dy)
            err = 0.0
            for i, (a, b) in enumerate(zip(got, want)):
                e, ok = grad_err(a, b, dn)
                check(ok, f"gn_fused_bwd {fm} C={C} H={H} N={N} {dn} input {i}: max err {e}")
                err = max(err, e)
            # the backward alone, from the forward's saved statistics
            xd = x.detach()
            pd = {k: None if v is None else v.detach() for k, v in prm.items()}
            _, stats = GN.group_norm_fwd(xd, G, eps, pd["gamma"], pd["beta"], pd["scale"],
                                         pd["shift"], N, act, want_stats=True)
            args = (xd, dy, stats, G, pd["gamma"], pd["beta"], pd["scale"], pd["shift"], N, act)
            # both routes (cluster, split) and the plan bwd_plan picks: the
            # plain backward's gradients, the same bits over two calls
            picked = GN.bwd_plan(B, CN, H, H, dtype, G, N, affine)
            for p in {picked, *GN.bwd_plans(B, CN, H, H, dtype, G, N)}:
                route = "split" if p.split else "cluster"
                once = GN.group_norm_bwd(*args, p=p)
                check(all(torch.equal(a, b) for a, b in
                          zip(once, GN.group_norm_bwd(*args, p=p)) if a is not None),
                      f"gn_fused_bwd {route} {fm} C={C} H={H} N={N} {dn}: two calls differ")
                mine = [once[0]] + ([torch.cat(once[3:], dim=1)] if adagn else list(once[1:3]))
                for i, (a, b) in enumerate(zip(mine, want)):
                    e, ok = grad_err(a, b, dn)
                    check(ok, f"gn_fused_bwd {route} {fm} C={C} H={H} N={N} {dn} input {i}: "
                              f"max err {e}")
                    err = max(err, e)
            record(summary, "gn_fused_bwd", dn, err)
            case = dict(op="group_norm_bwd", form=fm, B=B, C=C, H=H, frames_last=N, dtype=dn,
                        max_abs_err=err, route="split" if picked.split else "cluster",
                        launches_per_call=2 if picked.split or affine else 1,
                        calls_per_step=per_eval.get((C, H, fm), 0) if N == 1 else 0)
            case["ms"] = device_ms(lambda: GN.group_norm_bwd(*args))
            gn_step[dn] += case["calls_per_step"] * case["ms"]
            if (C, H) == (192, 64):   # and with L2 flushed before each call
                case["cold_ms"] = cold_ms(lambda: GN.group_norm_bwd(*args))
            if dn == "bfloat16" or (C, H) == (192, 64):
                case["plain_ms"] = device_ms(lambda: GN.group_norm_bwd_reference(
                    xd, dy, G, eps=eps, frames_last=N, act=act, **pd))
                case["bound_ms"], case["bound_by"] = bound(3 * nbytes(x), 12 * x.numel(),
                                                           "fp32")
                case["library_ms"] = None   # no one PyTorch call does AdaGN or the SiLU
                if fm == "affine":   # autograd of F.group_norm, for comparison
                    xl = xd.clone().requires_grad_()
                    wl, bl = (pd[k].clone().requires_grad_() for k in ("gamma", "beta"))
                    yl = F.group_norm(xl, G, wl, bl, eps)
                    case["library_ms"] = device_ms(lambda: torch.autograd.grad(
                        yl, [xl, wl, bl], dy, retain_graph=True))
            cases.append(case)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for T, h, d in ATTN_CASES:
            C, scale = h * d, d ** -0.5
            qkv = torch.randn(B, T, 3 * C, generator=g, device=dev).to(dtype).requires_grad_()
            dy = torch.randn(B, T, C, generator=g, device=dev).to(dtype)
            before = dict(ops.LAUNCHES)
            got, = torch.autograd.grad(A.attention_packed(qkv, h, scale), [qkv], dy)
            check(ops.LAUNCHES["attention_fwd"] == before["attention_fwd"] + 1 and
                  ops.LAUNCHES["attention_bwd"] == before["attention_bwd"] + 1,
                  "attention_packed's backward did not run attention_bwd")
            with ops.reference_ops():
                want, = torch.autograd.grad(A.attention_packed(qkv, h, scale), [qkv], dy)
            rel = ATTN_BWD_REL[dn]
            err = 0.0
            for i, part in enumerate("qkv"):
                a, b = (t[..., i * C:(i + 1) * C].float() for t in (got, want))
                check(bool(torch.isfinite(a).all()), "non-finite attention gradient")
                e = float((a - b).abs().max())
                check(e <= rel * float(b.abs().max()),
                      f"attention_bwd T={T} h={h} D={d} {dn} d{part}: max err {e}")
                err = max(err, e)
            record(summary, "attention_bwd", dn, err)
            case = dict(op="attention_bwd", B=B, T=T, heads=h, head_dim=d, dtype=dn,
                        path=ATTN_PATH[dn] + " (dq, then dk and dv)",
                        max_abs_err=err, rel_tol=rel, launches_per_call=2)
            # the kernel alone, from the forward's output and logsumexp: the
            # same bits twice (no atomics); bf16 per element
            qd = qkv.detach()
            o, lse = A.attention_packed_fwd(qd, h, scale, True)
            once = A.attention_packed_bwd(qd, o, lse, dy, h, scale)
            check(torch.equal(once, A.attention_packed_bwd(qd, o, lse, dy, h, scale)),
                  f"attention_bwd T={T} h={h} D={d} {dn}: two calls differ")
            case["deterministic"] = True
            if dn == "bfloat16":
                tols = A.bf16_bwd_tolerances(qd, dy, h, scale)
                p_err, p_ok = max_err(once, want, dn, tols["plain"])
                check(p_ok, f"attention_bwd T={T} h={h} D={d} bf16 per element: "
                            f"max err {p_err}")
                heads = [t.reshape(B, T, h, d).transpose(1, 2).reshape(B * h, T, d)
                         for t in (*qd.split(C, dim=-1), dy, o)]
                emu = A.attention_bwd_tc_emulation(*heads[:4], scale, o=heads[4],
                                                   lse=lse.reshape(B * h, T))
                emu = torch.cat([t.reshape(B, h, T, d).transpose(1, 2).reshape(B, T, C)
                                 for t in emu], dim=-1)
                e_err, e_ok = max_err(once, emu, dn, tols["emulation"])
                check(e_ok, f"attention_bwd T={T} h={h} D={d} bf16 vs its emulation: "
                            f"max err {e_err}")
                case.update(per_element_err=p_err, max_atol=float(tols["plain"][0].max()),
                            emulation_err=e_err,
                            emulation_max_atol=float(tols["emulation"][0].max()))
            if T != 100:   # every case but the ragged T is timed
                case["ms"] = device_ms(lambda: A.attention_packed_bwd(qd, o, lse, dy, h, scale))
                case["plain_ms"] = device_ms(
                    lambda: A.attention_packed_bwd_reference(qd, dy, h, scale))
                q4, k4, v4 = (t.reshape(B, T, h, d).transpose(1, 2).contiguous()
                              .requires_grad_() for t in qd.split(C, dim=-1))
                o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                dy4 = dy.reshape(B, T, h, d).transpose(1, 2)
                case["library_ms"] = device_ms(lambda: torch.autograd.grad(
                    o4, [q4, k4, v4], dy4, retain_graph=True))
                flops = 10 * B * h * T * T * d   # 5 products of 2*T*T*d per (b, head)
                case["bound_ms"], case["bound_by"] = attn_bound(
                    2 * nbytes(qd) + 2 * nbytes(o) + nbytes(lse), flops, dn)
                case["tflops"] = flops / case["ms"] / 1e9
            cases.append(case)
    torch.cuda.synchronize()
    emit("train_kernels", card=card, cases=cases, gn_bwd_ms_per_step_at_B16=gn_step)
    return cases


def _slice_model(config, seed):
    """The flagship with its zero-scale layers redrawn at scale 1 (else the
    network's output and most gradients are ~0 and hide the kernels)."""
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.models.layers import init_weights

    model = get_model(config, generator=torch.Generator().manual_seed(seed), device="cuda")
    for m in model.modules():
        if getattr(m, "init_scale", None) == 0.0:
            m.init_scale = 1.0
    init_weights(model, torch.Generator().manual_seed(seed + 1))
    return model


def train_step_vs_plain(config, seed, B, want_launches, what):
    """One fp32 training step of `config`'s model (zero-scale layers redrawn,
    dropout 0, warmup 0) through the kernels and under `ops.reference_ops()`
    from the same weights and draws: loss, grad_norm, every gradient
    (through Adam's first moment), the updated parameters and the EMA held
    to the train tolerances, and the kernels' exact launch counts. Returns
    the phase's payload."""
    import contextlib

    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.model.dropout = 0.0
    config.optim.warmup = 0   # with warmup the first update is exactly zero
    lr = config.optim.lr
    model = _slice_model(config, seed)
    n_params = sum(p.numel() for p in model.parameters())
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    sched = make_schedule(config)
    d = config.data
    sz = d.image_size
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    X = torch.rand(B, d.num_frames_cond + d.num_frames, sz, sz, d.channels, generator=g,
                   device="cuda")
    draws = {"labels": torch.randint(0, len(sched.alphas), (B,), generator=g, device="cuda"),
             "z": torch.randn(B, sz, sz, d.channels * d.num_frames, generator=g,
                              device="cuda").permute(0, 3, 1, 2)}

    def run(reference):
        model.load_state_dict(weights)
        state = create_train_state(config, model, device="cuda")
        step = make_train_step(model, sched, config)
        torch.cuda.synchronize()
        ops.reset_launches()
        with ops.reference_ops() if reference else contextlib.nullcontext():
            state, m = step(state, X, draws=draws)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        snap = {k: {n: t.detach().clone() for n, t in d.items()} for k, d in
                (("params", state.params), ("ema", state.ema_params),
                 ("mu", state.opt_state["mu"]), ("nu", state.opt_state["nu"]))}
        return snap, {k: float(v) for k, v in m.items()}, launches

    got, mk, launches = run(False)
    check_launches(launches, want_launches, f"{what} step")
    want, mr, ref_launches = run(True)
    check_launches(ref_launches, {}, f"{what} step under reference_ops")
    for k in ("loss", "grad_norm"):
        check(abs(mk[k] - mr[k]) <= TRAIN_RTOL * abs(mr[k]),
              f"{what} {k}: kernels {mk[k]}, plain {mr[k]}")
    # gradients: mu after the first step is 0.1 * the clipped gradient
    gmax = max(float(t.abs().max()) for t in want["mu"].values()) / 0.1
    worst = {"grad": 0.0, "nu": 0.0, "param_over_tol": 0.0, "ema": 0.0}
    for n in want["params"]:
        for slot, rel, floor in (("mu", TRAIN_GRAD_REL, 0.1 * 1e-6 * gmax),
                                 ("nu", 2 * TRAIN_GRAD_REL, 1e-3 * (1e-6 * gmax) ** 2)):
            a, b = got[slot][n], want[slot][n]
            e = float((a - b).abs().max()) / max(float(b.abs().max()), floor)
            check(e <= rel, f"{what} {slot} {n}: error {e} of its largest entry")
            worst["grad" if slot == "mu" else "nu"] = max(worst["grad" if slot == "mu"
                                                                else "nu"], e)
        mu = want["mu"][n]
        atol = torch.where(mu.abs() < 1e-2 * float(mu.abs().max()), 2 * lr, 0.1 * lr)
        e = float(((got["params"][n] - want["params"][n]).abs() / atol).max())
        check(e <= 1.0, f"{what} param {n}: {e} of its tolerance")
        ema_e = float(((got["ema"][n] - want["ema"][n]).abs() / (1e-3 * atol + 1e-6)).max())
        check(ema_e <= 1.0, f"{what} ema {n}: {ema_e} of its tolerance")
        worst["param_over_tol"] = max(worst["param_over_tol"], e)
        worst["ema"] = max(worst["ema"], ema_e)
    return dict(B=B, dtype="float32", params=n_params, lr=lr, kernels=mk, plain=mr,
                loss_rtol=TRAIN_RTOL, grad_rel=TRAIN_GRAD_REL, worst=worst, launches=launches)


def phase_train_slice(card):
    from mcvd_tpu_torch.config import flagship_config

    out = train_step_vs_plain(flagship_config(), 10, 4, TRAIN_LAUNCHES, "train_slice")
    check(out["params"] == FLAGSHIP_PARAM_COUNT,
          f"{out['params']} params, JAX has {FLAGSHIP_PARAM_COUNT}")
    emit("train_slice", card=card, **out)


def phase_wide_heads(card):
    """bair_big (D=96, 64 px) and cityscapes_big (D=128, 128 px) at full
    width, random weights from a seed: one fp32 network evaluation and one
    fp32 training step (B=4) through the kernels against `reference_ops()`,
    with exact launch counts (the model's GroupNorm and attention calls)."""
    from mcvd_tpu_torch import config as port_config
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.models.blocks import AttnBlock
    from mcvd_tpu_torch.tools.gn_calls import group_norm_calls

    launches = {}
    for name, (head_dim, n_jax) in WIDE_CONFIGS.items():
        config = getattr(port_config, f"{name}_config")()
        B = 4
        n_gn = len(group_norm_calls(config, batch=B))
        model = _slice_model(config, 20)
        attn = [m for m in model.modules() if isinstance(m, AttnBlock)]
        n_attn = len(attn)
        dims = {m.NIN_0.W.shape[0] // m.n_heads for m in attn}
        check(dims == {head_dim}, f"{name}: attention head dims {dims}, want {head_dim}")
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == n_jax, f"{name}: {n_params} params, JAX has {n_jax}")
        d = config.data
        sz = d.image_size
        g = torch.Generator(device="cuda").manual_seed(21)
        x = torch.randn(B, sz, sz, d.channels * d.num_frames, generator=g, device="cuda")
        cond = torch.rand(B, sz, sz, d.channels * d.num_frames_cond, generator=g,
                          device="cuda") * 2 - 1
        t = torch.randint(0, config.model.num_classes, (B,), generator=g, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model.eval()
        with torch.inference_mode():
            ops.reset_launches()
            got = model(x.permute(0, 3, 1, 2), t, cond.permute(0, 3, 1, 2))
            torch.cuda.synchronize()
            eval_launches = dict(ops.LAUNCHES)
            check_launches(eval_launches, {"gn_fused": n_gn, "attention_fwd": n_attn},
                           f"{name} evaluation")
            with ops.reference_ops():
                want = model(x.permute(0, 3, 1, 2), t, cond.permute(0, 3, 1, 2))
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} evaluation output {tuple(got.shape)} not finite")
        big = float(want.abs().max())
        diff = float((got - want).abs().max())
        check(diff <= TRAIN_GRAD_REL * big,
              f"{name} evaluation: kernels vs plain max abs diff {diff}, largest {big}")
        del model
        torch.cuda.empty_cache()
        want_launches = {"gn_fused": n_gn, "gn_fused_bwd": n_gn, "attention_fwd": n_attn,
                         "attention_bwd": n_attn}
        step = train_step_vs_plain(config, 20, B, want_launches, name)
        launches[name] = step["launches"]
        emit("wide_heads", card=card, config=name, head_dim=head_dim, image_size=sz,
             heads=sorted({m.n_heads for m in attn}), params=n_params,
             eval=dict(B=B, dtype="float32", max_abs_diff=diff, largest=big,
                       rel_tol=TRAIN_GRAD_REL, launches=eval_launches),
             train_step=step)
        torch.cuda.empty_cache()
    return launches


def phase_train_headline(card):
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.config import flagship_config
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = {}
    for dn in ("float32", "bfloat16"):
        config = flagship_config()
        config.training.batch_size = B = 64   # smmnist_DDPM_big5.yml's
        config.training.compute_dtype = dn
        model = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
        state = create_train_state(config, model, device="cuda")
        step = make_train_step(model, make_schedule(config), config)
        d = config.data
        g = torch.Generator(device="cuda").manual_seed(7)
        X = torch.rand(B, d.num_frames_cond + d.num_frames, d.image_size, d.image_size,
                       d.channels, generator=g, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, X, generator=g)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        times, losses = [], []
        for _ in range(5):
            ops.reset_launches()
            t0 = time.perf_counter()
            state, m = step(state, X, generator=g)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            launches[dn] = dict(ops.LAUNCHES)
            check_launches(launches[dn], TRAIN_LAUNCHES, f"train step {dn}")
            losses.append(float(m["loss"]))
            check(np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"])),
                  f"train step {dn}: loss {losses[-1]}")
        ms = statistics.median(times)
        emit("train_headline", card=card, B=B, dtype=dn, steps=5, warmup_s=warm_s,
             ms_per_step=ms, ms_all=times, clips_per_s=1e3 * B / ms,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches[dn],
             loss=losses, grad_norm=float(m["grad_norm"]), step=state.step)
        del model, state, step, m
        torch.cuda.empty_cache()
    return launches["float32"]


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
    train_cases = phase_train_kernels(card, summary)
    phase_train_slice(card)
    phase_wide_heads(card)
    train_launches = phase_train_headline(card)
    check("jax" not in sys.modules, "jax was imported")

    # times of the GroupNorm and attention kernels at the heaviest main-path
    # shape, in the headline's bf16
    gn_big = next(c for c in cases if c["op"] == "group_norm" and c["dtype"] == "bfloat16"
                  and (c["C"], c["H"], c["form"]) == (192, 64, "adagn_silu"))
    attn_big = next(c for c in cases if c["op"] == "attention" and c["dtype"] == "bfloat16"
                    and (c["T"], c["head_dim"]) == (1024, 64))
    timing["gn_fused"] = dict(ms=gn_big["ms"], plain_ms=gn_big["plain_ms"],
                              library_ms=None,   # no one call does GroupNorm + AdaGN + SiLU
                              bound=(gn_big["bound_ms"], gn_big["bound_by"]),
                              host_us=gn_big["host_us"])
    timing["attention_fwd"] = dict(ms=attn_big["ms"], plain_ms=attn_big["plain_ms"],
                                   library_ms=attn_big["library_ms"],
                                   bound=(attn_big["bound_ms"], attn_big["bound_by"]))
    # the backward kernels at the same shapes, in the training config's fp32
    for name, op, key in (("gn_fused_bwd", "group_norm_bwd", ("C", "H", "form")),
                          ("attention_bwd", "attention_bwd", ("T", "head_dim"))):
        want = (192, 64, "adagn_silu") if name == "gn_fused_bwd" else (1024, 64)
        c = next(c for c in train_cases if c["op"] == op and c["dtype"] == "float32"
                 and tuple(c[k] for k in key) == want)
        timing[name] = dict(ms=c["ms"], plain_ms=c["plain_ms"], library_ms=c["library_ms"],
                            bound=(c["bound_ms"], c["bound_by"]), dtype="float32")
    where = {   # name: (route, source, the TPU kernel it replaces, launches)
        "gn_fused": ("cuda", "mcvd_tpu_torch/csrc/groupnorm.cu",
                     "mcvd_tpu/ops/lab/groupnorm.py:409", launches),
        "attention_fwd": ("cuda", "mcvd_tpu_torch/csrc/attention.cu",
                          "mcvd_tpu/ops/lab/attention.py:60", launches),
        "fused_leaky_relu": ("triton", "mcvd_tpu_torch/ops/fused_act.py",
                             "mcvd_tpu/ops/fused_act.py:46", tool_launches),
        "gn_fused_bwd": ("cuda", "mcvd_tpu_torch/csrc/groupnorm.cu",
                         "mcvd_tpu/ops/lab/groupnorm.py:160", train_launches),
        "attention_bwd": ("cuda", "mcvd_tpu_torch/csrc/attention.cu",
                          "mcvd_tpu/ops/lab/attention.py:187", train_launches),
        "gn_copy": ("cuda", "mcvd_tpu_torch/csrc/profile_gn2.cu",
                    "tools/profile_gn2.py:65", tool_launches),
        "gn_variant": ("cuda", "mcvd_tpu_torch/csrc/profile_gn2.cu",
                       "tools/profile_gn2.py:145", tool_launches),
    }
    kernels = []
    for name, (route, source, replaces, counts) in where.items():
        t = timing[name]
        check(counts[name] > 0, f"{name} was not launched on its path")
        extra = {k: t[k] for k in ("host_us", "dtype") if k in t}
        if name == "gn_fused":   # it replaces the Pallas tiled path too
            extra["also_replaces"] = ["mcvd_tpu/ops/lab/groupnorm.py:283",
                                      "mcvd_tpu/ops/lab/groupnorm.py:324"]
        if name.endswith("_bwd"):   # counterparts of custom VJPs, not of Pallas bodies
            extra["counterpart_of"] = "the JAX custom VJP (jnp/einsum code XLA compiles)"
        if name == "attention_bwd":
            extra["also_replaces"] = ["mcvd_tpu/ops/lab/attention.py:78"]
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=counts[name], ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound"][0], bound_by=t["bound"][1],
                            library_ms=t["library_ms"], **extra, **summary[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
