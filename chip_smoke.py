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
               attention at the main path's T and a ragged T, the bf16
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

    attn_shapes = ATTN_SHAPES + [(100, 2)]   # and a ragged T
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for T, h in attn_shapes:
                qkv = torch.randn(B, T, 3 * h * 64, generator=g, device=dev).to(dtype)
                got = A.attention_packed(qkv, h, 0.125)
                with ops.reference_ops():
                    want = A.attention_packed(qkv, h, 0.125)
                tols = (A.bf16_tolerances(qkv, h, 0.125) if dn == "bfloat16"
                        else {"plain": TOL[dn]})
                tol = tols["plain"]
                err, ok = max_err(got, want, dn, tol)
                check(ok, f"attention T={T} h={h} {dn}: max err {err}")
                record(summary, "attention_fwd", dn, err)
                # (B*h, T, 64) views of q, k, v, made before timing
                q, k, v = (t.reshape(B, T, h, 64).transpose(1, 2).reshape(B * h, T, 64)
                           .contiguous() for t in qkv.split(h * 64, dim=-1))
                case = dict(op="attention", B=B, T=T, heads=h, head_dim=64, dtype=dn,
                            path=("tensor cores, mma.sync m16n8k16 bf16" if dn == "bfloat16"
                                  else "CUDA cores, fp32 FMA"),
                            max_abs_err=err, max_atol=float(torch.as_tensor(tol[0]).max()),
                            rtol=tol[1])
                if dn == "bfloat16":   # the kernel's own arithmetic in plain torch
                    emu = A.attention_tc_emulation(q, k, v, 0.125)
                    emu = emu.reshape(B, h, T, 64).transpose(1, 2).reshape(B, T, h * 64)
                    e_err, e_ok = max_err(got, emu, dn, tols["emulation"])
                    check(e_ok, f"attention T={T} h={h} bf16 vs its emulation: max err {e_err}")
                    case.update(emulation_err=e_err,
                                emulation_max_atol=float(tols["emulation"][0].max()),
                                emulation_rtol=tols["emulation"][1])
                if (T, h) in ATTN_SHAPES:
                    case["ms"] = device_ms(lambda: A.attention_packed(qkv, h, 0.125))
                    case["plain_ms"] = device_ms(
                        lambda: A.attention_packed_reference(qkv, h, 0.125))
                    # the one PyTorch call, on (B, h, T, D)
                    q4, k4, v4 = (t.view(B, h, T, 64) for t in (q, k, v))
                    case["library_ms"] = device_ms(
                        lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=0.125))
                    flops = 4 * B * h * T * T * 64
                    case["bound_ms"], case["bound_by"] = bound(
                        nbytes(qkv) * 4 // 3, flops,
                        "bf16" if dtype == torch.bfloat16 else "fp32")
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
    ops.reset_launches()
    got = block(init, cond, step_noise=step_noise)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_launches(launches, {"gn_fused": 67 * 11, "attention_fwd": 10 * 11}, "slice")
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
    timing["gn_fused"] = dict(ms=gn_big["ms"], plain_ms=gn_big["plain_ms"],
                              library_ms=None,   # no one call does GroupNorm + AdaGN + SiLU
                              bound=(gn_big["bound_ms"], gn_big["bound_by"]),
                              host_us=gn_big["host_us"])
    timing["attention_fwd"] = dict(ms=attn_big["ms"], plain_ms=attn_big["plain_ms"],
                                   library_ms=attn_big["library_ms"],
                                   bound=(attn_big["bound_ms"], attn_big["bound_by"]))
    where = {   # name: (route, source, the TPU kernel it replaces, launches)
        "gn_fused": ("cuda", "mcvd_tpu_torch/csrc/groupnorm.cu",
                     "mcvd_tpu/ops/lab/groupnorm.py:409", launches),
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
        extra = {k: t[k] for k in ("host_us",) if k in t}
        if name == "gn_fused":   # it replaces the Pallas tiled path too
            extra["also_replaces"] = ["mcvd_tpu/ops/lab/groupnorm.py:283",
                                      "mcvd_tpu/ops/lab/groupnorm.py:324"]
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
