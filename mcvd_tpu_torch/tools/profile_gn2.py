"""GroupNorm microbenchmark on the card (counterpart of `tools/profile_gn2.py`).

    python -m mcvd_tpu_torch.tools.profile_gn2

At the microbenchmark's shape, (16, 64, 64, 64) bf16 (B, H, W, C), it
reports for each line the marginal device ms of one call and the host us
of its enqueue:

  * a copy at (16, 64, 64, 64) and at the lane-full (16, 64, 32, 128), the
    CUDA kernel `gn_copy`: the card's copy ceiling at this size;
  * the current GroupNorm, `ops.groupnorm.group_norm` (Triton `gn_stats`,
    the combine in torch ops, Triton `gn_apply`);
  * `gn_variant`, one CUDA launch that does the statistics, the combine and
    normalize+SiLU: the baseline, `parallel`, H/4 blocks (tile-local
    statistics, timing only) and bf16 statistics;
  * the current GroupNorm on the lane-full view (timing only).

The last line printed is one JSON record of all of it, with the card's name
and power limit. Needs one CUDA card (nvcc builds `gn_copy` and `gn_variant`
from `mcvd_tpu_torch/csrc` at first use); raises without one.

`make_copy` and `gn_variant` each sit beside a plain PyTorch version, which
the wrappers take for CPU tensors and under `ops.reference_ops()`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from ..ops import count_launch, use_kernel
from ..ops import groupnorm as GN

EPS = 1e-5              # the JAX tool's gn_variant
K1, K2 = 1, 5           # chained calls per step: marginal = (t(K2) - t(K1)) / (K2 - K1)
N_CHAIN = 10            # steps per timed run
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet
_COPY_SCALE = 1.0000001
_N_SM = 132


def group_matrix(CN: int, num_groups: int, frames_last: int) -> np.ndarray:
    """One-hot (CN, G): channel index (channel-major c*N+n) -> group of its
    true channel c. A copy of `mcvd_tpu/ops/lab/groupnorm.py::_group_matrix`."""
    C = CN // frames_last
    cg = C // num_groups
    M = np.zeros((CN, num_groups), np.float32)
    for idx in range(CN):
        M[idx, (idx // frames_last) // cg] = 1.0
    return M


# ------------------------------------------------------------------ copy

def copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `gn_copy`: bf16(fp32(x) * 1.0000001), which is x."""
    return (x.float() * _COPY_SCALE).to(x.dtype)


def gn_copy(x: torch.Tensor) -> torch.Tensor:
    """y = bf16(fp32(x) * 1.0000001) over a contiguous bf16 tensor."""
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"gn_copy: x must be contiguous bf16, got {x.dtype}")
    if not use_kernel(x):
        return copy_reference(x)
    from ..ops._build import check_launch, load_library

    lib = load_library()
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("gn_copy: x and y must be 16-byte aligned")
    n_blocks = max(1, min(-(-(n // 8) // 256), 16 * _N_SM))
    with torch.cuda.device(x.device):
        err = lib.gn_copy_bf16(x.data_ptr(), y.data_ptr(), n, n_blocks,
                               torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "gn_copy", err)
    count_launch("gn_copy")
    return y


def make_copy(shape):
    """The copy for tensors of `shape` (the JAX tool's `make_copy`)."""
    shape = tuple(shape)

    def fn(x):
        if tuple(x.shape) != shape:
            raise ValueError(f"copy made for {shape}, got {tuple(x.shape)}")
        return gn_copy(x)

    return fn


# ------------------------------------------------------------ gn_variant

def _variant_args(x, G, gamma, beta, scale, shift, hsplit):
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gn_variant: x must be 4-D fp32 or bf16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("gn_variant: x must be NCHW stored channels_last")
    B, CN, H, W = x.shape
    if CN % G or H % hsplit or hsplit < 1:
        raise ValueError(f"gn_variant: {CN} channels into {G} groups, H={H} into "
                         f"{hsplit} tiles do not divide")
    prm = [t.to(device=x.device, dtype=torch.float32).contiguous()
           for t in (gamma, beta, scale, shift)]
    if prm[0].shape != (CN,) or prm[1].shape != (CN,) or prm[2].shape != (B, CN) \
            or prm[3].shape != (B, CN):
        raise ValueError(f"gn_variant: gamma, beta must be ({CN},), scale, shift "
                         f"({B}, {CN})")
    return prm


def gn_variant_reference(x, G, gamma, beta, scale, shift, *, hsplit=1, parallel=False,
                         stats_bf16=False):
    """Plain version of `gn_variant`, in the JAX tool's order of operations."""
    gamma, beta, scale, shift = _variant_args(x, G, gamma, beta, scale, shift, hsplit)
    B, CN, H, W = x.shape
    bf16 = torch.bfloat16
    xt = x.float().reshape(B, CN, hsplit, H // hsplit, W)
    xs = xt.to(bf16).float() if stats_bf16 else xt
    s1, s2 = xs.sum((3, 4)), (xs * xs).sum((3, 4))      # (B, CN, hsplit)
    if stats_bf16:
        s1, s2 = s1.to(bf16).float(), s2.to(bf16).float()
    M = torch.from_numpy(group_matrix(CN, G, 1)).to(x.device)   # (CN, G) one-hot
    s1, s2 = (torch.einsum("bct,cg->bgt", s, M) for s in (s1, s2))
    n = H * W * (CN // G) / hsplit
    mean = s1 / n
    rstd = torch.rsqrt(s2 / n - mean * mean + EPS)
    mean, rstd = (torch.einsum("bgt,cg->bct", s, M)[..., None, None] for s in (mean, rstd))
    y = (xt - mean) * rstd
    y = y * gamma.view(1, CN, 1, 1, 1) + beta.view(1, CN, 1, 1, 1)
    y = y * (1.0 + scale.view(B, CN, 1, 1, 1)) + shift.view(B, CN, 1, 1, 1)
    y = torch.nn.functional.silu(y).reshape(B, CN, H, W)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def gn_variant(x, G, gamma, beta, scale, shift, *, hsplit=1, parallel=False,
               stats_bf16=False):
    """One-launch GroupNorm + affine + AdaGN (1+scale, shift) + SiLU, eps 1e-5,
    over x (B, C, H, W) stored channels_last, fp32 or bf16; gamma, beta (C,),
    scale, shift (B, C). One CUDA block per example, or per H-tile with
    `hsplit > 1`, which normalises each tile by its own statistics (not
    GroupNorm; timing only, as in the JAX tool). `stats_bf16` takes the
    statistics of x cast to bf16 and rounds each channel's sums of x and x^2
    to bf16, as the JAX tool's program computes them. `parallel` is the JAX tool's Mosaic
    dimension semantics: CUDA blocks are always independent, so it is
    accepted and changes nothing. C must be a multiple of 8 (bf16) or 4
    (fp32), at most 1024."""
    prm = _variant_args(x, G, gamma, beta, scale, shift, hsplit)
    if not use_kernel(x):
        return gn_variant_reference(x, G, *prm, hsplit=hsplit, stats_bf16=stats_bf16)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("gn_variant: the kernel is forward-only; run under "
                           "torch.no_grad() or torch.inference_mode()")
    B, CN, H, W = x.shape
    vec = 16 // x.element_size()
    if CN % vec or CN > 1024:
        raise ValueError(f"gn_variant: {CN} channels; the kernel takes multiples of "
                         f"{vec} up to 1024")
    if x.data_ptr() % 16:
        raise ValueError("gn_variant: x must be 16-byte aligned")
    from ..ops._build import check_launch, load_library

    lib = load_library()
    fn = lib.gn_variant_f32 if x.dtype == torch.float32 else lib.gn_variant_bf16
    y = torch.empty_like(x, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *(t.data_ptr() for t in prm), y.data_ptr(), B, hsplit,
                 (H // hsplit) * W, CN, G, H * W * (CN // G) / hsplit, EPS,
                 int(bool(stats_bf16)), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "gn_variant", err)
    count_launch("gn_variant")
    return y


# ---------------------------------------------------------------- timing

def _sleep_cycles_per_ms() -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def marginal(fn, x, label, *, reps=5):
    """Per call of `fn`: marginal device ms and host us of enqueue.

    A run chains N_CHAIN * k calls (y = fn(y)); the marginal of a call is
    (t(K2) - t(K1)) / ((K2 - K1) * N_CHAIN), which cancels what a run costs
    once. Host: perf_counter around the enqueue of a run (no sync inside).
    Device: CUDA events around a run that the card reaches only after it
    has slept longer than the host takes to enqueue it, so the events time
    back-to-back work and not the host."""
    def run(k):
        y = x
        for _ in range(N_CHAIN * k):
            y = fn(y)
        return y

    run(K2)
    torch.cuda.synchronize()
    host = {}
    for k in (K1, K2):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(k)
            ts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        host[k] = statistics.median(ts)
    cycles = int(_sleep_cycles_per_ms() * (2e3 * host[K2] + 5.0))
    dev = {}
    for k in (K1, K2):
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            run(k)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        dev[k] = statistics.median(ts)
    calls = (K2 - K1) * N_CHAIN
    nbytes = 2 * x.numel() * x.element_size()   # x read once, y written once
    ms = (dev[K2] - dev[K1]) / calls
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    line = dict(label=label, ms=ms, host_us=1e6 * (host[K2] - host[K1]) / calls,
                bytes=nbytes, bound_ms=bound_ms, bound_share=bound_ms / ms if ms > 0 else None,
                gb_per_s=nbytes / ms / 1e6 if ms > 0 else None)
    print(f"{label:46s}: {1e3 * ms:8.1f} us device, {line['host_us']:8.1f} us host",
          flush=True)
    return line


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def inputs(device, seed=0):
    """The JAX tool's tensors on `device`: x64 (16, 64, 64, 64) and the
    lane-full x128 (16, 64, 32, 128) bf16 in U[0, 1), NHWC contiguous; the
    GroupNorm's gamma, beta (C,) and scale, shift (B, C) for both widths."""
    B, H, W, C = 16, 64, 64, 64
    g = torch.Generator(device=device).manual_seed(seed)
    x64 = torch.rand(B, H, W, C, generator=g, device=device).to(torch.bfloat16)
    x128 = torch.rand(B, H, W // 2, 2 * C, generator=g, device=device).to(torch.bfloat16)
    prm = {}
    for c in (C, 2 * C):
        prm[c] = (torch.ones(c, device=device), torch.zeros(c, device=device),
                  0.1 * torch.randn(B, c, generator=g, device=device),
                  0.1 * torch.randn(B, c, generator=g, device=device))
    return x64, x128, prm


def measure(device="cuda"):
    """Run every line of the microbenchmark once; returns the lines."""
    device = resolve_device(device, "profile_gn2")
    if device.type != "cuda":
        raise RuntimeError("profile_gn2 measures the card; it has no CPU mode")
    G = 32
    x64, x128, prm = inputs(device)
    v64, v128 = x64.permute(0, 3, 1, 2), x128.permute(0, 3, 1, 2)   # NCHW channels_last
    g1, b1, s1, h1 = prm[64]
    g2, b2, s2, h2 = prm[128]
    lines = []
    with torch.inference_mode():
        lines.append(marginal(make_copy(x64.shape), x64, "copy (.,64) gn_copy"))
        lines.append(marginal(make_copy(x128.shape), x128, "copy (.,128) gn_copy"))
        lines.append(marginal(lambda y: GN.group_norm(y, G, eps=EPS, gamma=g1, beta=b1,
                                                      scale=s1, shift=h1, act=True),
                              v64, "current fused GN"))
        for label, kw in [("variant: baseline re-impl", {}),
                          ("variant: parallel semantics", dict(parallel=True)),
                          ("variant: H/4 blocks (approx stats)", dict(hsplit=4, parallel=True)),
                          ("variant: bf16 stats + parallel", dict(stats_bf16=True,
                                                                  parallel=True))]:
            lines.append(marginal(lambda y, kw=kw: gn_variant(y, G, g1, b1, s1, h1, **kw),
                                  v64, label))
        # the same GN math on a lane-full view (wrong grouping; timing only)
        lines.append(marginal(lambda y: GN.group_norm(y, G, eps=EPS, gamma=g2, beta=b2,
                                                      scale=s2, shift=h2, act=True),
                              v128, "fused GN on lane-full (timing only)"))
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_gn2 runs on the card: no CUDA device")
    card = nvidia_smi()
    print(f"# device={torch.cuda.get_device_name(0)} card={card}", flush=True)
    ops.reset_launches()
    lines = measure()
    print(json.dumps({"tool": "profile_gn2", "card": card,
                      "device": torch.cuda.get_device_name(0),
                      "hbm_spec_gb_per_s": HBM_BYTES_PER_S / 1e9, "lines": lines,
                      "launches": dict(ops.LAUNCHES)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
