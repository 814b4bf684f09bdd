"""GroupNorm microbenchmark on the card (counterpart of `tools/profile_gn2.py`).

    python -m mcvd_tpu_torch.tools.profile_gn2 [--other DIR]

At the microbenchmark's shape, (16, 64, 64, 64) bf16 (B, H, W, C), it
reports for each line the marginal device ms of one call and the host us
of its enqueue:

  * a copy at (16, 64, 64, 64) and at the lane-full (16, 64, 32, 128), the
    CUDA kernel `gn_copy`: the card's copy ceiling at this size;
  * the current GroupNorm, `ops.groupnorm.group_norm`: the CUDA kernel
    `gn_fused`, one launch with a thread-block cluster per example;
  * `gn_variant`, one CUDA launch that does the statistics, the combine and
    normalize+SiLU on a thread-block cluster per example that holds the
    example in its shared memory (`variant_plan`): the baseline,
    `parallel`, H/4 blocks (tile-local statistics, timing only) and bf16
    statistics;
  * the current GroupNorm on the lane-full view (timing only).

The last line printed is one JSON record of all of it, with the card's name
and power limit. Needs one CUDA card (nvcc builds `gn_copy` and `gn_variant`
from `mcvd_tpu_torch/csrc` at first use); raises without one.

With `--other DIR` (the root of another checkout, e.g. `git archive` of the
parent commit unpacked under `build/`) it times that tree's `gn_variant`
against this one's instead, in turns, at the five `VARIANT_LINES` in bf16
and fp32 (`compare`: one JSON record a line).

`make_copy` and `gn_variant` each sit beside a plain PyTorch version, which
the wrappers take for CPU tensors and under `ops.reference_ops()`.
"""

from __future__ import annotations

import ctypes
import functools
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

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


# The kernel's plan. A statistics domain (an example, or an H-tile with
# hsplit > 1) is a contiguous run of `rows` rows of CN channels; a cluster of
# `cluster` blocks shares it, each block `rows_per_block` rows, loaded by TMA
# bulk copies of `chunk_rows` rows into `stages` slots of shared memory.
VARIANT_THREADS = 512        # threads a block, rounded down to CN/VEC
VARIANT_MAX_CLUSTER = 8      # the portable cluster size
VARIANT_MAX_NONPORTABLE = 16  # with the occupancy query: the H100's most
VARIANT_SMEM = 232448        # 227 KB, the most shared memory a block may opt in to
VARIANT_CHUNK = 65536        # streamed route: bytes of a bulk copy, about
VARIANT_RING = 2             # streamed route: slots of the ring (128 KB in flight a block)
VARIANT_ROUTES = ("resident", "streamed")


@dataclass(frozen=True)
class VariantPlan:
    route: str            # "resident": the block holds its rows; "streamed": reads them twice
    cluster: int          # blocks a domain
    rows_per_block: int
    threads: int
    chunk_rows: int       # rows of one bulk copy
    stages: int           # slots of shared memory, one mbarrier each
    smem: int             # bytes of dynamic shared memory a block
    blocks: int           # B * hsplit * cluster


def variant_smem(threads: int, esz: int, CN: int, chunk_rows: int, stages: int,
                 cluster: int) -> int:
    """Shared memory of a `gn_variant` block, as `csrc/profile_gn2.cu`'s
    `variant_smem` lays it out: the slots of x, the per-thread sums of x
    and x^2 (2 * threads * 16 / esz floats), the block's channel sums,
    every block's as pushed to it and each channel's mean and rstd (2 * CN
    floats each, 2 * CN * cluster for every block's), the example's
    parameters (4 * CN floats), one mbarrier a slot."""
    floats = 2 * threads * (16 // esz) + (8 + 2 * cluster) * CN
    return stages * chunk_rows * CN * esz + 4 * floats + 8 * stages


def variant_plan(B: int, hsplit: int, rows: int, CN: int, dtype: torch.dtype,
                 route: str | None = None, clusters_at_once=None) -> VariantPlan:
    """The launch plan of `gn_variant` for B examples of hsplit domains of
    `rows` rows of CN channels of `dtype` (fp32 or bf16).

    Resident route where a cluster of up to 8 blocks holds a domain in
    shared memory: each block loads its rows in one bulk copy (on the H100,
    several smaller copies a block, each on its own mbarrier so that the
    sums start as the first lands, finished later). Else the streamed
    route: each block reads its rows twice through a ring of up to
    `VARIANT_RING` slots (as many as fit) of bulk copies of about
    `VARIANT_CHUNK` bytes (a whole number of the block's row sweeps).

    The cluster: of the sizes with no empty block (and, resident, that hold
    the domain), the largest that puts B * hsplit * cluster blocks within
    the card's 132 SMs and all B * hsplit clusters on the card at once, by
    `clusters_at_once(plan)` (the card's occupancy query; None: no limit,
    and no size past the portable 8); where none does, the smallest. Sizes
    9 to 16 are taken only where the query holds them. `route` forces one (timing); a resident
    route that does not fit raises, as does a shape the kernel does not
    take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gn_variant: dtype {dtype}; the kernel takes fp32 or bf16")
    esz = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // esz
    if CN < 1 or CN % vec or CN > 1024:
        raise ValueError(f"gn_variant: {CN} channels; the kernel takes multiples of {vec} up "
                         f"to 1024")
    if not (1 <= B <= 65535 and 1 <= hsplit <= 65535):
        raise ValueError(f"gn_variant: B={B}, hsplit={hsplit}; the grid takes 1 to 65,535 each")
    if rows < 1:
        raise ValueError(f"gn_variant: {rows} rows a domain")
    if route not in (None, *VARIANT_ROUTES):
        raise ValueError(f"gn_variant: route {route!r} not in {VARIANT_ROUTES}")
    nv = CN // vec
    threads = nv * (VARIANT_THREADS // nv)
    rstep = threads // nv
    chunk = max(rstep, VARIANT_CHUNK // (CN * esz) // rstep * rstep)
    domains = B * hsplit

    def plan(k, resident):
        rpb = -(-rows // k)
        cr, stages = rpb, 1
        if not resident:   # as many slots as fit, up to the ring's
            cr = min(chunk, rpb)
            room = VARIANT_SMEM - variant_smem(threads, esz, CN, 0, 0, k)
            stages = max(1, min(VARIANT_RING, -(-rpb // cr), room // (cr * CN * esz + 8)))
        return VariantPlan("resident" if resident else "streamed", k, rpb, threads, cr, stages,
                           variant_smem(threads, esz, CN, cr, stages, k), domains * k)

    def pick(plans):
        good = [p for p in plans if domains * p.cluster <= _N_SM
                and (clusters_at_once is None or clusters_at_once(p) >= domains)]
        return max(good, key=lambda p: p.cluster) if good else plans[0]

    most = VARIANT_MAX_CLUSTER if clusters_at_once is None else VARIANT_MAX_NONPORTABLE
    sizes = [k for k in range(1, most + 1) if -(-rows // k) * (k - 1) < rows]
    held = [p for p in (plan(k, True) for k in sizes) if p.smem <= VARIANT_SMEM]
    if held and route != "streamed":
        return pick(held)
    if route == "resident":
        raise ValueError(f"gn_variant: {rows} rows of {CN * esz} bytes a domain do not fit "
                         f"the shared memory of a cluster of {most}")
    return pick([plan(k, False) for k in sizes])


def gn_variant(x, G, gamma, beta, scale, shift, *, hsplit=1, parallel=False,
               stats_bf16=False, route=None):
    """One-launch GroupNorm + affine + AdaGN (1+scale, shift) + SiLU, eps 1e-5,
    over x (B, C, H, W) stored channels_last, fp32 or bf16; gamma, beta (C,),
    scale, shift (B, C). A thread-block cluster per example, or per H-tile
    with `hsplit > 1`, which normalises each tile by its own statistics (not
    GroupNorm; timing only, as in the JAX tool); `variant_plan` sizes it
    and picks its route (`route` forces one, for timing). `stats_bf16`
    takes the statistics of x cast to bf16 and rounds each channel's sums of
    x and x^2 to bf16, as the JAX tool's program computes them. `parallel`
    is the JAX tool's Mosaic dimension semantics: CUDA blocks are always
    independent, so it is accepted and changes nothing. C must be a
    multiple of 8 (bf16) or 4 (fp32), at most 1024."""
    prm = _variant_args(x, G, gamma, beta, scale, shift, hsplit)
    if route not in (None, *VARIANT_ROUTES):
        raise ValueError(f"gn_variant: route {route!r} not in {VARIANT_ROUTES}")
    if not use_kernel(x):
        return gn_variant_reference(x, G, *prm, hsplit=hsplit, stats_bf16=stats_bf16)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("gn_variant: the kernel is forward-only; run under "
                           "torch.no_grad() or torch.inference_mode()")
    B, CN, H, W = x.shape
    p = card_plan(x, hsplit, route)
    if x.data_ptr() % 16:
        raise ValueError("gn_variant: x must be 16-byte aligned")
    from ..ops._build import check_launch, load_library

    lib = load_library()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = lib.gn_variant(int(x.dtype == torch.bfloat16), x.data_ptr(),
                             *(t.data_ptr() for t in prm), y.data_ptr(), B, hsplit,
                             (H // hsplit) * W, CN, G, H * W * (CN // G) / hsplit, EPS,
                             int(bool(stats_bf16)),
                             *_plan_args(p), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "gn_variant", err)
    count_launch("gn_variant")
    return y


def _plan_args(p: VariantPlan) -> tuple:
    return (p.cluster, p.rows_per_block, p.threads, p.chunk_rows, p.stages,
            int(p.route == "resident"), p.smem)


@functools.lru_cache(maxsize=None)
def _card_plan(device: int, B: int, hsplit: int, rows: int, CN: int, dtype: torch.dtype,
               route: str | None) -> VariantPlan:
    """`variant_plan` on the card `device`, with its occupancy query."""
    return variant_plan(B, hsplit, rows, CN, dtype, route, functools.partial(
        _clusters_at_once, device, dtype == torch.bfloat16, B, hsplit, rows, CN))


@functools.lru_cache(maxsize=None)
def _clusters_at_once(device: int, bf16: bool, B: int, hsplit: int, rows: int, CN: int,
                      p: VariantPlan) -> int:
    from ..ops._build import check_launch, load_library

    lib = load_library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.gn_variant_max_active_clusters(int(bf16), B, hsplit, rows, CN, CN,
                                                 *_plan_args(p), ctypes.byref(out))
    check_launch(lib, "gn_variant_max_active_clusters", err)
    return out.value


def variant_max_active_clusters(x: torch.Tensor, p: VariantPlan, hsplit: int = 1) -> int:
    """How many clusters of plan `p` the card holds at once for x (the
    occupancy query); fewer than B * hsplit means more than one wave."""
    B, CN, H, W = x.shape
    return _clusters_at_once(x.device.index, x.dtype == torch.bfloat16, B, hsplit,
                             (H // hsplit) * W, CN, p)


def card_plan(x: torch.Tensor, hsplit: int = 1, route: str | None = None) -> VariantPlan:
    """The plan `gn_variant` launches for x on its card."""
    B, CN, H, W = x.shape
    return _card_plan(x.device.index, B, hsplit, (H // hsplit) * W, CN, x.dtype, route)


# ---------------------------------------------------------------- timing

def device_ms(fn, n=10, reps=5):
    """Median device time of one fn() call: the card first sleeps, so the
    host has enqueued all n calls before the card reaches them and the
    events time back-to-back work, not the host's enqueue. The sleep is
    sized as `marginal` sizes its own, from the warm-up call's host time:
    twice n such calls plus 5 ms, at most 100M cycles (~57 ms)."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = min(100_000_000, int(_cycles_per_ms() * (2e3 * n * host_s + 5.0)))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


@functools.lru_cache(maxsize=None)
def _cycles_per_ms() -> float:
    """`_sleep_cycles_per_ms`, measured once a process."""
    return _sleep_cycles_per_ms()


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


# The five `gn_variant` lines: the JAX tool's four on the (16, 64, 64, 64)
# view and the same call on the lane-full (16, 128, 64, 32) view (label, C,
# keyword arguments).
VARIANT_LINES = [("baseline", 64, {}), ("parallel", 64, dict(parallel=True)),
                 ("hsplit4", 64, dict(hsplit=4, parallel=True)),
                 ("stats_bf16", 64, dict(stats_bf16=True, parallel=True)),
                 ("lane_full", 128, {})]
STREAMED_SHAPE = (2, 64, 256, 256)   # (B, C, H, W): 8 MB bf16 examples, on the streamed route


def compare(other_root: str, device="cuda", turns: int = 2) -> list:
    """`gn_variant` of this tree against another checkout's
    (`profile_gn_bwd.load_other`)
    at the five `VARIANT_LINES` and at (2, 64, 256, 256), past what a
    cluster holds (`STREAMED_SHAPE`), in bf16 and fp32, with the plain
    version, `gn_fused` (the current GroupNorm) and, where the plan is
    resident, the streamed route forced at the same shape: device ms of one
    call (`device_ms`, x warm in L2), timed in turns (other, this, this,
    other, ...). One record a line and dtype: each version's times, the
    plan, the clusters the card holds at once and the bytes bound."""
    from .profile_gn_bwd import load_other

    other = load_other(other_root, "tools.profile_gn2")
    device = torch.device(device)
    G = 32
    x64, x128, prm = inputs(device)
    views = {64: x64.permute(0, 3, 1, 2), 128: x128.permute(0, 3, 1, 2)}
    g = torch.Generator(device=device).manual_seed(1)
    B, C, H, W = STREAMED_SHAPE
    views["streamed"] = torch.rand(B, H, W, C, generator=g, device=device).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    prm["streamed"] = (prm[C][0], prm[C][1], *(0.1 * torch.randn(B, C, generator=g,
                                                                 device=device) for _ in "ab"))
    records = []
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for label, c, kw in [*VARIANT_LINES, ("streamed", "streamed", {})]:
                v = views[c].to(dtype)
                B, CN, H, W = v.shape
                hs = kw.get("hsplit", 1)
                p = card_plan(v, hs)
                fns = {"other": lambda: other.gn_variant(v, G, *prm[c], **kw),
                       "this": lambda: gn_variant(v, G, *prm[c], **kw),
                       "plain": lambda: gn_variant_reference(v, G, *prm[c], **kw)}
                if p.route == "resident":
                    fns["streamed"] = lambda: gn_variant(v, G, *prm[c], route="streamed", **kw)
                if "hsplit" not in kw and "stats_bf16" not in kw:
                    g, b, sc, sh = prm[c]
                    fns["gn_fused"] = lambda: GN.group_norm(v, G, eps=EPS, gamma=g, beta=b,
                                                           scale=sc, shift=sh, act=True)
                times = {k: [] for k in fns}
                order = ["other", *[k for k in fns if k != "other"]]
                for t in range(turns):
                    for k in (order if t % 2 == 0 else order[::-1]):
                        times[k].append(device_ms(fns[k]))
                bound_ms = 1e3 * 2 * v.numel() * v.element_size() / HBM_BYTES_PER_S
                rec = dict(line=label, dtype=str(dtype).split(".")[-1], shape=list(v.shape),
                           plan=p.__dict__, clusters_at_once=variant_max_active_clusters(
                               v, p, hs), bound_ms=bound_ms,
                           ms={k: min(ts) for k, ts in times.items()}, turns=times)
                rec["bound_share"] = bound_ms / rec["ms"]["this"]
                rec["speedup_vs_other"] = rec["ms"]["other"] / rec["ms"]["this"]
                print(json.dumps(rec), flush=True)
                records.append(rec)
    return records


def main(argv=()) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another checkout: time its gn_variant against "
                                    "this one's in turns (`compare`) instead of the lines")
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        raise RuntimeError("profile_gn2 runs on the card: no CUDA device")
    card = nvidia_smi()
    print(f"# device={torch.cuda.get_device_name(0)} card={card}", flush=True)
    if args.other:
        compare(args.other)
        return 0
    ops.reset_launches()
    lines = measure()
    print(json.dumps({"tool": "profile_gn2", "card": card,
                      "device": torch.cuda.get_device_name(0),
                      "hbm_spec_gb_per_s": HBM_BYTES_PER_S / 1e9, "lines": lines,
                      "launches": dict(ops.LAUNCHES)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
