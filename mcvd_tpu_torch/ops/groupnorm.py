"""GroupNorm(+affine)(+AdaGN)(+SiLU) in one CUDA launch for Hopper,
`gn_fused`, and its VJP, `gn_fused_bwd` (`csrc/groupnorm.cu`, built with
nvcc and bound with ctypes by `_build`).

`gn_fused` replaces `mcvd_tpu/ops/lab/groupnorm.py`: `fused_group_norm`
(Pallas body `_kernel`, one pass per example) and `_fused_group_norm_tiled`
(`_stats_kernel` and `_norm_kernel`, H-tiled two passes). One kernel covers
both: a thread-block cluster of up to 8 blocks per example, each block owning
a contiguous run of the channels_last rows, reduces the statistics over
distributed shared memory in a fixed order and applies the result in the
same launch. A block streams its run twice, the second time from L2 (the
Pallas single pass holds the example in VMEM instead; here holding the run
in shared memory was measured slower, PERF.md). `plan()` picks the cluster
size, rows per block, threads and shared memory.

Statistics are fp32 as E[x^2] - mean^2; channel index c*N+n belongs to the
group of c, so a group is a contiguous run of (C/G)*N channels; gamma/beta
are (C,) (repeated `frames_last` times), scale/shift (B, C*N) may be row
views of one (B, 2*C*N) tensor (`ActNorm`'s chunk) in fp32 or bf16; all
fold into y = A*x + B per (b, channel), then SiLU, stored in x's dtype.
The plain version is `models.layers.group_norm_folded`.

Gradients: when autograd needs them, `group_norm` runs through the
`torch.autograd.Function` `_GroupNorm`. On the card its forward also writes
the (B, G) mean and rstd, and its backward is `gn_fused_bwd`, the closed
form of the JAX package's custom VJP `_fgn_bwd` (`groupnorm.py:160`), on
one of two routes that `bwd_plan` picks by the call's size and form: a
cluster per example in one launch (small calls, and the affine forms up to
24 MiB), or two launches over (chunk of rows, example) blocks with
per-chunk sums in an fp32 scratch (larger calls; see the kernel's note).
On CPU
tensors, and under `reference_ops()`, forward and backward are the plain
versions (`group_norm_folded`, `group_norm_bwd_reference`, which follows
`_fgn_bwd` line by line). With no input needing a gradient the forward
saves nothing.

Bound on the card: bytes. The host side of a forward is one `torch.empty`
and one ctypes call: the 67 calls of one model evaluation are host-bound
otherwise.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import count_launch, use_kernel

_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232_448   # bytes of shared memory one H100 block may opt in to (227 KB)
MAX_CLUSTER = 8        # the portable thread-block cluster size
MAX_THREADS = 512
# gn_fused_bwd's routes, as measured on an H100 (PERF.md). The split route:
# blocks of up to 256 threads, two waves of two an SM on the H100's 132 SMs
# (one wave ran the 64x64 shapes 10-25% slower), each thread at least one
# loop of BWD_UNROLL rows (`csrc/groupnorm.cu::kBwdUnroll`); it takes the
# calls whose x and dy together pass SPLIT_BYTES, or AFFINE_SPLIT_BYTES with
# gamma (whose dgamma, dbeta take a third launch there). The cluster route
# takes the rest: the calls up to SPLIT_BYTES on the forward's clusters of
# 8, the larger affine calls on clusters of BWD_CLUSTER (4 beat 1, 2 and 8
# there).
BWD_THREADS = 256
BWD_BLOCKS = 2 * 2 * 132
BWD_UNROLL = 4
BWD_CLUSTER = 4
SPLIT_BYTES = 5 * 2**18          # 1.25 MiB
AFFINE_SPLIT_BYTES = 24 * 2**20


@dataclass(frozen=True)
class Plan:
    """How `gn_fused` runs one shape: `cluster` blocks per example, each
    owning `rows` rows of H*W (the last block possibly fewer), with
    `threads` threads and `smem` bytes of dynamic shared memory."""
    cluster: int
    rows: int
    threads: int
    smem: int


@dataclass(frozen=True)
class BwdPlan:
    """How `gn_fused_bwd` runs one shape: a grid of (`blocks`, B) blocks,
    block (k, b) owning rows [k*rows, (k+1)*rows) of example b's H*W (the
    last possibly fewer), with `threads` threads and `smem` bytes of dynamic
    shared memory; the `blocks` of an example are one cluster (at most 8) in
    one launch, or with `split` the chunks of two launches. `ws_floats` is
    the fp32 scratch the wrapper allocates (`bwd_workspace`)."""
    split: bool
    blocks: int
    rows: int
    threads: int
    smem: int
    ws_floats: int


def smem_bytes(threads: int, vec: int, CN: int, G: int) -> int:
    """The kernel's shared-memory layout (`csrc/groupnorm.cu::smem_layout`):
    per-thread partials, per-channel and per-group sums, group statistics."""
    return 4 * (threads * vec + 2 * CN + 4 * G)


def bwd_smem_bytes(threads: int, vec: int, CN: int, G: int) -> int:
    """`gn_fused_bwd`'s layout (`csrc/groupnorm.cu::bwd_smem_layout`):
    per-thread partials, a block's and its example's per-channel sums, the
    per-group means m1, m2."""
    return 4 * (threads * vec + 4 * CN + 2 * G)


def bwd_workspace(B: int, CN: int, G: int, C: int, chunks: int) -> dict:
    """Offsets, in floats, of the parts of `gn_fused_bwd`'s fp32 scratch
    (`csrc/groupnorm.cu::gn_fused_bwd`): the split route's per-chunk channel
    sums (B, chunks, 2, CN) and group shares (B, chunks, 2, G) (`chunks` 0
    on the cluster route), [d_scale | d_shift] (B, 2CN), the per-example
    parameter sums (B, 2CN), [dgamma | dbeta] (2C), and the total."""
    d_ss = B * chunks * 2 * (CN + G)
    dgb = d_ss + 4 * B * CN
    return {"d_ss": d_ss, "dgb": dgb, "total": dgb + 2 * C}


@functools.lru_cache(maxsize=None)
def plan(CN: int, H: int, W: int, dtype: torch.dtype, num_groups: int) -> Plan:
    """The launch plan of `gn_fused` for x (B, CN, H, W) of `dtype`: the
    largest cluster up to 8 with no empty block, one thread per 16-byte
    channel vector per row up to 512 threads."""
    if dtype not in _DTYPES:
        raise TypeError(f"gn_fused: dtype {dtype} not in {_DTYPES}")
    elem = dtype.itemsize
    vec = 16 // elem
    if CN % vec or CN % num_groups:
        raise ValueError(f"gn_fused: {CN} channels must be a multiple of {vec} and of "
                         f"{num_groups} groups")
    nv = CN // vec
    if nv > MAX_THREADS:
        raise ValueError(f"gn_fused: {CN} channels exceed {MAX_THREADS * vec}")
    S = H * W
    rows = -(-S // min(MAX_CLUSTER, S))
    cluster = -(-S // rows)
    threads = nv * max(1, min(MAX_THREADS // nv, rows))
    return Plan(cluster, rows, threads, smem_bytes(threads, vec, CN, num_groups))


def cluster_bwd_plan(B: int, CN: int, H: int, W: int, dtype: torch.dtype, num_groups: int,
                     frames_last: int = 1, size: int = BWD_CLUSTER) -> BwdPlan:
    """`gn_fused_bwd`'s cluster route with clusters of up to `size` blocks
    per example (at most `MAX_CLUSTER`), sized as the forward's plan sizes
    its clusters of 8; `tools.profile_gn_bwd` times other sizes."""
    plan(CN, H, W, dtype, num_groups)   # the forward's checks of the shape
    vec = 16 // dtype.itemsize
    nv = CN // vec
    S = H * W
    rows = -(-S // min(size, S))
    threads = nv * max(1, min(MAX_THREADS // nv, rows))
    return BwdPlan(False, -(-S // rows), rows, threads,
                   bwd_smem_bytes(threads, vec, CN, num_groups),
                   bwd_workspace(B, CN, num_groups, CN // frames_last, 0)["total"])


def bwd_plans(B: int, CN: int, H: int, W: int, dtype: torch.dtype, num_groups: int,
              frames_last: int = 1) -> tuple:
    """Both candidate plans of `gn_fused_bwd` for x (B, CN, H, W) of
    `dtype`, (cluster, split): the cluster route (`cluster_bwd_plan`); the
    split route with one thread per 16-byte channel vector per row, up to
    `BWD_THREADS` threads (more only where one row has more vectors), and
    about `BWD_BLOCKS` blocks over the B examples where every thread gets
    `BWD_UNROLL` rows, fewer where not, with no empty block. `bwd_plan`
    picks one; `tools.profile_gn_bwd` times both."""
    cluster = cluster_bwd_plan(B, CN, H, W, dtype, num_groups, frames_last)
    vec = 16 // dtype.itemsize
    nv = CN // vec
    C = CN // frames_last
    threads = nv * max(1, BWD_THREADS // nv)
    S = H * W
    chunks = max(1, min(-(-BWD_BLOCKS // B), -(-S // (BWD_UNROLL * threads // nv))))
    rows = -(-S // chunks)
    chunks = -(-S // rows)
    split = BwdPlan(True, chunks, rows, threads, bwd_smem_bytes(threads, vec, CN, num_groups),
                    bwd_workspace(B, CN, num_groups, C, chunks)["total"])
    return cluster, split


@functools.lru_cache(maxsize=None)
def bwd_plan(B: int, CN: int, H: int, W: int, dtype: torch.dtype, num_groups: int,
             frames_last: int = 1, affine: bool = False) -> BwdPlan:
    """The launch plan of `gn_fused_bwd`: up to `SPLIT_BYTES` of x and dy
    together, the cluster route with clusters of 8; with gamma (`affine`)
    up to `AFFINE_SPLIT_BYTES`, the cluster route with clusters of
    `BWD_CLUSTER`; else the split route (`bwd_plans`)."""
    cluster, split = bwd_plans(B, CN, H, W, dtype, num_groups, frames_last)
    nbytes = 2 * B * CN * H * W * dtype.itemsize
    if nbytes <= SPLIT_BYTES:
        return cluster_bwd_plan(B, CN, H, W, dtype, num_groups, frames_last, MAX_CLUSTER)
    return cluster if affine and nbytes <= AFFINE_SPLIT_BYTES else split


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x dtype {x.dtype} not in {_DTYPES}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be channels_last contiguous")


def _param(t, shape, x, name):
    """(pointer, is_bf16) of a parameter the kernel reads in place."""
    if t is None:
        return None, 0
    if t.dtype not in _DTYPES or t.device != x.device or t.shape != shape \
            or t.stride(-1) != 1:
        raise ValueError(f"group_norm: {name} must be {shape} fp32 or bf16 on {x.device} "
                         f"with unit inner stride, got {t.dtype} {tuple(t.shape)} "
                         f"{t.stride()} on {t.device}")
    return t.data_ptr(), int(t.dtype == torch.bfloat16)


def _params(x, gamma, beta, scale, shift, frames_last):
    """The kernels' parameter arguments: pointers, ss_stride, gb_bf16, ss_bf16."""
    B, CN = x.shape[:2]
    C = CN // frames_last
    g_ptr, gb_bf16 = _param(gamma, (C,), x, "gamma")
    b_ptr, b_bf16 = _param(beta, (C,), x, "beta")
    s_ptr, ss_bf16 = _param(scale, (B, CN), x, "scale")
    h_ptr, h_bf16 = _param(shift, (B, CN), x, "shift")
    if gb_bf16 != b_bf16 or ss_bf16 != h_bf16 or \
            (scale is not None and scale.stride(0) != shift.stride(0)):
        raise ValueError("group_norm: gamma/beta and scale/shift must share dtype and strides")
    if x.data_ptr() % 16:
        raise ValueError("group_norm: x must be 16-byte aligned")
    return (g_ptr, b_ptr, s_ptr, h_ptr, 0 if scale is None else scale.stride(0),
            gb_bf16, ss_bf16)


def max_active_clusters(x: torch.Tensor, p: Plan, num_groups: int) -> int:
    """How many clusters of plan `p` for x the card holds at once (the CUDA
    occupancy query); raises if the query fails or none fits."""
    import ctypes

    from ._build import check_launch, load_library

    B, CN, H, W = x.shape
    lib = load_library()
    out = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = lib.gn_fused_max_active_clusters(
            int(x.dtype == torch.bfloat16), B, H * W, CN, num_groups, 1, p.rows, p.cluster,
            p.threads, p.smem, ctypes.byref(out))
    check_launch(lib, "gn_fused occupancy query", err)
    if out.value < 1:
        raise RuntimeError(f"gn_fused: no cluster of plan {p} fits on the card")
    return out.value


def group_norm_fwd(x, num_groups, eps, gamma, beta, scale, shift, frames_last, act,
                   want_stats):
    """(y, stats): the plain version for CPU tensors and under
    `reference_ops()` (stats None), else `gn_fused`, which also writes the
    (B, 2, G) fp32 mean and rstd for `group_norm_bwd` when `want_stats`."""
    if not use_kernel(x):
        from ..models.layers import group_norm_folded

        return group_norm_folded(x, num_groups, eps=eps, gamma=gamma, beta=beta,
                                 scale=scale, shift=shift, frames_last=frames_last,
                                 act=act)[0], None
    from ._build import check_launch, load_library

    B, CN, H, W = x.shape
    p = plan(CN, H, W, x.dtype, num_groups)
    g_ptr, b_ptr, s_ptr, h_ptr, ss_stride, gb_bf16, ss_bf16 = _params(
        x, gamma, beta, scale, shift, frames_last)
    y = torch.empty_like(x)
    stats = (torch.empty(B, 2, num_groups, device=x.device, dtype=torch.float32)
             if want_stats else None)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.gn_fused(
            x.data_ptr(), y.data_ptr(), g_ptr, b_ptr, s_ptr, h_ptr,
            None if stats is None else stats.data_ptr(), ss_stride, gb_bf16, ss_bf16,
            int(x.dtype == torch.bfloat16), B, H * W, CN, num_groups, frames_last, p.rows,
            p.cluster, p.threads, p.smem, eps, H * W * (CN // num_groups),
            int(bool(act)), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "gn_fused", err)
    count_launch("gn_fused")
    return y, stats


def group_norm_bwd_reference(x, g, num_groups, *, eps, gamma=None, beta=None, scale=None,
                             shift=None, frames_last=1, act=False):
    """The plain VJP: (dx, dgamma, dbeta, dscale, dshift), None where the
    input is None. Follows the JAX package's `_fgn_bwd` line by line, in fp32
    on the NCHW layout (statistics recomputed, the variance two-pass as
    `jnp.var`); dx comes back in x's dtype, channels_last, the others fp32."""
    B, CN, H, W = x.shape
    G, N = num_groups, frames_last
    C = CN // N
    has_affine, has_emb = gamma is not None, scale is not None
    xf, gf = x.float(), g.float()
    xr = xf.reshape(B, G, CN // G, H, W)
    mean = xr.mean(dim=(2, 3, 4), keepdim=True)
    var = xr.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    x_hat = ((xr - mean) * rstd).reshape(B, CN, H, W)

    def col(t):   # (CN,) or (B, CN) -> broadcast over (B, CN, H, W)
        return t.reshape(-1, CN, 1, 1)

    g_cn = gamma.float().repeat_interleave(N) if has_affine else None
    b_cn = beta.float().repeat_interleave(N) if has_affine else None
    sc = scale.float() if has_emb else None
    affine_part = x_hat * col(g_cn) + col(b_cn) if has_affine else x_hat
    if act:
        u = affine_part
        if has_emb:
            u = u * (1.0 + col(sc)) + col(shift.float())
        sig = torch.sigmoid(u)
        dz = gf * (sig + u * sig * (1 - sig))
    else:
        dz = gf

    d_gamma = d_beta = d_scale = d_shift = None
    if has_emb:
        d_scale = (dz * affine_part).sum(dim=(2, 3))
        d_shift = dz.sum(dim=(2, 3))
        dz_aff = dz * (1.0 + col(sc))
    else:
        dz_aff = dz
    if has_affine:
        d_gamma = (dz_aff * x_hat).sum(dim=(0, 2, 3)).reshape(C, N).sum(-1)
        d_beta = dz_aff.sum(dim=(0, 2, 3)).reshape(C, N).sum(-1)
        dxh = dz_aff * col(g_cn)
    else:
        dxh = dz_aff

    dxh_r = dxh.reshape(B, G, CN // G, H, W)
    xh_r = x_hat.reshape(B, G, CN // G, H, W)
    m1 = dxh_r.mean(dim=(2, 3, 4), keepdim=True)
    m2 = (dxh_r * xh_r).mean(dim=(2, 3, 4), keepdim=True)
    dx = (rstd * (dxh_r - m1 - xh_r * m2)).reshape(B, CN, H, W)
    dx = dx.to(x.dtype).contiguous(memory_format=torch.channels_last)
    return dx, d_gamma, d_beta, d_scale, d_shift


def group_norm_bwd(x, g, stats, num_groups, gamma, beta, scale, shift, frames_last, act,
                   p=None):
    """`gn_fused_bwd` on CUDA tensors, from the forward's `stats`: (dx,
    dgamma, dbeta, dscale, dshift), dx in x's dtype and channels_last, the
    others fp32 (None where the input is None). `p` is `bwd_plan`'s plan
    unless given (one of `bwd_plans`, as the timing tool passes)."""
    from ._build import check_launch, load_library

    if not x.is_cuda or stats is None:
        raise ValueError("group_norm_bwd: the kernel takes CUDA tensors and the forward's "
                         "stats (the plain VJP is group_norm_bwd_reference)")
    B, CN, H, W = x.shape
    N = frames_last
    C = CN // N
    p = p or bwd_plan(B, CN, H, W, x.dtype, num_groups, N, gamma is not None)
    g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
    if g.data_ptr() % 16:   # a view at an odd offset: the kernel reads 16-byte vectors
        g = g.clone(memory_format=torch.channels_last)
    g_ptr, b_ptr, s_ptr, h_ptr, ss_stride, gb_bf16, ss_bf16 = _params(
        x, gamma, beta, scale, shift, frames_last)
    dx = torch.empty_like(x)
    at = bwd_workspace(B, CN, num_groups, C, p.blocks if p.split else 0)
    ws = torch.empty(p.ws_floats, device=x.device, dtype=torch.float32)
    d_ss = ws[at["d_ss"]:at["d_ss"] + 2 * B * CN].view(B, 2 * CN)
    d_gb = ws[at["dgb"]:at["dgb"] + 2 * C]
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.gn_fused_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), stats.data_ptr(), g_ptr, b_ptr, s_ptr,
            h_ptr, ss_stride, gb_bf16, ss_bf16, int(x.dtype == torch.bfloat16), B, H * W, CN,
            num_groups, N, p.rows, p.blocks, p.threads, p.smem, int(p.split),
            H * W * (CN // num_groups), int(bool(act)), ws.data_ptr(), C,
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "gn_fused_bwd", err)
    count_launch("gn_fused_bwd")
    d_gamma = d_gb[:C] if gamma is not None else None
    d_beta = d_gb[C:] if gamma is not None else None
    d_scale = d_ss[:, :CN] if scale is not None else None
    d_shift = d_ss[:, CN:] if scale is not None else None
    return dx, d_gamma, d_beta, d_scale, d_shift


class _GroupNorm(torch.autograd.Function):
    """group_norm with its VJP. The forward's route (kernel or plain) is
    kept for the backward, so a graph built under `reference_ops()` is
    differentiated by the plain versions wherever backward runs."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, num_groups, eps, frames_last, act):
        y, stats = group_norm_fwd(x, num_groups, eps, gamma, beta, scale, shift,
                                  frames_last, act, want_stats=True)
        ctx.save_for_backward(x, gamma, beta, scale, shift, stats)
        ctx.cfg = (num_groups, eps, frames_last, act)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, scale, shift, stats = ctx.saved_tensors
        num_groups, eps, frames_last, act = ctx.cfg
        if stats is not None:   # the forward ran gn_fused
            grads = group_norm_bwd(x, g, stats, num_groups, gamma, beta, scale, shift,
                                   frames_last, act)
        else:
            grads = group_norm_bwd_reference(x, g, num_groups, eps=eps, gamma=gamma,
                                             beta=beta, scale=scale, shift=shift,
                                             frames_last=frames_last, act=act)
        return (*grads, None, None, None, None)


def group_norm(x: torch.Tensor, num_groups: int, *, eps: float, gamma=None, beta=None,
               scale=None, shift=None, frames_last: int = 1, act: bool = False):
    """GroupNorm(+affine gamma/beta (C,))(+AdaGN scale/shift (B, C*N))(+SiLU)
    over (B, C*N, H, W) channels_last. CPU tensors take the plain version
    (`models.layers.group_norm_folded`); CUDA tensors take `gn_fused`.
    Differentiable in every input (see the module's note)."""
    _check_x(x, "group_norm")
    B, CN, H, W = x.shape
    if CN % (frames_last * num_groups):
        raise ValueError(f"group_norm: {CN} channels, frames_last={frames_last} "
                         f"and {num_groups} groups do not divide")
    if (gamma is None) != (beta is None) or (scale is None) != (shift is None):
        raise ValueError("group_norm: gamma/beta and scale/shift come in pairs")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, gamma, beta, scale, shift)):
        return _GroupNorm.apply(x, gamma, beta, scale, shift, num_groups, eps,
                                frames_last, act)
    return group_norm_fwd(x, num_groups, eps, gamma, beta, scale, shift, frames_last, act,
                          want_stats=False)[0]

