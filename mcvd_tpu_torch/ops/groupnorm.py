"""GroupNorm(+affine)(+AdaGN)(+SiLU) in one CUDA launch for Hopper,
`gn_fused` (`csrc/groupnorm.cu`, built with nvcc and bound with ctypes by
`_build`).

Replaces `mcvd_tpu/ops/lab/groupnorm.py`: `fused_group_norm` (Pallas body
`_kernel`, one pass per example) and `_fused_group_norm_tiled`
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
The plain version is `models.layers.group_norm_folded`. Forward only: the
backward (`_fgn_bwd`) comes with training.

Bound on the card: bytes. The host side of a call is one `torch.empty` and
one ctypes call: the 67 calls of one model evaluation are host-bound
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


@dataclass(frozen=True)
class Plan:
    """How `gn_fused` runs one shape: `cluster` blocks per example, each
    owning `rows` rows of H*W (the last block possibly fewer), with
    `threads` threads and `smem` bytes of dynamic shared memory."""
    cluster: int
    rows: int
    threads: int
    smem: int


def smem_bytes(threads: int, vec: int, CN: int, G: int) -> int:
    """The kernel's shared-memory layout (`csrc/groupnorm.cu::smem_layout`):
    per-thread partials, per-channel and per-group sums, group statistics."""
    return 4 * (threads * vec + 2 * CN + 4 * G)


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


def group_norm(x: torch.Tensor, num_groups: int, *, eps: float, gamma=None, beta=None,
               scale=None, shift=None, frames_last: int = 1, act: bool = False):
    """GroupNorm(+affine gamma/beta (C,))(+AdaGN scale/shift (B, C*N))(+SiLU)
    over (B, C*N, H, W) channels_last. CPU tensors take the plain version
    (`models.layers.group_norm_folded`); CUDA tensors take `gn_fused`."""
    _check_x(x, "group_norm")
    B, CN, H, W = x.shape
    if CN % (frames_last * num_groups):
        raise ValueError(f"group_norm: {CN} channels, frames_last={frames_last} "
                         f"and {num_groups} groups do not divide")
    if (gamma is None) != (beta is None) or (scale is None) != (shift is None):
        raise ValueError("group_norm: gamma/beta and scale/shift come in pairs")
    if not use_kernel(x):
        from ..models.layers import group_norm_folded

        return group_norm_folded(x, num_groups, eps=eps, gamma=gamma, beta=beta,
                                 scale=scale, shift=shift, frames_last=frames_last,
                                 act=act)[0]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, gamma, beta, scale, shift)):
        raise RuntimeError("group_norm: the kernel is forward-only; run under "
                           "torch.no_grad() or torch.inference_mode()")
    from ._build import check_launch, load_library

    p = plan(CN, H, W, x.dtype, num_groups)
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
    y = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.gn_fused(
            x.data_ptr(), y.data_ptr(), g_ptr, b_ptr, s_ptr, h_ptr,
            0 if scale is None else scale.stride(0), gb_bf16, ss_bf16,
            int(x.dtype == torch.bfloat16), B, H * W, CN, num_groups, frames_last, p.rows,
            p.cluster, p.threads, p.smem, eps, H * W * (CN // num_groups),
            int(bool(act)), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "gn_fused", err)
    count_launch("gn_fused")
    return y
