"""GroupNorm(+affine)(+AdaGN)(+SiLU) as two Triton kernels for Hopper.

Replaces `mcvd_tpu/ops/lab/groupnorm.py`: `fused_group_norm` (Pallas body
`_kernel`, one pass per example) and `_fused_group_norm_tiled` (`_stats_kernel`
and `_norm_kernel`, H-tiled two passes). One design covers both:

  * `gn_stats`: grid (B, chunks of H*W rows). Each program sums x and x^2 per
    channel in fp32 over its rows of the channels_last (B, H*W, C*N) memory,
    folds channels into groups (channel c*N+n belongs to group c // (C/G), so
    a group is a contiguous run of (C/G)*N channels) and writes deterministic
    partials (B, chunks, 2, G): no atomics.
  * the combine (mean, rstd, then gamma/beta and AdaGN 1+scale/shift folded
    into one per-(b, channel) A, B) is a few tiny tensor ops in the wrapper,
    the same split the Pallas tiled path makes;
  * `gn_apply`: y = x*A[b,c] + B[b,c] in fp32, optional SiLU, stored in x's
    dtype.

Bound on the card: bytes. x is read twice and written once at well under one
FLOP per byte, so the design keeps every access a coalesced row of C*N
contiguous channels, splits H*W so that B*chunks programs cover the SMs, and
has no size limit (the Pallas kernel's fallback to the lax reference for large
examples is not carried over). Forward only: the backward (`_fgn_bwd`) comes
with training.
"""

from __future__ import annotations

import torch

from . import count_launch, use_kernel

_TRITON = {}
_DTYPES = (torch.float32, torch.bfloat16)
_TARGET_PROGRAMS = 4 * 132  # a few waves over the H100's 132 SMs


def _kernels():
    """Define the Triton kernels on first use (triton is imported only here)."""
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as tl

    @triton.jit
    def gn_stats_kernel(x_ptr, out_ptr, S, CN, G, CPG, ROWS,
                        BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
                        BLOCK_G: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        chunk = tl.program_id(1)
        n_chunks = tl.num_programs(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < CN
        rows = tl.arange(0, BLOCK_S)
        base = x_ptr + b * S * CN
        s1 = tl.zeros([BLOCK_C], dtype=tl.float32)
        s2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        row0 = chunk * ROWS
        for r in range(0, ROWS, BLOCK_S):
            rr = row0 + r + rows
            m = (rr < S)[:, None] & cmask[None, :]
            xv = tl.load(base + rr[:, None] * CN + cols[None, :], mask=m,
                         other=0.0).to(tl.float32)
            s1 += tl.sum(xv, axis=0)
            s2 += tl.sum(xv * xv, axis=0)
        gs = tl.arange(0, BLOCK_G)
        onehot = ((cols // CPG)[:, None] == gs[None, :]) & cmask[:, None]
        g1 = tl.sum(tl.where(onehot, s1[:, None], 0.0), axis=0)
        g2 = tl.sum(tl.where(onehot, s2[:, None], 0.0), axis=0)
        out = out_ptr + (b * n_chunks + chunk) * 2 * G
        gm = gs < G
        tl.store(out + gs, g1, mask=gm)
        tl.store(out + G + gs, g2, mask=gm)

    @triton.jit
    def gn_apply_kernel(x_ptr, a_ptr, b_ptr, y_ptr, S, CN, ROWS,
                        ACT: tl.constexpr, BLOCK_S: tl.constexpr,
                        BLOCK_C: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        chunk = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < CN
        rows = tl.arange(0, BLOCK_S)
        A = tl.load(a_ptr + b * CN + cols, mask=cmask, other=0.0)
        Bv = tl.load(b_ptr + b * CN + cols, mask=cmask, other=0.0)
        base = b * S * CN
        row0 = chunk * ROWS
        for r in range(0, ROWS, BLOCK_S):
            rr = row0 + r + rows
            m = (rr < S)[:, None] & cmask[None, :]
            off = base + rr[:, None] * CN + cols[None, :]
            xv = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            y = xv * A[None, :] + Bv[None, :]
            if ACT:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=m)

    _TRITON.update(stats=gn_stats_kernel, apply=gn_apply_kernel,
                   next_pow2=triton.next_power_of_2)
    return _TRITON


def _grid(B: int, S: int, CN: int, next_pow2):
    """(BLOCK_S, BLOCK_C, rows per program, chunks): a 4096-element tile and
    enough (b, chunk) programs for a few waves over the SMs."""
    block_c = next_pow2(CN)
    block_s = max(1, min(next_pow2(S), 4096 // block_c))
    want = max(1, -(-_TARGET_PROGRAMS // B))
    rows = -(-S // want)
    rows = -(-rows // block_s) * block_s
    return block_s, block_c, rows, -(-S // rows)


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x dtype {x.dtype} not in {_DTYPES}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be channels_last contiguous")


def _check_no_grad(name: str, *ts) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts):
        raise RuntimeError(f"{name}: the kernel is forward-only; run under "
                           "torch.no_grad() or torch.inference_mode()")


def gn_stats_reference(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain version of `gn_stats`: per-(b, group) sums of x and x^2 in fp32,
    as one chunk (B, 1, 2, G)."""
    B, CN = x.shape[:2]
    xf = x.float()
    s1 = xf.sum((2, 3)).view(B, num_groups, -1).sum(-1)
    s2 = (xf * xf).sum((2, 3)).view(B, num_groups, -1).sum(-1)
    return torch.stack([s1, s2], dim=1)[:, None]


def gn_stats(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-(b, chunk, group) partial sums (B, chunks, 2, G) of x and x^2 over
    (B, C*N, H, W) channels_last; the groups split C*N into equal contiguous
    runs, which is the channel-major frame fold's rule."""
    _check_x(x, "gn_stats")
    B, CN, H, W = x.shape
    if CN % num_groups:
        raise ValueError(f"gn_stats: {CN} channels do not split into {num_groups} groups")
    if not use_kernel(x):
        return gn_stats_reference(x, num_groups)
    _check_no_grad("gn_stats", x)
    k = _kernels()
    S = H * W
    block_s, block_c, rows, chunks = _grid(B, S, CN, k["next_pow2"])
    out = torch.empty((B, chunks, 2, num_groups), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        k["stats"][(B, chunks)](
            x, out, S, CN, num_groups, CN // num_groups, rows,
            BLOCK_S=block_s, BLOCK_C=block_c,
            BLOCK_G=k["next_pow2"](num_groups), num_warps=4)
    count_launch("gn_stats")
    return out


def gn_apply_reference(x: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
                       act: bool) -> torch.Tensor:
    """Plain version of `gn_apply`."""
    y = x.float() * A[:, :, None, None] + Bc[:, :, None, None]
    if act:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype)


def gn_apply(x: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor, act: bool) -> torch.Tensor:
    """y = x*A[b,c] + B[b,c] (+SiLU) in fp32, stored in x's dtype and layout;
    A and B are fp32 (B, C*N)."""
    _check_x(x, "gn_apply")
    B, CN, H, W = x.shape
    for name, t in (("A", A), ("B", Bc)):
        if t.shape != (B, CN) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"gn_apply: {name} must be contiguous fp32 {(B, CN)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"gn_apply: {name} on {t.device}, x on {x.device}")
    if not use_kernel(x):
        return gn_apply_reference(x, A, Bc, act)
    _check_no_grad("gn_apply", x, A, Bc)
    k = _kernels()
    S = H * W
    block_s, block_c, rows, chunks = _grid(B, S, CN, k["next_pow2"])
    y = torch.empty_like(x, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        k["apply"][(B, chunks)](
            x, A, Bc, y, S, CN, rows, ACT=bool(act),
            BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4)
    count_launch("gn_apply")
    return y


def fold_stats(part: torch.Tensor, n_per_group: int, CN: int, *, eps: float,
               gamma=None, beta=None, scale=None, shift=None, frames_last: int = 1):
    """Combine partial sums (B, chunks, 2, G) into the per-(b, channel) fp32
    A, B of y = A*x + B: normalize, then gamma/beta, then AdaGN (1+scale,
    shift)."""
    s = part.sum(1)
    mean_g = s[:, 0] / n_per_group
    var_g = s[:, 1] / n_per_group - mean_g * mean_g
    rstd_g = torch.rsqrt(var_g + eps)
    rep = CN // part.shape[-1]
    A = rstd_g.repeat_interleave(rep, dim=1)
    Bc = (-mean_g * rstd_g).repeat_interleave(rep, dim=1)
    if gamma is not None:
        g = gamma.float().repeat_interleave(frames_last)
        A = A * g
        Bc = Bc * g + beta.float().repeat_interleave(frames_last)
    if scale is not None:
        e = 1.0 + scale.float()
        A = A * e
        Bc = Bc * e + shift.float()
    return A, Bc


def group_norm(x: torch.Tensor, num_groups: int, *, eps: float, gamma=None, beta=None,
               scale=None, shift=None, frames_last: int = 1, act: bool = False):
    """GroupNorm(+affine gamma/beta (C,))(+AdaGN scale/shift (B, C*N))(+SiLU)
    over (B, C*N, H, W). CPU tensors take the plain version
    (`models.layers.group_norm_folded`); CUDA tensors take gn_stats, the
    combine and gn_apply."""
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
    _check_no_grad("group_norm", x, gamma, beta, scale, shift)
    part = gn_stats(x, num_groups)
    A, Bc = fold_stats(part, H * W * (CN // num_groups), CN, eps=eps, gamma=gamma,
                       beta=beta, scale=scale, shift=shift, frames_last=frames_last)
    return gn_apply(x, A, Bc, act)
