"""Softmax attention, `attention_fwd` and `attention_bwd`: CUDA C++ for sm_90a
(`csrc/attention.cu`), built with nvcc and bound with ctypes (`_build`).

Replaces `mcvd_tpu/ops/lab/attention.py`: `fused_attention` (Pallas body
`_kernel`, (BH, T, D)) and `fused_attention_packed` (`_packed_kernel`, the
packed (B, T, h*d) layout of the fused QKV projection). One kernel covers
both: it takes q, k and v as pointers with (batch, token) strides and puts
head h at column h*D, so it reads `AttnBlock`'s packed (B, T, 3C) qkv as it
is and writes (B, T, C); with one head it is the (BH, T, D) entry point.

Both directions run on the tensor cores (`mma.sync`), one kernel body per
dtype. bf16 (m16n8k16, fp32 accumulate): the forward rounds the
unnormalised p to bf16 before the PV product, as the Pallas kernel rounds p
to v's dtype, so it differs from the plain version (p in fp32) by at most
2^-8 * sum_j p_j |v_j| / l per output before the output rounding
(`BF16_P_ROUNDOFF` times `abs_v_weights`; `attention_tc_emulation` repeats
its arithmetic on the CPU). fp32 (m16n8k8) runs 3xTF32: each operand is
split into two tf32 parts and a product takes three tf32 products, which
keeps ~21-22 bits of each (fp32-class, not TF32; `tf32_split` and
`tf32x3_matmul` emulate it). Scores and softmax are fp32 on both (online
softmax over key tiles). Head dims 64, 96 and 128 (`SUPPORTED_HEAD_DIMS`,
one instantiation of each kernel per dim); other head dims raise on a CUDA
tensor, and so do pointers or strides that are not 16-byte aligned (the
kernels copy 16-byte chunks). The T>2048 einsum fallback of the Pallas
version is not carried over: the kernel tiles keys and has no length
limit.

Gradients: when autograd needs them the entry points run through
`torch.autograd.Function`s. On the card the forward also writes each row's
logsumexp (fp32, natural log of the scaled scores), and the backward is
`attention_bwd` (`csrc/attention.cu`), the FlashAttention-2 backward of the
JAX package's custom VJPs `_fa_bwd` and `_packed_bwd`: p recomputed from the
logsumexp tile by tile, so no (T, T) block reaches device memory; two
launches with no atomics (dq, then dk and dv), so two calls on the same
inputs give the same bits; d(qkv) comes back packed as qkv. The dq launch
takes the row term rowsum(g * o) from the forward's output, and sums
rowsum(p * dp) from its own p and dp for the dk/dv launch (the JAX VJP's row
term), whose products repeat the dq launch's bit for bit: so each row of
the ds that dk sees sums to zero to fp32 rounding, as in the plain VJP, and
an exactly-zero gradient such as the key bias's stays at fp32 noise. bf16
rounds p and ds to bf16 as operands (`bf16_bwd_tolerances` bounds what
that moves; `attention_bwd_tc_emulation` repeats the arithmetic). On CPU tensors, and
under `reference_ops()`, both directions are the plain versions
(`attention_bwd_reference`, `attention_packed_bwd_reference`). With no
input needing a gradient the forward saves nothing.
"""

from __future__ import annotations

import torch

from . import count_launch, use_kernel

SUPPORTED_HEAD_DIMS = (64, 96, 128)
_DTYPES = (torch.float32, torch.bfloat16)
TC_KEYS_PER_TILE = 64
# bf16's unit roundoff: rounding p to bf16 moves sum_j p_j v_j / l by at
# most 2^-8 * sum_j p_j |v_j| / l (l sums the unrounded p).
BF16_P_ROUNDOFF = 2.0 ** -8


def attention_reference(q, k, v, scale: float):
    """Plain version on (BH, T, D): softmax(q k^T * scale) v in fp32, cast
    back to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def attention_tc_emulation(q, k, v, scale: float, want_lse: bool = False):
    """The bf16 kernel's arithmetic in plain torch on (BH, T, D), for the
    tests: per tile of 64 keys, fp32 scores scaled by scale*log2(e), a
    running max m and sum l of exp2(s - m) in fp32, p rounded to bf16 before
    the PV product with fp32 accumulation; o = acc / l rounded once. With
    `want_lse`, also the (BH, T) logsumexp the kernel writes,
    (m + log2 l) * ln 2."""
    log2e = 1.4426950408889634
    qf, kf, vf = q.float(), k.float(), v.float()
    BH, T, D = q.shape
    m = torch.full((BH, T, 1), float("-inf"), device=q.device)
    l = torch.zeros(BH, T, 1, device=q.device)
    acc = torch.zeros(BH, T, D, device=q.device)
    for n0 in range(0, T, TC_KEYS_PER_TILE):
        s = torch.matmul(qf, kf[:, n0:n0 + TC_KEYS_PER_TILE].transpose(-1, -2))
        s = s * (scale * log2e)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                         vf[:, n0:n0 + TC_KEYS_PER_TILE])
        m = m_new
    o = (acc * (1.0 / l)).to(q.dtype)
    if want_lse:
        return o, ((m + torch.log2(l)) * 0.6931471805599453).squeeze(-1)
    return o


def attention_bwd_tc_emulation(q, k, v, g, scale: float, o=None, lse=None):
    """The bf16 backward kernels' arithmetic in plain torch on (BH, T, D),
    for the tests: (dq, dk, dv) in q's dtype. From the forward's output o and
    logsumexp lse (by default `attention_tc_emulation`'s):
    p = exp2(s * scale*log2(e) - lse*log2(e)) and dp = g v^T in fp32; the dq
    launch takes the row term D = rowsum(g * o), the dk/dv launch the one the
    dq launch sums from its own p and dp, D' = rowsum(p * dp); ds = p (dp - D)
    and ds' = p (dp - D') and p^T are rounded to bf16 as the operands of
    dq = ds k, dk = ds'^T q and dv = p^T g (fp32 accumulation); dq and dk
    scaled; each gradient rounded once."""
    log2e = 1.4426950408889634
    if o is None or lse is None:
        o, lse = attention_tc_emulation(q, k, v, scale, want_lse=True)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    D = (gf * o.float()).sum(-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp2(s * (scale * log2e) - lse.float().reshape(D.shape) * log2e)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    D1 = (p * dp).sum(-1, keepdim=True)

    def bf(t):
        return t.to(torch.bfloat16).float()

    dq = torch.matmul(bf(p * (dp - D)), kf) * scale
    dk = torch.matmul(bf(p * (dp - D1)).transpose(-1, -2), qf) * scale
    dv = torch.matmul(bf(p).transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def tf32_split(x):
    """(hi, lo) of fp32 x as the fp32 kernels split it: hi = x rounded to
    tf32 (10 stored mantissa bits, ties away from zero, `cvt.rna.tf32.f32`),
    lo = (x - hi) rounded the same way; hi + lo is x to within 2^-22
    relative."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def tf32x3_matmul(a, b):
    """a @ b as the fp32 kernels' 3xTF32 products compute it: both operands
    split by `tf32_split`, lo*hi + hi*lo accumulated first, then hi*hi
    (lo*lo dropped); tf32 products are exact in fp32, the sums are fp32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def attention_tf32x3_emulation(q, k, v, scale: float):
    """The fp32 forward's products as 3xTF32, in plain torch on (BH, T, D):
    s = q k^T and o = p v through `tf32x3_matmul`, softmax in fp32."""
    s = tf32x3_matmul(q, k.transpose(-1, -2)) * scale
    return tf32x3_matmul(torch.softmax(s, dim=-1), v)


def attention_bwd_tf32x3_emulation(q, k, v, g, scale: float):
    """The plain VJP (`attention_bwd_reference`) with every product as
    3xTF32 (`tf32x3_matmul`): (dq, dk, dv) in fp32 on (BH, T, D)."""
    s = tf32x3_matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    dv = tf32x3_matmul(p.transpose(-1, -2), g)
    dp = tf32x3_matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return (tf32x3_matmul(ds, k) * scale, tf32x3_matmul(ds.transpose(-1, -2), q) * scale,
            dv)


def abs_v_weights(qkv, n_heads: int, scale: float):
    """sum_j p_j |v_j| / l per output of packed (B, T, 3C) qkv, in fp32: the
    plain version with |v| for v. Times `BF16_P_ROUNDOFF` it bounds what
    rounding p to bf16 moves that output."""
    C = qkv.shape[-1] // 3
    qkv = torch.cat([qkv[..., :2 * C], qkv[..., 2 * C:].abs()], dim=-1).float()
    return attention_packed_reference(qkv, n_heads, scale)


def bf16_tolerances(qkv, n_heads: int, scale: float) -> dict:
    """(atol per output, rtol) of the bf16 route on packed qkv, with
    w = `abs_v_weights`:
    - "plain", against the plain version (p in fp32): rounding p to bf16
      moves an output by at most 2^-8 * w before the last rounding (1% slack
      for the fp32 sums); both sides then round once: two bf16 steps
      relative;
    - "emulation", against `attention_tc_emulation`, the same arithmetic in
      torch: the fp32 scores differ in summation order only (~1e-6
      relative), so a p rounds to another bf16 value only that close to a
      rounding midpoint (under 0.1% of them), by one step (2^-7 p); 2^-10 * w
      lets an eighth of a row's weight do so. rtol as for "plain": the
      output's one rounding step, plus one for a flipped p of a key that
      carries the row."""
    w = abs_v_weights(qkv, n_heads, scale)
    return {"plain": (1.01 * BF16_P_ROUNDOFF * w, 1.6e-2),
            "emulation": (2.0 ** -10 * w, 1.6e-2)}


def bf16_bwd_tolerances(qkv, g, n_heads: int, scale: float) -> dict:
    """(atol per element of d(qkv), packed as qkv; rtol) of the bf16
    backward on packed qkv and output gradient g, from the fp32 plain VJP's
    p, ds, o and |q|, |k|, |g| (all per (batch, head)):
    - "plain", against the plain VJP (p and ds in fp32, D from the exact o):
      rounding p^T to bf16 moves dv_j by at most 2^-8 * sum_i p_ij |g_i|;
      rounding ds moves dk_j by 2^-8 * scale * sum_i |ds_ij| |q_i| and dq_i
      by 2^-8 * scale * sum_j |ds_ij| |k_j|. dq's row term D = rowsum(g * o)
      is taken from the forward's bf16 output, which is off by at most
      e_o = 2^-8 * (sum_j p_j |v_j| + |o|) (`bf16_tolerances`), so D_i moves
      by e_D_i = sum |g_i| e_o_i and ds_ij by p_ij e_D_i: dq_i by
      scale * e_D_i * sum_j p_ij |k_j|; dk's row term is rowsum(p * dp) in
      fp32, as the plain VJP's. 1% slack for the fp32 sums; both sides then
      round once: two bf16 steps relative.
    - "emulation", against `attention_bwd_tc_emulation` on the kernel's own
      o and lse: the same arithmetic, the fp32 sums in another order
      (~1e-6 relative), so a p or ds rounds to another bf16 value only that
      close to a rounding midpoint, by one step (2^-7 of it); half the
      rounding terms above (no D term) let a quarter of a sum's weight do
      so. rtol as for "plain"."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    d = C // n_heads

    def heads(t):
        return t.float().reshape(B, T, n_heads, d).transpose(1, 2)

    def packed(*ts):
        return torch.cat([t.transpose(1, 2).reshape(B, T, C) for t in ts], dim=-1)

    q, k, v = (heads(t) for t in qkv.split(C, dim=-1))
    gf = heads(g)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(gf, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).abs()
    aq, ak = q.abs(), k.abs()
    u = BF16_P_ROUNDOFF
    r_dq = u * scale * torch.matmul(ds, ak)
    r_dk = u * scale * torch.matmul(ds.transpose(-1, -2), aq)
    r_dv = u * torch.matmul(p.transpose(-1, -2), gf.abs())
    e_o = u * (torch.matmul(p, v.abs()) + torch.matmul(p, v).abs())
    e_D = (gf.abs() * e_o).sum(dim=-1, keepdim=True)
    d_dq = scale * e_D * torch.matmul(p, ak)
    return {"plain": (1.01 * packed(r_dq + d_dq, r_dk, r_dv), 1.6e-2),
            "emulation": (0.5 * packed(r_dq, r_dk, r_dv), 1.6e-2)}


def attention_packed_reference(qkv, n_heads: int, scale: float):
    """Plain version on packed (B, T, 3C) qkv -> (B, T, C), C = n_heads*d."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    d = C // n_heads
    q, k, v = (t.reshape(B, T, n_heads, d).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    o = attention_reference(q, k, v, scale)
    return o.transpose(1, 2).reshape(B, T, C)


def attention_bwd_reference(q, k, v, g, scale: float):
    """The plain VJP on (BH, T, D): (dq, dk, dv) in q's dtype, computed in
    fp32 as the JAX package's `_fa_bwd` (`attention.py:78`): p recomputed,
    ds = p * (dp - rowsum(dp * p)), `scale` on dq and dk."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_packed_bwd_reference(qkv, g, n_heads: int, scale: float):
    """The plain VJP on packed (B, T, 3C) qkv and g (B, T, C): d(qkv) packed
    as qkv, as the JAX package's `_packed_bwd` (`attention.py:187`)."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    d = C // n_heads

    def heads(t):
        return t.reshape(B, T, n_heads, d).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(C, dim=-1))
    grads = attention_bwd_reference(q, k, v, heads(g), scale)
    return torch.cat([t.transpose(1, 2).reshape(B, T, C) for t in grads], dim=-1)


def _check_aligned(name, ts, strides, itemsize):
    """The kernels copy 16-byte chunks: every pointer 16-byte aligned and
    every (batch, token) stride a multiple of 16 bytes."""
    if any(t.data_ptr() % 16 for t in ts) or any(s * itemsize % 16 for s in strides):
        raise ValueError(f"{name}: the kernel takes 16-byte aligned rows (pointers and "
                         f"strides), got an unaligned input")


def _launch(q, k, v, o, lse, B, H, T, D, q_strides, kv_strides, o_strides, scale):
    from ._build import check_launch, load_library

    _check_aligned("attention", (q, k, v, o), (*q_strides, *kv_strides, *o_strides),
                   q.element_size())

    lib = load_library()
    fn = lib.attention_fwd_f32 if q.dtype == torch.float32 else lib.attention_fwd_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, H, T, D, *q_strides, *kv_strides, *o_strides, float(scale), stream)
    check_launch(lib, "attention_fwd", err)
    count_launch("attention_fwd")


def _launch_bwd(q, k, v, o, do, lse, dq, dk, dv, B, H, T, D, qkv_strides, o_strides,
                scale):
    """`attention_bwd`: two launches, dq (which writes the row sums
    rowsum(p * dp) that the second launch takes), then dk and dv, on one
    (B, H, T) fp32 scratch for those sums."""
    from ._build import check_launch, load_library

    _check_aligned("attention_bwd", (q, k, v, o, do, dq, dk, dv), (*qkv_strides, *o_strides),
                   q.element_size())
    lib = load_library()
    fn = lib.attention_bwd_f32 if q.dtype == torch.float32 else lib.attention_bwd_bf16
    delta = torch.empty(B, H, T, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), B, H, T, D, *qkv_strides, *o_strides, float(scale),
                 stream)
    check_launch(lib, "attention_bwd", err)
    count_launch("attention_bwd")


def _check(name, ts):
    t0 = ts[0]
    for t in ts:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not in {_DTYPES}")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"{name}: inputs differ in dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_head_dim(name, d):
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported by the kernel "
                         f"(supported: {SUPPORTED_HEAD_DIMS}; other head dims are ROADMAP "
                         f"Queue 3 F1, D=192 with SPADE, Queue 1 item 13)")


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _fwd(q, k, v, scale, want_lse):
    """(o, lse) on (BH, T, D): `attention_fwd`, with the (BH, 1, T) fp32
    logsumexp when `want_lse`."""
    _check("attention", (q, k, v))
    BH, T, D = q.shape
    _check_head_dim("attention", D)
    o = torch.empty_like(q)
    lse = torch.empty(BH, 1, T, device=q.device) if want_lse else None
    _launch(q, k, v, o, lse, BH, 1, T, D, (T * D, D), (T * D, D), (T * D, D), scale)
    return o, lse


def attention_packed_fwd(qkv, n_heads, scale, want_lse):
    """(o, lse) on packed qkv: `attention_fwd` on CUDA tensors, with the
    (B, h, T) fp32 logsumexp for `attention_packed_bwd` when `want_lse`."""
    _check("attention_packed", (qkv,))
    B, T, C3 = qkv.shape
    C = C3 // 3
    _check_head_dim("attention_packed", C // n_heads)
    o = torch.empty((B, T, C), device=qkv.device, dtype=qkv.dtype)
    lse = torch.empty(B, n_heads, T, device=qkv.device) if want_lse else None
    _launch(qkv, qkv[..., C:], qkv[..., 2 * C:], o, lse, B, n_heads, T, C // n_heads,
            (T * C3, C3), (T * C3, C3), (T * C, C), scale)
    return o, lse


class _Attention(torch.autograd.Function):
    """attention on (BH, T, D) with its VJP; the forward's route (kernel or
    plain) is kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        kernel = use_kernel(q)
        o, lse = _fwd(q, k, v, scale, True) if kernel else (
            attention_reference(q, k, v, scale), None)
        ctx.save_for_backward(q, k, v, o if kernel else None, lse)
        ctx.cfg = (scale, kernel)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        scale, kernel = ctx.cfg
        if not kernel:
            return (*attention_bwd_reference(q, k, v, g, scale), None)
        BH, T, D = q.shape
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        _launch_bwd(q, k, v, o, g, lse, dq, dk, dv, BH, 1, T, D, (T * D, D), (T * D, D),
                    scale)
        return dq, dk, dv, None


class _AttentionPacked(torch.autograd.Function):
    """attention_packed with its VJP, d(qkv) in the packed layout; the
    forward's route (kernel or plain) is kept for the backward."""

    @staticmethod
    def forward(ctx, qkv, n_heads, scale):
        kernel = use_kernel(qkv)
        o, lse = attention_packed_fwd(qkv, n_heads, scale, True) if kernel else (
            attention_packed_reference(qkv, n_heads, scale), None)
        ctx.save_for_backward(qkv, o if kernel else None, lse)
        ctx.cfg = (n_heads, scale, kernel)
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, o, lse = ctx.saved_tensors
        n_heads, scale, kernel = ctx.cfg
        if not kernel:
            return attention_packed_bwd_reference(qkv, g, n_heads, scale), None, None
        return attention_packed_bwd(qkv, o, lse, g, n_heads, scale), None, None


def attention_packed_bwd(qkv, o, lse, g, n_heads: int, scale: float):
    """`attention_bwd` on CUDA tensors: d(qkv), packed as qkv, from the
    forward's output o and logsumexp lse (`attention_packed_fwd`) and the
    output's gradient g (B, T, C)."""
    if not qkv.is_cuda or lse is None:
        raise ValueError("attention_packed_bwd: the kernel takes CUDA tensors and the "
                         "forward's lse (the plain VJP is attention_packed_bwd_reference)")
    B, T, C3 = qkv.shape
    C = C3 // 3
    g = g.to(qkv.dtype).contiguous()
    dqkv = torch.empty_like(qkv)
    _launch_bwd(qkv, qkv[..., C:], qkv[..., 2 * C:], o, g, lse, dqkv, dqkv[..., C:],
                dqkv[..., 2 * C:], B, n_heads, T, C // n_heads, (T * C3, C3), (T * C, C),
                scale)
    return dqkv


def attention(q, k, v, scale: float):
    """(BH, T, D) -> (BH, T, D): the `fused_attention` entry point;
    differentiable in q, k and v."""
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention: q, k, v must share one (BH, T, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, scale)
    if not use_kernel(q):
        return attention_reference(q, k, v, scale)
    return _fwd(q, k, v, scale, False)[0]


def attention_packed(qkv, n_heads: int, scale: float):
    """Packed (B, T, 3C) qkv, as the fused QKV projection lays it out, ->
    (B, T, C); head h of q, k, v is columns h*d, C + h*d, 2C + h*d.
    Differentiable in qkv."""
    if qkv.ndim != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % n_heads:
        raise ValueError(f"attention_packed: qkv {tuple(qkv.shape)} is not "
                         f"(B, T, 3C) with C divisible by {n_heads} heads")
    if _needs_grad(qkv):
        return _AttentionPacked.apply(qkv, n_heads, scale)
    if not use_kernel(qkv):
        return attention_packed_reference(qkv, n_heads, scale)
    return attention_packed_fwd(qkv, n_heads, scale, False)[0]
