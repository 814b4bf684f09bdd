"""Softmax attention, `attention_fwd` and `attention_bwd`: CUDA C++ for sm_90a,
built with nvcc and bound with ctypes (`_build`), one kernel family
(`csrc/attention_wgmma.cuh`, instantiated by `attention_wgmma_bf16.cu`,
`attention_wgmma_f32.cu` and, for head dim 24, `attention_wgmma_d24.cu`):
every product on Hopper's warpgroup MMA (`wgmma`), the tiles brought by TMA
into a ring of shared memory by a producer warp, the consumer warpgroups'
accumulators in registers. Head dims 24, 64, 96, 128 and 192, in two forms
that `attention_plan` picks from (head dim, T):

  * "tiled", a 64-query tile of one sequence walking tiles of keys: head
    dims 64-192 at any T, and 24 at T > 64 (the 3D family's space attention
    over 16x16 tokens);
  * "packed", head dim 24 at T <= 64 (the 3D family's time attention over 7
    or 2 frames and its 4x4 space attention): a 64-row tile holds
    G = 64 // T whole sequences, every key outside a query's own sequence
    masked, on a persistent grid; its backward is one launch of five
    products.

Replaces `mcvd_tpu/ops/lab/attention.py`: `fused_attention` (Pallas body
`_kernel`, (BH, T, D)) and `fused_attention_packed` (`_packed_kernel`, the
packed (B, T, h*d) layout of the fused QKV projection). One kernel covers
both: it takes q, k and v with (batch, token) strides and puts head h at
column h*D, so it reads `AttnBlock`'s packed (B, T, 3C) qkv as it is and
writes (B, T, C); with one head it is the (BH, T, D) entry point.

Both forms compute the same function with the same rounding points. bf16
(fp32 accumulate): the forward walks tiles of 64 keys
(`TC_KEYS_PER_TILE`) and rounds the unnormalised p to bf16 before the PV
product, as the Pallas kernel rounds p to v's dtype, so it differs from the
plain version (p in fp32) by at most 2^-8 * sum_j p_j |v_j| / l per output
before the output rounding (`BF16_P_ROUNDOFF` times `abs_v_weights`;
`attention_tc_emulation` repeats its arithmetic on the CPU, and on a packed
tile under the block-diagonal mask gives each sequence the same bits). fp32
runs 3xTF32: each operand is split into two tf32 parts (hi rounded to nearest,
ties away, then lo the same) and a product takes three tf32 products, which
keeps ~21-22 bits of each (fp32-class, never plain TF32; `tf32_split` and
`tf32x3_matmul` emulate it). Scores and softmax are fp32 (online softmax
over key tiles). Other head dims raise on a CUDA tensor, and so do pointers
or strides that are not 16-byte aligned (the kernels copy 16-byte chunks;
TMA takes 16-byte strides). The T>2048 einsum fallback of the Pallas
version is not carried over: the kernels tile keys and have no length
limit. A tiled batch past the grid's 65,535 launches in runs; the packed
form's persistent grid takes any batch in one launch.

Gradients: when autograd needs them the entry points run through
`torch.autograd.Function`s. On the card the forward also writes each row's
logsumexp (fp32, natural log of the scaled scores), and the backward is
`attention_bwd`, the FlashAttention-2 backward of the JAX package's custom
VJPs `_fa_bwd` and `_packed_bwd`: p recomputed from the logsumexp tile by
tile, so no (T, T) block reaches device memory; no atomics, so two calls
on the same inputs give the same bits; d(qkv) comes back packed as qkv. The
tiled form takes two launches (dq, then dk and dv), the packed form one,
whose tile holds all its sequences' keys and queries. The dq launch takes
the row term rowsum(g * o) from the forward's output, and sums rowsum(p * dp) from its
own p and dp for the dk/dv launch (the JAX VJP's row term), whose scores
and dp repeat the dq launch's bit for bit: so each row of the ds that dk
sees sums to zero to fp32 rounding, as in the plain VJP, and an
exactly-zero gradient such as the key bias's stays at fp32 noise. bf16
rounds p and ds to bf16 as operands (`bf16_bwd_tolerances` bounds what that
moves; `attention_bwd_tc_emulation` repeats the arithmetic). On CPU
tensors, and under `reference_ops()`, both directions are the plain
versions (`attention_bwd_reference`, `attention_packed_bwd_reference`).
With no input needing a gradient the forward saves nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import count_launch, use_kernel

SUPPORTED_HEAD_DIMS = (24, 64, 96, 128, 192)
# The head dims whose short sequences (T <= TILE_ROWS) take the packed form.
PACKED_HEAD_DIMS = (24,)
TILE_ROWS = 64
_DTYPES = (torch.float32, torch.bfloat16)
TC_KEYS_PER_TILE = 64
# bf16's unit roundoff: rounding p to bf16 moves sum_j p_j v_j / l by at
# most 2^-8 * sum_j p_j |v_j| / l (l sums the unrounded p).
BF16_P_ROUNDOFF = 2.0 ** -8
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# The bf16 kernels' fp32 values against their emulations' (which take each
# product and row sum in fp64 and round it once): a depth-n sum or dot
# product of the kernel within n * U32 of the sum of its terms' magnitudes
# (U32 = 2^-23, a whole ulp a term: the tensor cores' fp32 accumulation may
# truncate), a product, scaling or difference of the two within U32 of its
# magnitude, and exp2 (CUDA's exp2f and torch's, 2 ulp each) within
# EXP2_REL of its value.
U32 = 2.0 ** -23
EXP2_REL = 2.0 ** -21


def attention_reference(q, k, v, scale: float):
    """Plain version on (BH, T, D): softmax(q k^T * scale) v in fp32, cast
    back to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _mm64(a, b):
    """a @ b^T on (BH, T, n), taken in fp64 and rounded once to fp32."""
    return torch.matmul(a.double(), b.double().transpose(-1, -2)).float()


# The emulations take every product, row sum and exp2 of theirs in fp64 and
# round it once to fp32, and the rest in fp32 elementwise: so a row's values
# do not depend on the tensor around it (torch's fp32 sums and exp2 take
# other orders and paths at other widths), and a packed tile of sequences
# under the block-diagonal mask gives each sequence's bits.
def _mmn64(a, b):
    """a @ b, taken in fp64 and rounded once to fp32."""
    return torch.matmul(a.double(), b.double()).float()


def _rowsum64(x):
    return x.double().sum(-1, keepdim=True).float()


def _exp2_64(x):
    return torch.exp2(x.double()).float()


def _masked(x, mask, fill):
    """x where `mask` (broadcast; None: everywhere) allows, else `fill`."""
    return x if mask is None else x.masked_fill(~mask, fill)


def _tc_tiles(qf, kf, scale: float, mask=None):
    """The bf16 forward's softmax tile by tile, on fp32 (BH, T, D) q and k:
    for each tile of 64 keys, (n0, alpha, p, t, m) with t the scores scaled
    by scale*log2(e), m the running max after the tile, p = exp2(t - m) the
    values the kernel rounds to bf16, and alpha = exp2(m_before - m). A
    `mask` (bool, broadcast to (BH, T, T)) keeps the keys it allows; p is 0
    elsewhere."""
    BH, T, _ = qf.shape
    m = torch.full((BH, T, 1), float("-inf"), device=qf.device)
    for n0 in range(0, T, TC_KEYS_PER_TILE):
        keys = slice(n0, n0 + TC_KEYS_PER_TILE)
        mk = None if mask is None else mask[..., keys]
        t = _masked(_mm64(qf, kf[:, keys]) * (scale * _LOG2E), mk, float("-inf"))
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        yield n0, _exp2_64(m - m_new), _masked(_exp2_64(t - m_new), mk, 0.0), t, m_new
        m = m_new


def attention_tc_emulation(q, k, v, scale: float, want_lse: bool = False, mask=None):
    """The bf16 kernel's arithmetic in plain torch on (BH, T, D), for the
    tests: per tile of 64 keys, fp32 scores (each rounded once from fp64)
    scaled by scale*log2(e), a running max m and sum l of exp2(s - m) in
    fp32, p rounded to bf16 before the PV product (each product and sum of
    the emulation rounded once from fp64; the kernel's fp32 accumulation
    differs from it by its own rounding); o = acc / l rounded once. With
    `want_lse`, also the (BH, T) logsumexp the kernel writes,
    (m + log2 l) * ln 2. `mask` as in `_tc_tiles`."""
    qf, kf, vf = q.float(), k.float(), v.float()
    BH, T, D = q.shape
    l = torch.zeros(BH, T, 1, device=q.device)
    acc = torch.zeros(BH, T, D, device=q.device)
    for n0, alpha, p, _, m in _tc_tiles(qf, kf, scale, mask):
        l = l * alpha + _rowsum64(p)
        acc = acc * alpha + _mmn64(p.to(torch.bfloat16).float(),
                                   vf[:, n0:n0 + TC_KEYS_PER_TILE])
    o = (acc * (1.0 / l)).to(q.dtype)
    if want_lse:
        return o, ((m + torch.log2(l.double()).float()) * _LN2).squeeze(-1)
    return o


def _tc_bwd_terms(q, k, v, g, scale: float, o, lse, mask=None):
    """The bf16 backward kernels' fp32 terms on (BH, T, D), from the
    forward's output o and logsumexp lse (BH, T), each product and row sum
    taken in fp64 and rounded once: the scaled scores
    t = s * scale*log2(e) and p = exp2(t - lse*log2(e)), dp = g v^T, the dq
    launch's row term D = rowsum(g * o) and ds = p (dp - D), the dk/dv
    launch's D' = rowsum(p * dp) and ds' = p (dp - D'). p is 0 where `mask`
    (as in `_tc_tiles`) does not allow."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    D = (gf.double() * o.double()).sum(-1, keepdim=True).float()
    t = _mm64(qf, kf) * (scale * _LOG2E)
    p = _masked(_exp2_64(t - lse.float().reshape(D.shape) * _LOG2E), mask, 0.0)
    dp = _mm64(gf, vf)
    D1 = (p.double() * dp.double()).sum(-1, keepdim=True).float()
    return dict(t=t, p=p, dp=dp, D=D, ds=p * (dp - D), D1=D1, ds1=p * (dp - D1))


def attention_bwd_tc_emulation(q, k, v, g, scale: float, o=None, lse=None, mask=None):
    """The bf16 backward kernels' arithmetic in plain torch on (BH, T, D),
    for the tests: (dq, dk, dv) in q's dtype. From the forward's output o and
    logsumexp lse (by default `attention_tc_emulation`'s), the terms of
    `_tc_bwd_terms`: ds, ds' and p^T are rounded to bf16 as the operands of
    dq = ds k, dk = ds'^T q and dv = p^T g (each rounded once from fp64);
    dq and dk scaled; each gradient rounded once. `mask` as in
    `_tc_tiles`."""
    if o is None or lse is None:
        o, lse = attention_tc_emulation(q, k, v, scale, want_lse=True, mask=mask)
    f = _tc_bwd_terms(q, k, v, g, scale, o, lse, mask)

    def bf(t):
        return t.to(torch.bfloat16).float()

    dq = _mmn64(bf(f["ds"]), k.float()) * scale
    dk = _mmn64(bf(f["ds1"]).transpose(-1, -2), q.float()) * scale
    dv = _mmn64(bf(f["p"]).transpose(-1, -2), g.float())
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
    (lo*lo dropped); tf32 products are exact in fp32, each of the three
    sums is taken in fp64 and rounded once, and they add in fp32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return (_mmn64(al, bh) + _mmn64(ah, bl)) + _mmn64(ah, bh)


def _softmax64(s, mask=None):
    """softmax over the last axis in fp32 (exp and the row sum rounded once
    from fp64); 0 where `mask` does not allow."""
    s = _masked(s, mask, float("-inf"))
    e = torch.exp((s - s.amax(-1, keepdim=True)).double()).float()
    return _masked(e / _rowsum64(e), mask, 0.0)


def attention_tf32x3_emulation(q, k, v, scale: float, mask=None):
    """The fp32 forward's products as 3xTF32, in plain torch on (BH, T, D):
    s = q k^T and o = p v through `tf32x3_matmul`, softmax in fp32 over the
    keys `mask` (as in `_tc_tiles`) allows."""
    s = tf32x3_matmul(q, k.transpose(-1, -2)) * scale
    return tf32x3_matmul(_softmax64(s, mask), v)


def attention_bwd_tf32x3_emulation(q, k, v, g, scale: float, mask=None):
    """The plain VJP (`attention_bwd_reference`) with every product as
    3xTF32 (`tf32x3_matmul`): (dq, dk, dv) in fp32 on (BH, T, D), over the
    keys `mask` (as in `_tc_tiles`) allows."""
    s = tf32x3_matmul(q, k.transpose(-1, -2)) * scale
    p = _softmax64(s, mask)
    dv = tf32x3_matmul(p.transpose(-1, -2), g)
    dp = tf32x3_matmul(g, v.transpose(-1, -2))
    ds = p * (dp - _rowsum64(dp * p))
    return (tf32x3_matmul(ds, k) * scale, tf32x3_matmul(ds.transpose(-1, -2), q) * scale,
            dv)


def abs_v_weights(qkv, n_heads: int, scale: float):
    """sum_j p_j |v_j| / l per output of packed (B, T, 3C) qkv, in fp32: the
    plain version with |v| for v. Times `BF16_P_ROUNDOFF` it bounds what
    rounding p to bf16 moves that output."""
    C = qkv.shape[-1] // 3
    qkv = torch.cat([qkv[..., :2 * C], qkv[..., 2 * C:].abs()], dim=-1).float()
    return attention_packed_reference(qkv, n_heads, scale)


def bf16_flip(x, window):
    """The step between fp32 x's two bf16 neighbours (2^-7 to 2^-8 of |x|)
    where x lies within `window` (per element) of the midpoint between
    them, else 0: only there may a second computation of x, off by at most
    `window`, round to the other neighbour, and it then moves by that
    step."""
    bits = x.float().contiguous().view(torch.int32)
    mid = ((bits & -0x10000) | 0x8000).view(torch.float32)
    step = (bits & 0x7F800000).view(torch.float32) * 2.0 ** -7
    return torch.where((x - mid).abs() <= window, step, torch.zeros_like(step))


def _dot_err(a, b):
    """How far the kernel's fp32 a @ b^T on (BH, T, n) may lie from the
    emulation's (`_mm64`): n * U32 * |a| @ |b|^T."""
    return a.shape[-1] * U32 * torch.matmul(a.abs(), b.abs().transpose(-1, -2))


def _heads_f32(t, n_heads):
    """(B, T, h*d) -> (B*h, T, d) in fp32."""
    B, T, C = t.shape
    d = C // n_heads
    return t.float().reshape(B, T, n_heads, d).transpose(1, 2).reshape(B * n_heads, T, d)


def _packed(t, B):
    """(B*h, T, d) -> (B, T, h*d)."""
    BH, T, d = t.shape
    return t.reshape(B, BH // B, T, d).transpose(1, 2).reshape(B, T, BH // B * d)


def _fwd_flips(q, k, v, scale: float):
    """sum_j (step_j / p_j) P_j |v_j| per output on fp32 (BH, T, D), over
    the keys j whose p the emulation (`_tc_tiles`, the same computation on
    the same fp32 q and k, so the same bits) finds within reach of a bf16
    midpoint (`bf16_flip`; step_j the flip, P the softmax): the kernel's t
    lies within e = `_dot_err` * scale*log2(e) + 2 U32 |t| of the
    emulation's, its running max within the largest e of the keys seen that
    lie within twice the row's largest e of that max, t - m within
    U32 |t - m| more, so its p = exp2(t - m) within ln 2 times their sum
    plus EXP2_REL of p, relative; a p so far from every midpoint rounds as
    the emulation's, and one that flips moves the output by step_j / p_j
    of its share P_j v_j."""
    t_all = torch.matmul(q, k.transpose(-1, -2)) * (scale * _LOG2E)
    e = _dot_err(q, k) * (scale * _LOG2E) + 2 * U32 * t_all.abs()
    reach = 2 * e.amax(-1, keepdim=True)
    rel_flip = []
    for n0, _, p, t, m in _tc_tiles(q, k, scale):
        # the running max moves by at most the e of a key that may be the max
        seen = slice(0, n0 + TC_KEYS_PER_TILE)
        e_m = torch.where(t_all[..., seen] >= m - reach, e[..., seen],
                          torch.zeros_like(t)[..., :1]).amax(-1, keepdim=True)
        rel = _LN2 * (e[..., n0:n0 + TC_KEYS_PER_TILE] + e_m + U32 * (t - m).abs()) + EXP2_REL
        rel_flip.append(bf16_flip(p, rel * p) / p.clamp_min(torch.finfo(p.dtype).tiny))
    P = torch.softmax(t_all * _LN2, dim=-1)
    return torch.matmul(P * torch.cat(rel_flip, dim=-1), v.abs())


def bf16_tolerances(qkv, n_heads: int, scale: float) -> dict:
    """(atol per output, rtol) of the bf16 route on packed qkv, with
    w = `abs_v_weights`:
    - "plain", against the plain version (p in fp32): rounding p to bf16
      moves an output by at most 2^-8 * w before the last rounding (1% slack
      for the fp32 sums); both sides then round once: two bf16 steps
      relative;
    - "emulation", against `attention_tc_emulation`, the same arithmetic in
      torch: the fp32 sums differ in order only, so a p rounds to another
      bf16 value only that close to a rounding midpoint, by one step
      (2^-7 p). "emulation_no_flip", 2^-10 * w, lets an eighth of a row's
      weight do so: the bound of the long rows. "emulation" is the larger
      of that and the whole flip of every key whose p lies within reach of
      a midpoint (`_fwd_flips`, 1% slack) plus the fp32 sums' own spread
      (2 T U32 w): so it is the old bound wherever the flips stay under it,
      and only where they do not (at the 3D family's 7-key rows one such
      key may carry most of a row whose output cancels to near 0) the
      flips. rtol as for "plain": the output's one rounding step, plus one
      for a flipped p of a key that carries the row."""
    B, C = qkv.shape[0], qkv.shape[-1] // 3
    w = abs_v_weights(qkv, n_heads, scale)
    q, k, v = (_heads_f32(t, n_heads) for t in qkv.split(C, dim=-1))
    old = 2.0 ** -10 * w
    flips = _packed(1.01 * _fwd_flips(q, k, v, scale), B) + 2 * q.shape[1] * U32 * w
    return {"plain": (1.01 * BF16_P_ROUNDOFF * w, 1.6e-2),
            "emulation": (torch.maximum(old, flips), 1.6e-2),
            "emulation_no_flip": (old, 1.6e-2)}


def _bwd_flips(q, k, v, g, scale: float, o, lse):
    """(dq, dk, dv) flips on fp32 (BH, T, D), as `_fwd_flips` for the
    backward: with f the flips (`bf16_flip`) of the p, ds and ds' of
    `_tc_bwd_terms`, scale * sum_j f(ds_ij) |k_j| (dq), scale * sum_i
    f(ds'_ij) |q_i| (dk) and sum_i f(p_ij) |g_i| (dv). Reach: p = exp2(t - L)
    (L = lse*log2(e)) within
    rel = ln 2 (`_dot_err`(q, k) * scale*log2(e) + U32 (2 |t| + |t - L| + |L|))
    + EXP2_REL of itself; dp = g v^T within e_dp = `_dot_err`(g, v); D
    within e_D = D U32 sum |g||o|; D' within e_D' = sum_j (rel p |dp| +
    p e_dp) + T U32 sum_j p |dp|; ds = p (dp - D) within rel |ds| +
    p (e_dp + e_D + U32 |dp - D|) + U32 |ds|, and ds' alike."""
    f = _tc_bwd_terms(q, k, v, g, scale, o, lse)
    t, p, dp = f["t"], f["p"], f["dp"]
    L = lse.float().reshape(f["D"].shape) * _LOG2E
    rel = _LN2 * (_dot_err(q, k) * (scale * _LOG2E)
                  + U32 * (2 * t.abs() + (t - L).abs() + L.abs())) + EXP2_REL
    e_dp = _dot_err(g, v)
    e_D = q.shape[-1] * U32 * (g.abs() * o.float().abs()).sum(-1, keepdim=True)
    pdp = p * dp.abs()
    e_D1 = (rel * pdp + p * e_dp).sum(-1, keepdim=True) \
        + q.shape[1] * U32 * pdp.sum(-1, keepdim=True)

    def flips(ds, Dr, e_Dr):
        win = rel * ds.abs() + p * (e_dp + e_Dr + U32 * (dp - Dr).abs()) + U32 * ds.abs()
        return bf16_flip(ds, win)

    fq = flips(f["ds"], f["D"], e_D)
    fk = flips(f["ds1"], f["D1"], e_D1)
    fv = bf16_flip(p, rel * p)
    return (scale * torch.matmul(fq, k.abs()),
            scale * torch.matmul(fk.transpose(-1, -2), q.abs()),
            torch.matmul(fv.transpose(-1, -2), g.abs()))


def bf16_bwd_tolerances(qkv, g, n_heads: int, scale: float, o=None, lse=None) -> dict:
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
      packed output o and logsumexp lse (both by default
      `attention_tc_emulation`'s): the same arithmetic, the fp32 sums in
      another order, so a p or ds rounds to another bf16 value only that
      close to a rounding midpoint, by one step (2^-7 of it).
      "emulation_no_flip", half the rounding terms above (no D term), lets
      a quarter of a sum's weight do so: the bound of the long rows.
      "emulation" is the larger of that and the whole flip of each term
      within reach of a midpoint (`_bwd_flips`, 1% slack) plus the fp32
      sums' own spread over T terms (2 T U32 of the sums of magnitudes):
      the old bound wherever the flips stay under it. rtol as for
      "plain"."""
    B, C = qkv.shape[0], qkv.shape[-1] // 3

    def packed(*ts):
        return torch.cat([_packed(t, B) for t in ts], dim=-1)

    q, k, v = (_heads_f32(t, n_heads) for t in qkv.split(C, dim=-1))
    gf = _heads_f32(g, n_heads)
    if o is None or lse is None:
        of, lse = attention_tc_emulation(q, k, v, scale, want_lse=True)
    else:
        of = _heads_f32(o, n_heads)
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
    r = packed(r_dq, r_dk, r_dv)   # 2^-8 of the sums of magnitudes
    old = 0.5 * r
    flips = packed(*(1.01 * t for t in _bwd_flips(q, k, v, gf, scale, of,
                                                   lse.reshape(q.shape[:2]))))
    flips = flips + 2 * q.shape[1] * U32 / u * r
    return {"plain": (1.01 * packed(r_dq + d_dq, r_dk, r_dv), 1.6e-2),
            "emulation": (torch.maximum(old, flips), 1.6e-2),
            "emulation_no_flip": (old, 1.6e-2)}


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
    fn = _entry(lib, "fwd", q.dtype, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, H, T, D, *q_strides, *kv_strides, *o_strides, float(scale), stream)
    check_launch(lib, "attention_fwd", err)
    count_launch("attention_fwd")


def _launch_bwd(q, k, v, o, do, lse, dq, dk, dv, B, H, T, D, qkv_strides, o_strides,
                scale):
    """`attention_bwd`: tiled, two launches, dq (which writes the row sums
    rowsum(p * dp) that the second launch takes), then dk and dv, on one
    (B, H, T) fp32 scratch for those sums; packed, one launch that sums
    them itself (the scratch goes unused)."""
    from ._build import check_launch, load_library

    _check_aligned("attention_bwd", (q, k, v, o, do, dq, dk, dv), (*qkv_strides, *o_strides),
                   q.element_size())
    lib = load_library()
    fn = _entry(lib, "bwd", q.dtype, D)
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
                         f"(supported: {SUPPORTED_HEAD_DIMS}, each instantiated from "
                         f"csrc/attention_wgmma.cuh: 24 in attention_wgmma_d24.cu)")


def attention_route(dtype, head_dim: int) -> str:
    """The kernels an attention call on the card takes, from its dtype and
    head dim: "wgmma" for every supported head dim (24, 64, 96, 128, 192)
    and both dtypes, the one family of `csrc/attention_wgmma.cuh`. Raises
    for a dtype or head dim it does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"attention: dtype {dtype} not in {_DTYPES}")
    _check_head_dim("attention", head_dim)
    return "wgmma"


class AttentionPlan(NamedTuple):
    form: str            # "tiled" or "packed"
    seqs_per_tile: int   # G: whole sequences in a 64-row tile (1 when tiled)
    tiles: int           # 64-row tiles of the call


def attention_plan(dtype, head_dim: int, T: int, B: int, H: int = 1) -> AttentionPlan:
    """The form of a call over B sequences of T tokens and H heads, as the
    kernels' `plan_of` (`csrc/attention_wgmma.cuh`) picks it: "packed" for
    head dims in PACKED_HEAD_DIMS at T <= 64, G = 64 // T whole sequences of
    a head a tile and H * ceil(B / G) tiles; else "tiled", a 64-query tile
    of one sequence, H * B * ceil(T / 64) tiles. Raises as
    `attention_route`."""
    attention_route(dtype, head_dim)
    if head_dim in PACKED_HEAD_DIMS and T <= TILE_ROWS:
        G = TILE_ROWS // T
        return AttentionPlan("packed", G, H * -(-B // G))
    return AttentionPlan("tiled", 1, H * B * -(-T // TILE_ROWS))


def kernel_plan(head_dim: int, T: int, B: int, H: int = 1) -> AttentionPlan:
    """`plan_of` as the built library takes it (the C entry
    `attention_plan_wgmma`), so that a check on the card can hold
    `attention_plan` to it. Needs nvcc (the library is built at first
    use)."""
    import ctypes

    from ._build import load_library

    seqs, tiles = ctypes.c_int(), ctypes.c_int64()
    packed = load_library().attention_plan_wgmma(head_dim, T, B, H, ctypes.byref(seqs),
                                                 ctypes.byref(tiles))
    return AttentionPlan("packed" if packed else "tiled", seqs.value, tiles.value)


def _entry(lib, direction, dtype, head_dim):
    """The C entry point of a direction ("fwd", "bwd") for (dtype,
    head_dim): the one family's, by dtype."""
    attention_route(dtype, head_dim)
    suffix = "f32" if dtype == torch.float32 else "bf16"
    return getattr(lib, f"attention_{direction}_wgmma_{suffix}")


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
