"""Softmax attention forward, `attention_fwd`: CUDA C++ for sm_90a
(`csrc/attention.cu`), built with nvcc and bound with ctypes (`_build`).

Replaces `mcvd_tpu/ops/lab/attention.py`: `fused_attention` (Pallas body
`_kernel`, (BH, T, D)) and `fused_attention_packed` (`_packed_kernel`, the
packed (B, T, h*d) layout of the fused QKV projection). One kernel covers
both: it takes q, k and v as pointers with (batch, token) strides and puts
head h at column h*D, so it reads `AttnBlock`'s packed (B, T, 3C) qkv as it
is and writes (B, T, C); with one head it is the (BH, T, D) entry point.

Scores and softmax are fp32 (online softmax over key tiles); p stays fp32 for
the PV product. D=64 only; other head dims raise. Forward only: the backward
(`_fa_bwd`, `_packed_bwd`) comes with training. The T>2048 einsum fallback of
the Pallas version is not carried over: the kernel tiles keys and has no
length limit.
"""

from __future__ import annotations

import torch

from . import count_launch, use_kernel

SUPPORTED_HEAD_DIMS = (64,)
_DTYPES = (torch.float32, torch.bfloat16)


def attention_reference(q, k, v, scale: float):
    """Plain version on (BH, T, D): softmax(q k^T * scale) v in fp32, cast
    back to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def attention_packed_reference(qkv, n_heads: int, scale: float):
    """Plain version on packed (B, T, 3C) qkv -> (B, T, C), C = n_heads*d."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    d = C // n_heads
    q, k, v = (t.reshape(B, T, n_heads, d).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    o = attention_reference(q, k, v, scale)
    return o.transpose(1, 2).reshape(B, T, C)


def _launch(q, k, v, o, B, H, T, D, q_strides, kv_strides, o_strides, scale):
    from ._build import check_launch, load_library

    lib = load_library()
    fn = lib.attention_fwd_f32 if q.dtype == torch.float32 else lib.attention_fwd_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, T, D, *q_strides, *kv_strides, *o_strides,
                 float(scale), stream)
    check_launch(lib, "attention_fwd", err)
    count_launch("attention_fwd")


def _check(name, ts):
    t0 = ts[0]
    for t in ts:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not in {_DTYPES}")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"{name}: inputs differ in dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name}: the kernel is forward-only; run under "
                           "torch.no_grad() or torch.inference_mode()")


def _check_head_dim(name, d):
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported by the kernel "
                         f"(supported: {SUPPORTED_HEAD_DIMS})")


def attention(q, k, v, scale: float):
    """(BH, T, D) -> (BH, T, D): the `fused_attention` entry point."""
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention: q, k, v must share one (BH, T, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not use_kernel(q):
        return attention_reference(q, k, v, scale)
    _check("attention", (q, k, v))
    BH, T, D = q.shape
    _check_head_dim("attention", D)
    o = torch.empty_like(q)
    _launch(q, k, v, o, BH, 1, T, D, (T * D, D), (T * D, D), (T * D, D), scale)
    return o


def attention_packed(qkv, n_heads: int, scale: float):
    """Packed (B, T, 3C) qkv, as the fused QKV projection lays it out, ->
    (B, T, C); head h of q, k, v is columns h*d, C + h*d, 2C + h*d."""
    if qkv.ndim != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % n_heads:
        raise ValueError(f"attention_packed: qkv {tuple(qkv.shape)} is not "
                         f"(B, T, 3C) with C divisible by {n_heads} heads")
    if not use_kernel(qkv):
        return attention_packed_reference(qkv, n_heads, scale)
    _check("attention_packed", (qkv,))
    B, T, C3 = qkv.shape
    C = C3 // 3
    _check_head_dim("attention_packed", C // n_heads)
    o = torch.empty((B, T, C), device=qkv.device, dtype=qkv.dtype)
    k = qkv[..., C:]
    v = qkv[..., 2 * C:]
    _launch(qkv, k, v, o, B, n_heads, T, C // n_heads, (T * C3, C3), (T * C3, C3),
            (T * C, C), scale)
    return o
