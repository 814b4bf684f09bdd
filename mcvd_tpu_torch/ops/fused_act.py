"""Bias + LeakyReLU + scale (StyleGAN2's fused_leaky_relu) as one Triton
kernel for Hopper, `fused_leaky_relu`.

Replaces `mcvd_tpu/ops/fused_act.py::fused_leaky_relu` (Pallas body
`_kernel`): y = leaky_relu(x + bias[c], slope) * scale over x (..., C).

Bound on the card: bytes. One read and one write of x at a few FLOPs per
element, so each program streams one contiguous block of 4096 elements with
the per-channel bias gathered from a (C,) vector that stays in L1.

Layouts: x (..., C) contiguous, the JAX op's; or, with `dim=1`, a 4-D NCHW
tensor stored channels_last, which is the same memory. Either way the
channel of element i of memory is i % C. Anything else raises.

Numerics: the kernel and its plain version compute in fp32 and round once to
x's dtype. The JAX op computes in x's dtype: in bf16 it rounds after the bias
add, after the slope and after the scale, so the two differ in bf16 by up to
two bf16 ulps (one without a bias). Forward only, as the JAX op (its
gradient is JAX autodiff of the same expression); raises under grad.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import count_launch, use_kernel

_TRITON = {}
_DTYPES = (torch.float32, torch.bfloat16)
_BLOCK = 4096


def _kernel():
    """Define the Triton kernel on first use (triton is imported only here)."""
    if _TRITON:
        return _TRITON["fn"]
    import triton
    import triton.language as tl

    @triton.jit
    def fused_leaky_relu_kernel(x_ptr, b_ptr, y_ptr, n, C, slope, scale,
                                HAS_BIAS: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        v = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        if HAS_BIAS:
            v += tl.load(b_ptr + offs % C, mask=m, other=0.0).to(tl.float32)
        v = tl.where(v >= 0, v, v * slope) * scale
        tl.store(y_ptr + offs, v.to(y_ptr.dtype.element_ty), mask=m)

    _TRITON["fn"] = fused_leaky_relu_kernel
    return fused_leaky_relu_kernel


def _channels(x: torch.Tensor, dim: int) -> int:
    """C, after checking that x's memory is channels-innermost along `dim`."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_leaky_relu: x dtype {x.dtype} not in {_DTYPES}")
    if dim in (-1, x.ndim - 1) and x.ndim >= 1:
        if not x.is_contiguous():
            raise ValueError("fused_leaky_relu: x (..., C) must be contiguous")
        return x.shape[-1]
    if dim == 1 and x.ndim == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("fused_leaky_relu: NCHW x must be channels_last contiguous")
        return x.shape[1]
    raise ValueError(f"fused_leaky_relu: channels at dim={dim} of a {x.ndim}-D x; "
                     "takes (..., C) with dim=-1 or channels_last NCHW with dim=1")


def fused_leaky_relu_reference(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                               negative_slope: float = 0.2, scale: float = 2 ** 0.5,
                               dim: int = -1) -> torch.Tensor:
    """Plain version: fp32 arithmetic, rounded once to x's dtype, in x's layout."""
    v = x.float()
    if bias is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        v = v + bias.float().view(shape)
    return (torch.where(v >= 0, v, v * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = 2 ** 0.5,
                     dim: int = -1) -> torch.Tensor:
    """leaky_relu(x + bias, negative_slope) * scale; x (..., C) contiguous
    with dim=-1, or NCHW channels_last with dim=1; bias (C,) fp32 or x's
    dtype. Returns x's dtype, shape and layout."""
    C = _channels(x, dim)
    if bias is not None:
        if bias.shape != (C,) or bias.dtype not in _DTYPES:
            raise ValueError(f"fused_leaky_relu: bias must be ({C},) fp32 or bf16, "
                             f"got {bias.dtype} {tuple(bias.shape)}")
        if bias.device != x.device:
            raise ValueError(f"fused_leaky_relu: bias on {bias.device}, x on {x.device}")
    if not use_kernel(x):
        return fused_leaky_relu_reference(x, bias, negative_slope, scale, dim)
    if torch.is_grad_enabled() and (x.requires_grad or (bias is not None
                                                        and bias.requires_grad)):
        raise RuntimeError("fused_leaky_relu: the kernel is forward-only; run under "
                           "torch.no_grad() or torch.inference_mode()")
    fn = _kernel()
    y = torch.empty_like(x)   # preserves x's strides: same memory order
    n = x.numel()
    b = bias.contiguous() if bias is not None else x   # x: an unread placeholder
    with torch.cuda.device(x.device):
        fn[(-(-n // _BLOCK),)](x, b, y, n, C, float(negative_slope), float(scale),
                               HAS_BIAS=bias is not None, BLOCK=_BLOCK, num_warps=4)
    count_launch("fused_leaky_relu")
    return y
