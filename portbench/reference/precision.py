"""Rounding of the operands of every matrix product and convolution to a
lower precision than float32, for the benchmark's controls: the reference
with it is what a cheaper implementation would compute.

  * `tf32`: float32 rounded to TF32's 10-bit mantissa, to nearest even (the
    tensor cores' TF32 inputs); accumulation stays float32;
  * `fp8`: float8 e4m3 with one scale per tensor (amax to 448), the usual
    fp8 recipe for a bfloat16 model.

A `Precision` rounds an operand on the way in (`operand`) and, in the
backward pass, the gradient that reaches a product's output (`output`), so
the backward's products take rounded operands too.
"""

from __future__ import annotations

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.float().contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32).reshape(t.shape)


def fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fn):
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Output(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Precision:
    def __init__(self, fn):
        self.fn = fn

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(t, self.fn)

    def output(self, t: torch.Tensor) -> torch.Tensor:
        return _Output.apply(t, self.fn)


PRECISIONS = {"tf32": Precision(tf32), "fp8": Precision(fp8)}
