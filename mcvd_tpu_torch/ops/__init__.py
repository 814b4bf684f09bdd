"""Hand-written Hopper kernels for the hot ops, each beside a plain PyTorch
version (counterpart of `mcvd_tpu/ops`, whose kernels are Pallas for the TPU).

  * `groupnorm`: GroupNorm(+affine)(+AdaGN)(+SiLU) in one launch, `gn_fused`,
    and its VJP `gn_fused_bwd`, CUDA C++ for sm_90a built by `_build` (a
    thread-block cluster per example);
  * `attention`: softmax attention forward, `attention_fwd`, and its VJP
    `attention_bwd` (no atomics), CUDA C++ for sm_90a on the tensor cores in
    both dtypes (bf16, and fp32 as 3xTF32: fp32-class, not TF32), one
    family on `wgmma` with TMA-fed tiles in a warp-specialised ring
    (`csrc/attention_wgmma.cuh`) at head dims 24-192, in the two forms that
    `attention.attention_plan` picks: tiled, and packed (head dim 24's
    sequences of 64 tokens or fewer, several to a tile);
  * `fused_act`: bias + LeakyReLU + scale, the Triton kernel
    `fused_leaky_relu`.

The GroupNorm microbenchmark's kernels, `gn_copy` and `gn_variant` (CUDA
C++), live with their tool in `mcvd_tpu_torch.tools.profile_gn2` and count
their launches here too.

A wrapper takes its plain version for a tensor on the CPU, and only there: on
a CUDA tensor it launches its kernel or raises. `reference_ops()` makes the
wrappers take the plain versions on the card too; only the tests and
`chip_smoke.py` use it, to hold the kernels against the plain versions.

Each wrapper adds one to its counter in `LAUNCHES` where it launches its
kernel, and nowhere else, so a run can show it went through the kernels (a
backward wrapper counts one per call, though it may make two launches).
`LAUNCHES` is the `launch` family of the port's counters (`tracing`).
"""

from __future__ import annotations

import contextlib

from .. import tracing

LAUNCHES = tracing.family("launch", ("gn_fused", "gn_fused_bwd", "attention_fwd",
                                     "attention_bwd", "fused_leaky_relu", "gn_copy",
                                     "gn_variant"))
_REFERENCE = [False]


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    tracing.reset("launch")


def use_kernel(x) -> bool:
    """True when `x` lies on a CUDA device and `reference_ops()` is off."""
    return x.is_cuda and not _REFERENCE[0]


@contextlib.contextmanager
def reference_ops():
    """Run the plain PyTorch versions, on the card too, inside the block."""
    prev = _REFERENCE[0]
    _REFERENCE[0] = True
    try:
        yield
    finally:
        _REFERENCE[0] = prev


from . import attention, fused_act, groupnorm  # noqa: E402  (they import the names above)

__all__ = ["LAUNCHES", "attention", "fused_act", "groupnorm", "reference_ops",
           "reset_launches", "use_kernel"]
