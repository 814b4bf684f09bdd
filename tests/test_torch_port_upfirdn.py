"""The polyphase FIR upsample (`mcvd_tpu_torch/ops/upfirdn.py`) against the
JAX package's (`mcvd_tpu/ops/upfirdn.py`) and against the port's
zero-stuffing path (`models/resample.upfirdn2d`, `upsample_2d`), on drawn
sizes, kernels and pads, fp32 at atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from mcvd_tpu.ops import upfirdn as jax_upfirdn
from mcvd_tpu_torch.models import resample
from mcvd_tpu_torch.models.blocks import FIR_KERNEL
from mcvd_tpu_torch.ops.upfirdn import upfirdn2d_up2, upsample_2d_fast

ATOL = 1e-5


def nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 2), st.integers(1, 4), st.integers(1, 9), st.integers(1, 9),
       st.integers(2, 5), st.integers(0, 3), st.integers(0, 3), st.integers(0, 2 ** 31 - 1))
def test_upfirdn2d_up2_matches_jax_and_zero_stuffing(B, C, H, W, k, pad0, pad1, seed):
    """A drawn k x k kernel (each phase meets at least one tap) and pads
    that leave an output."""
    assume(min(H, W) * 2 + pad0 + pad1 - k + 1 >= 1)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    kernel = rng.standard_normal((k, k)).astype(np.float32)
    got = upfirdn2d_up2(nchw(x), kernel, (pad0, pad1))
    assert got.shape == (B, C, 2 * H + pad0 + pad1 - k + 1, 2 * W + pad0 + pad1 - k + 1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jax_upfirdn.upfirdn2d_up2(jnp.asarray(x), jnp.asarray(kernel),
                                                (pad0, pad1)))
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=ATOL)
    plain = resample.upfirdn2d(nchw(x), kernel, up=2, pad=(pad0, pad1))
    np.testing.assert_allclose(nhwc(got), nhwc(plain), rtol=0, atol=ATOL)


@settings(max_examples=6, deadline=None)
@given(st.integers(1, 2), st.integers(1, 6), st.integers(1, 12), st.integers(1, 12),
       st.sampled_from([None, [1, 1], [1, 3, 3, 1], [1, 2, 1], [1, 4, 6, 4, 1]]),
       st.floats(0.25, 4.0), st.integers(0, 2 ** 31 - 1))
def test_upsample_2d_fast_matches_jax_and_upsample_2d(B, C, H, W, k, gain, seed):
    """The FIR kernels the models use and others, with a gain: 2x up."""
    x = np.random.default_rng(seed).standard_normal((B, H, W, C)).astype(np.float32)
    got = upsample_2d_fast(nchw(x), k, 2, gain)
    assert got.shape == (B, C, 2 * H, 2 * W)
    want = np.asarray(jax_upfirdn.upsample_2d_fast(jnp.asarray(x), k, 2, gain))
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(got), nhwc(resample.upsample_2d(nchw(x), k, 2, gain)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("factor", [1, 3])
def test_other_factors_take_upsample_2d(factor):
    """Only factor 2 has the polyphase path, as in the JAX package."""
    x = np.random.default_rng(0).standard_normal((1, 5, 6, 2)).astype(np.float32)
    got = upsample_2d_fast(nchw(x), [1, 1, 1], factor)
    assert torch.equal(got, resample.upsample_2d(nchw(x), [1, 1, 1], factor))
    want = np.asarray(jax_upfirdn.upsample_2d_fast(jnp.asarray(x), [1, 1, 1], factor))
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=ATOL)


def test_flagship_upsample_shapes_in_bf16():
    """The flagship's Upsample inputs (B=1 here; `chip_smoke.py` times B=16
    on the card): bf16 within two bf16 steps of the zero-stuffing path."""
    g = torch.Generator().manual_seed(1)
    for C, H in ((256, 8), (192, 16), (128, 32)):
        x = torch.randn(1, C, H, H, generator=g).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        got = upsample_2d_fast(x, FIR_KERNEL).float()
        want = resample.upsample_2d(x, FIR_KERNEL).float()
        assert got.shape == (1, C, 2 * H, 2 * H)
        assert bool(((got - want).abs() <= 1e-3 + 2 * 2 ** -8 * want.abs()).all())
