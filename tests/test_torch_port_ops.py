"""The port's GroupNorm and attention ops against the JAX package's Pallas
kernels (interpret mode on the CPU backend) and lax references, on the same
numpy inputs. On the CPU the port's wrappers take their plain PyTorch
versions; the `cuda` tests hold the Hopper kernels against those plain
versions and skip without a card.

The card machine has no jax; there the `cuda` tests run on their own with
`python -m pytest --noconftest tests/test_torch_port_ops.py -m cuda`, and
the JAX comparisons skip."""

import numpy as np
import pytest
import torch

from mcvd_tpu_torch import ops
from mcvd_tpu_torch.models.layers import num_groups_for

try:
    import jax.numpy as jnp

    import mcvd_tpu.ops.lab.groupnorm as jax_gn
    from mcvd_tpu.models import layers as jax_layers
    from mcvd_tpu.ops.lab.attention import fused_attention, fused_attention_packed
except ImportError:  # no jax: only the `cuda` tests can run
    jnp = None


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs jax: the JAX package is the reference")

FORMS = {
    # name: (eps, affine, adagn, act) — the three main-path call sites
    "adagn_silu": (1e-5, False, True, True),   # ActNorm with temb
    "affine": (1e-6, True, False, False),      # AttnBlock.GroupNorm_0
    "affine_silu": (1e-5, True, False, True),  # output-head ActNorm
}


def to_torch_nchw(x_nhwc):
    """numpy NHWC -> torch NCHW view, channels_last (the same memory)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def to_numpy_nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def gn_inputs(seed, B, H, C, frames_last, form):
    eps, affine, adagn, act = FORMS[form]
    rng = np.random.RandomState(seed)
    CN = C * frames_last
    x = (rng.randn(B, H, H, CN) * 2.0 + 0.5).astype(np.float32)
    kw = dict(eps=eps, frames_last=frames_last, act=act)
    if affine:
        kw["gamma"] = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
        kw["beta"] = (0.1 * rng.randn(C)).astype(np.float32)
    if adagn:
        kw["scale"] = (0.1 * rng.randn(B, CN)).astype(np.float32)
        kw["shift"] = (0.1 * rng.randn(B, CN)).astype(np.float32)
    return x, kw


def run_jax_pallas(x, G, kw, dtype):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out = jax_gn.fused_group_norm(jnp.asarray(x, dtype), G, **jkw)
    return np.asarray(out.astype(jnp.float32))


def run_port(x, G, kw, dtype):
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    out = ops.groupnorm.group_norm(to_torch_nchw(x).to(dtype), G, **tkw)
    assert out.dtype == dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    return to_numpy_nhwc(out)


# fp32: atol 1e-5 — both sides take fp32 stats as E[x^2]-mean^2 over the same
# values, differing only in summation order (~1e-7 relative at these sizes).
# bf16: both compute y in fp32 and round once to bf16, so they differ by at
# most one bf16 rounding step where the fp32 values straddle a boundary:
# rtol 1.6e-2 (two bf16 ulps, 2 * 2^-7).
TOL = {torch.float32: dict(rtol=0, atol=1e-5), torch.bfloat16: dict(rtol=1.6e-2, atol=1e-5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("frames_last", [1, 2])
@pytest.mark.parametrize("form", list(FORMS))
def test_group_norm_matches_pallas(form, frames_last, dtype):
    C = 16
    x, kw = gn_inputs(0, 2, 8, C, frames_last, form)
    G = num_groups_for(C)
    got = run_port(x, G, kw, dtype)
    want = run_jax_pallas(x, G, kw, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("frames_last", [1, 2])
@pytest.mark.parametrize("form", list(FORMS))
def test_group_norm_matches_lax_group_norm_folded(form, frames_last):
    C = 32
    x, kw = gn_inputs(1, 2, 8, C, frames_last, form)
    G = num_groups_for(C)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = np.asarray(jax_layers.group_norm_folded(jnp.asarray(x), G, **jkw)[0])
    got = run_port(x, G, kw, torch.float32)
    np.testing.assert_allclose(got, want, **TOL[torch.float32])


def test_group_norm_matches_pallas_tiled_path(monkeypatch):
    """A block above SINGLE_PASS_MAX_BLOCK takes the Pallas two-pass tiled
    path (_stats_kernel + _norm_kernel); the budget is lowered so a small
    shape lies above it, as tests/test_ops.py does."""
    monkeypatch.setattr(jax_gn, "SINGLE_PASS_MAX_BLOCK", 1024)
    C = 32
    x, kw = gn_inputs(2, 2, 16, C, 1, "adagn_silu")
    assert x[0].nbytes > jax_gn.SINGLE_PASS_MAX_BLOCK
    G = num_groups_for(C)
    got = run_port(x, G, kw, torch.float32)
    want = run_jax_pallas(x, G, kw, jnp.float32)
    np.testing.assert_allclose(got, want, **TOL[torch.float32])


def test_gn_stats_and_apply_plain_versions_compose_to_group_norm():
    """The per-kernel plain versions (what chip_smoke holds gn_stats and
    gn_apply against) compose, through fold_stats, to the plain GroupNorm."""
    C = 32
    x, kw = gn_inputs(3, 2, 8, C, 2, "adagn_silu")
    G = num_groups_for(C)
    xt = to_torch_nchw(x)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items() if isinstance(v, np.ndarray)}
    part = ops.groupnorm.gn_stats(xt, G)
    A, Bc = ops.groupnorm.fold_stats(part, 8 * 8 * (2 * C // G), 2 * C, eps=kw["eps"],
                                     frames_last=2, **tkw)
    got = ops.groupnorm.gn_apply(xt, A, Bc, act=True)
    want = ops.groupnorm.group_norm(xt, G, **{**kw, **tkw})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def attn_inputs(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


# atol 1e-5: fp32 scores and softmax on both sides; only the summation order
# of the T-term sums differs.
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("T", [16, 64])
def test_attention_matches_pallas(T, d):
    q, k, v = attn_inputs(4, (3, T, d))
    want = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      d ** -0.5))
    got = ops.attention.attention(*map(torch.from_numpy, (q, k, v)), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("T", [16, 64])
def test_attention_packed_matches_pallas(T, h, d):
    B, C = 2, h * d
    q, k, v = attn_inputs(5, (B, T, C))
    want = np.asarray(fused_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), h, d ** -0.5))
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    got = ops.attention.attention_packed(qkv, h, d ** -0.5)
    assert got.shape == (B, T, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_reference_ops_restores_on_error():
    x = torch.zeros(1)
    with pytest.raises(RuntimeError):
        with ops.reference_ops():
            assert not ops.use_kernel(x)
            raise RuntimeError("boom")
    assert not ops._REFERENCE[0]


def test_cpu_paths_launch_no_kernel():
    from mcvd_tpu_torch.tools import profile_gn2

    ops.reset_launches()
    x, kw = gn_inputs(6, 1, 8, 16, 1, "affine")
    run_port(x, num_groups_for(16), kw, torch.float32)
    ops.attention.attention_packed(torch.zeros(1, 4, 3 * 64), 1, 0.125)
    ops.fused_act.fused_leaky_relu(torch.zeros(2, 3, 8), torch.zeros(8))
    xb = to_torch_nchw(x).to(torch.bfloat16)
    profile_gn2.make_copy(xb.shape)(xb.contiguous())
    profile_gn2.gn_variant(xb, 4, torch.ones(16), torch.zeros(16), torch.zeros(1, 16),
                           torch.zeros(1, 16), hsplit=2)
    assert set(ops.LAUNCHES) == {"gn_stats", "gn_apply", "attention_fwd", "fused_leaky_relu",
                                 "gn_copy", "gn_variant"}
    assert all(v == 0 for v in ops.LAUNCHES.values())


# ---------------------------------------------------------------------------
# On the card: the Hopper kernels against their plain versions.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gn_case(device, dtype, B, C, H, frames_last, form):
    x, kw = gn_inputs(7, B, H, C, frames_last, form)
    xt = to_torch_nchw(x).to(device=device, dtype=dtype)
    tkw = {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    return xt, tkw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_group_norm_kernel_matches_plain(cuda, form, dtype):
    for B, C, H, N in [(2, 64, 16, 1), (2, 192, 8, 1), (3, 32, 8, 2)]:
        xt, tkw = _gn_case(cuda, dtype, B, C, H, N, form)
        G = num_groups_for(C)
        ops.reset_launches()
        with torch.inference_mode():
            got = ops.groupnorm.group_norm(xt, G, **tkw)
            with ops.reference_ops():
                want = ops.groupnorm.group_norm(xt, G, **tkw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["gn_stats"] == ops.LAUNCHES["gn_apply"] == 1
        # fp32: summation order only (1e-4 for sums over up to 1e4 terms);
        # bf16: one rounding step, as in TOL
        tol = dict(rtol=0, atol=1e-4) if dtype == torch.float32 else TOL[dtype]
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_kernel_matches_plain(cuda, dtype):
    for T, h in [(64, 1), (100, 2), (256, 3)]:
        q, k, v = attn_inputs(8, (2, T, 64 * h))
        qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(cuda, dtype)
        ops.reset_launches()
        with torch.inference_mode():
            got = ops.attention.attention_packed(qkv, h, 0.125)
            with ops.reference_ops():
                want = ops.attention.attention_packed(qkv, h, 0.125)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["attention_fwd"] == 1
        tol = dict(rtol=0, atol=1e-4) if dtype == torch.float32 else TOL[dtype]
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **tol)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="supported"):
        ops.attention.attention_packed(torch.zeros(1, 8, 3 * 32, device=cuda), 1, 1.0)
    x = torch.zeros(1, 8, 4, 4, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.groupnorm.group_norm(x.contiguous(memory_format=torch.channels_last), 2, eps=1e-5)
    with pytest.raises(ValueError, match="channels_last"):
        ops.groupnorm.group_norm(torch.zeros(1, 8, 4, 4, device=cuda), 2, eps=1e-5)
