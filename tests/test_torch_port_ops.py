"""The port's GroupNorm and attention ops against the JAX package's Pallas
kernels (interpret mode on the CPU backend) and lax references, on the same
numpy inputs. On the CPU the port's wrappers take their plain PyTorch
versions; the `cuda` tests hold the Hopper kernels against those plain
versions and skip without a card.

The card machine has no jax; there the `cuda` tests run on their own with
`python -m pytest --noconftest tests/test_torch_port_ops.py -m cuda`, and
the JAX comparisons skip."""

import functools

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


FLAGSHIP_RESOLUTIONS = [64, 32, 16, 8]


@functools.lru_cache(maxsize=None)
def flagship_gn_calls():
    """The flagship's GroupNorm calls of one evaluation at B=16, read from
    the model on the meta device."""
    from mcvd_tpu_torch.tools.gn_calls import group_norm_calls

    return tuple(tuple(sorted(c.items())) for c in group_norm_calls(batch=16))


def test_flagship_group_norm_calls():
    """67 GroupNorms an evaluation: 56 AdaGN+SiLU and the head's affine+SiLU
    at eps 1e-5, 10 affine at eps 1e-6; every resolution of the model."""
    from mcvd_tpu_torch.tools.gn_calls import form

    calls = [dict(c) for c in flagship_gn_calls()]
    assert len(calls) == 67
    forms = {f: [c for c in calls if form(c) == f] for f in FORMS}
    assert {f: len(v) for f, v in forms.items()} == {"adagn_silu": 56, "affine": 10,
                                                      "affine_silu": 1}
    for f, (eps, *_rest) in FORMS.items():
        assert {c["eps"] for c in forms[f]} == {eps}
    assert sorted({c["H"] for c in calls}, reverse=True) == FLAGSHIP_RESOLUTIONS


@pytest.mark.parametrize("H", FLAGSHIP_RESOLUTIONS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gn_plan_covers_flagship_calls(dtype, H):
    """`plan()` at every GroupNorm call of one flagship evaluation at B=16:
    the blocks' rows cover H*W exactly with no empty block, an example gets
    8 blocks (the portable cluster size), a thread always sees the same
    16-byte channel vector, and shared memory matches the kernel's layout
    and fits in 227 KB."""
    from mcvd_tpu_torch.ops.groupnorm import MAX_CLUSTER, SMEM_LIMIT, plan, smem_bytes

    calls = [dict(c) for c in flagship_gn_calls() if dict(c)["H"] == H]
    assert calls
    for c in calls:
        CN, W, G = c["C"], c["W"], c["num_groups"]
        p = plan(CN, H, W, dtype, G)
        S = H * W
        where = f"C={CN} H={H} {dtype}: {p}"
        assert p.rows * p.cluster >= S and p.rows * (p.cluster - 1) < S, where
        assert p.cluster == min(MAX_CLUSTER, S) == 8, where
        vec = 16 // dtype.itemsize
        assert p.threads % (CN // vec) == 0 and p.threads <= 512, where
        assert p.threads // (CN // vec) <= p.rows, where
        assert p.smem == smem_bytes(p.threads, vec, CN, G) <= SMEM_LIMIT, where


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


def packed_tc_emulation(qkv, h, scale):
    """`attention_tc_emulation` on the packed (B, T, 3C) layout."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    q, k, v = (t.reshape(B, T, h, C // h).transpose(1, 2).reshape(B * h, T, C // h)
               for t in qkv.split(C, dim=-1))
    o = ops.attention.attention_tc_emulation(q, k, v, scale)
    return o.reshape(B, h, T, C // h).transpose(1, 2).reshape(B, T, C)


# The bf16 kernel's tolerance against a version that keeps p in fp32 (the
# plain version, and chip_smoke's check): rounding p to bf16 moves an output
# by at most 2^-8 * sum_j p_j |v_j| / l (1% slack for the fp32 sums), and
# both sides round once more to bf16 (two ulps relative). The Pallas kernel
# rounds the normalised p to bf16 too, so against it the atol doubles.
@pytest.mark.parametrize("against", ["plain", "pallas"])
@pytest.mark.parametrize("T", [64, 200])
def test_attention_tc_numerics_match(T, against):
    """The tensor-core kernel's arithmetic (online softmax over 64-key tiles,
    unnormalised p rounded to bf16, fp32 accumulation), emulated in torch on
    bf16 inputs, against the plain version and the JAX Pallas kernel."""
    B, h, d = 2, 2, 64
    q, k, v = (a.astype(np.float32) for a in attn_inputs(9, (B, T, h * d)))
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(torch.bfloat16)
    got = packed_tc_emulation(qkv, h, d ** -0.5)
    assert got.dtype == torch.bfloat16
    if against == "plain":
        want = ops.attention.attention_packed_reference(qkv, h, d ** -0.5).float().numpy()
        n_rounded = 1
    else:
        qj, kj, vj = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                      for t in qkv.split(h * d, dim=-1))
        want = np.asarray(fused_attention_packed(qj, kj, vj, h, d ** -0.5)
                          .astype(jnp.float32))
        n_rounded = 2
    atol, rtol = ops.attention.bf16_tolerances(qkv, h, d ** -0.5)["plain"]
    bound = n_rounded * atol.numpy() + rtol * np.abs(want)
    err = np.abs(got.float().numpy() - want)
    assert (err <= bound).all(), f"max err {err.max()}, worst margin {(err / bound).max()}"


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
    assert set(ops.LAUNCHES) == {"gn_fused", "attention_fwd", "fused_leaky_relu", "gn_copy",
                                 "gn_variant"}
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
    """Inputs on the card as the model passes them: every tensor in x's
    dtype, scale and shift as the two chunks of one (B, 2*C*N) tensor."""
    x, kw = gn_inputs(7, B, H, C, frames_last, form)
    xt = to_torch_nchw(x).to(device=device, dtype=dtype)
    tkw = {k: (torch.from_numpy(v).to(device, dtype) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if "scale" in tkw:
        ss = torch.cat([tkw["scale"], tkw["shift"]], dim=1)
        tkw["scale"], tkw["shift"] = ss.chunk(2, dim=1)
        assert not tkw["scale"].is_contiguous()
    return xt, tkw


# (B, C, H, frames_last): up to 256 channels at 64x64
GN_KERNEL_CASES = [(2, 64, 16, 1), (2, 192, 8, 1), (3, 32, 8, 2), (2, 64, 64, 2),
                   (2, 256, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_group_norm_kernel_matches_plain(cuda, form, dtype):
    GN = ops.groupnorm
    for B, C, H, N in GN_KERNEL_CASES:
        xt, tkw = _gn_case(cuda, dtype, B, C, H, N, form)
        G = num_groups_for(C)
        ops.reset_launches()
        with torch.inference_mode():
            got = GN.group_norm(xt, G, **tkw)
            with ops.reference_ops():
                want = GN.group_norm(xt, G, **tkw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["gn_fused"] == 1
        # fp32: summation order only (1e-4 for sums over up to 1e4 terms);
        # bf16: one rounding step, as in TOL
        tol = dict(rtol=0, atol=1e-4) if dtype == torch.float32 else TOL[dtype]
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **tol, err_msg=f"C={C} H={H} N={N}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_kernel_matches_plain(cuda, dtype):
    for T, h in [(64, 4), (100, 2), (256, 3), (1024, 2)]:
        q, k, v = attn_inputs(8, (2, T, 64 * h))
        qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(cuda, dtype)
        ops.reset_launches()
        with torch.inference_mode():
            got = ops.attention.attention_packed(qkv, h, 0.125)
            with ops.reference_ops():
                want = ops.attention.attention_packed(qkv, h, 0.125)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["attention_fwd"] == 1
        if dtype == torch.float32:
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"T={T} h={h}")
            continue
        # per element, as chip_smoke: against the plain version, and tighter
        # against its own arithmetic emulated
        tols = ops.attention.bf16_tolerances(qkv, h, 0.125)
        for against, ref in (("plain", want), ("emulation", packed_tc_emulation(qkv, h, 0.125))):
            atol, rtol = tols[against]
            err = (got.float() - ref.float()).abs()
            ok = bool((err <= atol + rtol * ref.float().abs()).all())
            assert ok, f"T={T} h={h} vs {against}: max err {float(err.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_refuse_what_they_do_not_take(cuda, dtype):
    with pytest.raises(ValueError, match="supported"):
        ops.attention.attention_packed(torch.zeros(1, 8, 3 * 32, device=cuda, dtype=dtype),
                                       1, 1.0)
    qkv = torch.zeros(1, 8, 3 * 64, device=cuda, dtype=dtype, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.attention.attention_packed(qkv, 1, 1.0)
    x = torch.zeros(1, 8, 4, 4, device=cuda, dtype=dtype, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.groupnorm.group_norm(x.contiguous(memory_format=torch.channels_last), 2, eps=1e-5)
    with pytest.raises(ValueError, match="channels_last"):
        ops.groupnorm.group_norm(torch.zeros(1, 8, 4, 4, device=cuda, dtype=dtype), 2,
                                 eps=1e-5)
