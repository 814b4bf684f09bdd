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
    import jax
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


@pytest.mark.parametrize("B", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gn_bwd_plan_covers_flagship_calls(dtype, B):
    """`bwd_plans()` at every GroupNorm call of one flagship evaluation (and
    frames_last=2), at the kernel tests' B and the training step's. Both
    routes: the row runs cover H*W exactly with none empty, a thread always
    sees the same 16-byte channel vector, shared memory matches the
    kernels' layout and fits in 227 KB, and the scratch holds the split
    route's per-chunk sums (none on the cluster route) and the outputs. The
    cluster route has clusters of `BWD_CLUSTER`; the split route has every thread a
    row and about `BWD_BLOCKS` blocks where every thread gets `BWD_UNROLL`
    rows (rounding the rows up may drop up to half the chunks). `bwd_plan`
    takes the split route exactly where x and dy pass `SPLIT_BYTES`
    (`AFFINE_SPLIT_BYTES` with gamma), and clusters of 8 up to
    `SPLIT_BYTES`."""
    from mcvd_tpu_torch.ops.groupnorm import (AFFINE_SPLIT_BYTES, BWD_BLOCKS, BWD_CLUSTER,
                                              BWD_THREADS, BWD_UNROLL, SMEM_LIMIT,
                                              SPLIT_BYTES, bwd_plan, bwd_plans,
                                              bwd_smem_bytes, bwd_workspace)

    cases = {(c["C"], c["H"], c["num_groups"], 1, c["affine"])
             for c in map(dict, flagship_gn_calls())}
    cases.add((128, 32, 16, 2, False))   # frames_last=2: C*N = 128
    vec = 16 // dtype.itemsize
    routes = set()
    for CN, H, G, N, affine in sorted(cases):
        cluster, split = bwd_plans(B, CN, H, H, dtype, G, N)
        S, nv = H * H, CN // vec
        for p in (cluster, split):
            where = f"C={CN} H={H} N={N} {dtype} B={B}: {p}"
            assert p.rows * p.blocks >= S and p.rows * (p.blocks - 1) < S, where
            assert p.threads % nv == 0, where
            assert p.smem == bwd_smem_bytes(p.threads, vec, CN, G) <= SMEM_LIMIT, where
            at = bwd_workspace(B, CN, G, CN // N, p.blocks if p.split else 0)
            assert at["d_ss"] == (B * p.blocks * 2 * (CN + G) if p.split else 0), where
            assert at["dgb"] == at["d_ss"] + 4 * B * CN, where
            assert p.ws_floats == at["total"] == at["dgb"] + 2 * (CN // N), where
        assert not cluster.split and cluster.blocks <= min(BWD_CLUSTER, S)
        assert cluster.threads <= 512 and cluster.threads // nv <= cluster.rows
        assert split.split and split.threads <= BWD_THREADS and split.threads // nv <= split.rows
        want = min(-(-BWD_BLOCKS // B), -(-S // (BWD_UNROLL * split.threads // nv)))
        assert want // 2 < split.blocks <= want, split
        nbytes = 2 * B * CN * S * dtype.itemsize
        big = nbytes > (AFFINE_SPLIT_BYTES if affine else SPLIT_BYTES)
        picked = bwd_plan(B, CN, H, H, dtype, G, N, affine)
        if nbytes <= SPLIT_BYTES:   # the forward's clusters of 8
            assert (picked.split, picked.blocks) == (False, min(8, S))
        else:
            assert picked == (split if big else cluster)
        routes.add(big)
    assert routes == {False, True}   # the small affine forms take the cluster route


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


def heads_of(t, h):
    """(B, T, h*d) -> (B*h, T, d)."""
    B, T, C = t.shape
    return t.reshape(B, T, h, C // h).transpose(1, 2).reshape(B * h, T, C // h)


def packed_of(t, B):
    """(B*h, T, d) -> (B, T, h*d)."""
    BH, T, d = t.shape
    return t.reshape(B, BH // B, T, d).transpose(1, 2).reshape(B, T, BH // B * d)


def packed_tc_emulation(qkv, h, scale):
    """`attention_tc_emulation` on the packed (B, T, 3C) layout."""
    q, k, v = (heads_of(t, h) for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
    return packed_of(ops.attention.attention_tc_emulation(q, k, v, scale), qkv.shape[0])


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
    check_tc_numerics(T, 2, 64, against)


# The same at the wider head dims of bair_big/kth64_big/ucf101 (96) and
# cityscapes_big (128), two heads.
@pytest.mark.parametrize("against", ["plain", "pallas"])
@pytest.mark.parametrize("T", [64, 128])
@pytest.mark.parametrize("d", [96, 128])
def test_attention_wide_heads_tc_numerics_match(d, T, against):
    check_tc_numerics(T, 2, d, against)


def check_tc_numerics(T, h, d, against):
    B = 2
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


def jax_packed_vjp(qkv, g, h, scale):
    """d(qkv) of `fused_attention_packed` (interpret mode) in fp32, packed."""
    q, k, v = (jnp.asarray(t) for t in np.split(qkv, 3, axis=-1))
    _, vjp = jax.vjp(lambda q, k, v: fused_attention_packed(q, k, v, h, scale, interpret=True),
                     q, k, v)
    return np.concatenate([np.asarray(t) for t in vjp(jnp.asarray(g))], -1)


# The bf16 backward kernels' arithmetic (p and ds rounded to bf16 as
# operands, D from the forward's bf16 output), emulated in torch on bf16
# inputs, per element within `bf16_bwd_tolerances`: against the plain VJP
# (both round the gradients once) and against jax.vjp of the Pallas entry
# point on the same values in fp32 (its gradients are not rounded: one
# rounding, within the same rtol).
@pytest.mark.parametrize("against", ["plain", "pallas"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("T", [64, 200])
def test_attention_bwd_tc_numerics_match(T, h, against):
    check_bwd_tc_numerics(T, h, 64, against)


@pytest.mark.parametrize("against", ["plain", "pallas"])
@pytest.mark.parametrize("T", [64, 128])
@pytest.mark.parametrize("d", [96, 128])
def test_attention_wide_heads_bwd_tc_numerics_match(d, T, against):
    check_bwd_tc_numerics(T, 2, d, against)


def check_bwd_tc_numerics(T, h, d, against):
    B = 2
    scale = d ** -0.5
    rng = np.random.RandomState(17)
    qkv = torch.from_numpy(rng.randn(B, T, 3 * h * d).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.randn(B, T, h * d).astype(np.float32)).to(torch.bfloat16)
    q, k, v = (heads_of(t, h) for t in qkv.split(h * d, dim=-1))
    grads = ops.attention.attention_bwd_tc_emulation(q, k, v, heads_of(g, h), scale)
    got = torch.cat([packed_of(t, B) for t in grads], -1)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    if against == "plain":
        want = ops.attention.attention_packed_bwd_reference(qkv, g, h, scale).float().numpy()
    else:
        want = jax_packed_vjp(qkv.float().numpy(), g.float().numpy(), h, scale)
    atol, rtol = ops.attention.bf16_bwd_tolerances(qkv, g, h, scale)["plain"]
    bound = atol.numpy() + rtol * np.abs(want)
    err = np.abs(got.float().numpy() - want)
    assert (err <= bound).all(), f"max err {err.max()}, worst margin {(err / bound).max()}"


# 3xTF32 keeps ~21-22 bits of each product: the emulated fp32 kernels'
# products against the JAX fp32 forward and VJP (highest precision) at the
# plain versions' atol 1e-5.
@pytest.mark.parametrize("direction", ["fwd", "vjp"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("T", [64, 200])
def test_attention_tf32x3_matches_pallas(T, h, direction):
    check_tf32x3(T, h, 64, direction)


@pytest.mark.parametrize("direction", ["fwd", "vjp"])
@pytest.mark.parametrize("T", [64, 128])
@pytest.mark.parametrize("d", [96, 128])
def test_attention_wide_heads_tf32x3_matches_pallas(d, T, direction):
    check_tf32x3(T, 2, d, direction)


@pytest.mark.parametrize("d", [96, 128])
def test_tf32x3_matmul_wide_heads_matches_jax(d):
    """q k^T (d-term sums) and p v as the fp32 kernels' 3xTF32 products at
    the wider head dims, against JAX's fp32 matmul at highest precision, per
    element within 2^-19 * (|a| @ |b|): each 3xTF32 product keeps ~21 bits
    (the dropped lo*lo term and the rounded lo, 2^-21 each), and both sides'
    fp32 sums run in another order (2^-24 per term)."""
    rng = np.random.RandomState(20)
    q, k = (rng.randn(2, 128, d).astype(np.float32) for _ in range(2))
    p = rng.rand(2, 128, 128).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        for a, b in ((q, k.transpose(0, 2, 1)), (p, k)):
            want = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b)))
            got = ops.attention.tf32x3_matmul(torch.from_numpy(a), torch.from_numpy(b))
            bound = 2.0 ** -19 * (np.abs(a) @ np.abs(b))
            assert (np.abs(got.numpy() - want) <= bound).all()


def check_tf32x3(T, h, d, direction):
    B = 2
    scale = d ** -0.5
    rng = np.random.RandomState(18)
    qkv = rng.randn(B, T, 3 * h * d).astype(np.float32)
    q, k, v = (heads_of(torch.from_numpy(t), h) for t in np.split(qkv, 3, axis=-1))
    if direction == "fwd":
        got = packed_of(ops.attention.attention_tf32x3_emulation(q, k, v, scale), B)
        want = np.asarray(fused_attention_packed(*(jnp.asarray(t) for t in
                                                   np.split(qkv, 3, axis=-1)), h, scale))
    else:
        g = rng.randn(B, T, h * d).astype(np.float32)
        grads = ops.attention.attention_bwd_tf32x3_emulation(
            q, k, v, heads_of(torch.from_numpy(g), h), scale)
        got = torch.cat([packed_of(t, B) for t in grads], -1)
        want = jax_packed_vjp(qkv, g, h, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("magnitude", [1e-30, 1.0, 3e4])
def test_tf32_split_reconstructs(magnitude):
    """hi is a tf32 value (13 low mantissa bits zero), lo too, and hi + lo
    is x to within 2^-22 relative."""
    x = torch.from_numpy(np.random.RandomState(19).randn(4096).astype(np.float32)) * magnitude
    hi, lo = ops.attention.tf32_split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert bool((hi - x).abs().le(2.0 ** -11 * x.abs()).all())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool(err.le(2.0 ** -22 * x.double().abs()).all()), float((err / x.abs()).max())


def test_check_head_dim_takes_the_kernels_dims():
    """The wrappers take head dims 64, 96 and 128 (one kernel instantiation
    each) and refuse the rest, naming the ROADMAP item."""
    for d in (64, 96, 128):
        ops.attention._check_head_dim("attention", d)
    for d in (32, 192):
        with pytest.raises(ValueError, match="supported.*F1"):
            ops.attention._check_head_dim("attention", d)


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
    # and both backward passes
    xg = to_torch_nchw(x).requires_grad_()
    ops.groupnorm.group_norm(xg, 4, eps=1e-5, act=True).sum().backward()
    qkv = torch.zeros(1, 4, 3 * 64, requires_grad=True)
    ops.attention.attention_packed(qkv, 1, 0.125).sum().backward()
    assert xg.grad is not None and qkv.grad is not None
    assert set(ops.LAUNCHES) == {"gn_fused", "gn_fused_bwd", "attention_fwd", "attention_bwd",
                                 "fused_leaky_relu", "gn_copy", "gn_variant"}
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
    qkv = torch.zeros(1, 8, 3 * 32, device=cuda, dtype=dtype, requires_grad=True)
    with pytest.raises(ValueError, match="supported"):   # the autograd route checks too
        ops.attention.attention_packed(qkv, 1, 1.0)
    # the kernels copy 16-byte chunks: a contiguous qkv one element off a
    # 16-byte boundary is refused, with and without autograd
    flat = torch.zeros(8 * 3 * 64 + 1, device=cuda, dtype=dtype)
    odd = flat[1:].view(1, 8, 3 * 64)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        ops.attention.attention_packed(odd, 1, 0.125)
    leaf = flat.clone().requires_grad_()
    with pytest.raises(ValueError, match="aligned"):
        ops.attention.attention_packed(leaf[1:].view(1, 8, 3 * 64), 1, 0.125)
    x = torch.zeros(1, 8, 4, 4, device=cuda, dtype=dtype, requires_grad=True)
    with pytest.raises(ValueError, match="channels_last"):
        ops.groupnorm.group_norm(x, 2, eps=1e-5)
    with pytest.raises(ValueError, match="channels_last"):
        ops.groupnorm.group_norm(torch.zeros(1, 8, 4, 4, device=cuda, dtype=dtype), 2,
                                 eps=1e-5)


# ---------------------------------------------------------------------------
# The VJPs: the plain backward passes (what CPU tensors take) against jax.vjp
# of the Pallas entry points in interpret mode and of the lax references.
# ---------------------------------------------------------------------------

PARAM_NAMES = {"adagn_silu": ("scale", "shift"), "affine": ("gamma", "beta"),
               "affine_silu": ("gamma", "beta")}


def jax_gn_vjp(fn, x, G, kw, g, names):
    """jax.vjp of fn(x, G, **kw) in x and the named parameters, at cotangent g."""
    static = {k: v for k, v in kw.items() if k not in names}

    def f(x, *ps):
        return fn(x, G, **static, **dict(zip(names, ps)))

    _, vjp = jax.vjp(f, jnp.asarray(x), *[jnp.asarray(kw[n]) for n in names])
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def port_gn_vjp(x, G, kw, g, names):
    """The port's gradients of group_norm at cotangent g (NHWC numpy in and
    out): scale/shift as the two chunks of one (B, 2CN) leaf, as ActNorm
    passes them."""
    xt = to_torch_nchw(x).requires_grad_()
    tkw = {k: v for k, v in kw.items() if k not in names}
    if names == ("scale", "shift"):
        ss = torch.from_numpy(np.concatenate([kw["scale"], kw["shift"]], 1)).requires_grad_()
        tkw["scale"], tkw["shift"] = ss.chunk(2, dim=1)
        leaves = [ss]
    else:
        leaves = [torch.from_numpy(kw[n]).requires_grad_() for n in names]
        tkw.update(zip(names, leaves))
    ops.reset_launches()
    y = ops.groupnorm.group_norm(xt, G, **tkw)
    grads = torch.autograd.grad(y, [xt, *leaves], grad_outputs=to_torch_nchw(g))
    assert all(v == 0 for v in ops.LAUNCHES.values())   # the plain versions, on the CPU
    dx = to_numpy_nhwc(grads[0])
    assert grads[0].is_contiguous(memory_format=torch.channels_last)
    if names == ("scale", "shift"):
        CN = x.shape[-1]
        return [dx, grads[1][:, :CN].numpy(), grads[1][:, CN:].numpy()]
    return [dx] + [t.numpy() for t in grads[1:]]


# fp32 on both sides with the same closed form (the port's plain backward
# follows _fgn_bwd line by line; against group_norm_folded, XLA's autodiff of
# the forward): summation order only. dx is O(1); the parameter gradients sum
# up to B*H*W*N = 256 terms of O(1), so they take rtol 1e-5 beside atol 1e-5.
VJP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("against", ["pallas", "lax"])
@pytest.mark.parametrize("frames_last", [1, 2])
@pytest.mark.parametrize("form", list(FORMS))
def test_group_norm_vjp_matches_jax(form, frames_last, against):
    C = 16
    x, kw = gn_inputs(10, 2, 8, C, frames_last, form)
    g = np.random.RandomState(11).randn(*x.shape).astype(np.float32)
    G = num_groups_for(C)
    names = PARAM_NAMES[form]
    if against == "pallas":
        def fn(x, G, **k):
            return jax_gn.fused_group_norm(x, G, interpret=True, **k)
    else:
        def fn(x, G, **k):
            return jax_layers.group_norm_folded(x, G, **k)[0]
    want = jax_gn_vjp(fn, x, G, kw, g, names)
    got = port_gn_vjp(x, G, kw, g, names)
    for name, a, b in zip(("x",) + names, got, want):
        np.testing.assert_allclose(a, b, **VJP_TOL, err_msg=f"d{name}")


# atol 1e-5: fp32 on both sides, p recomputed the same way; the T-term sums
# run in another order.
@pytest.mark.parametrize("h,d", [(1, 64), (2, 8), (3, 64)])
@pytest.mark.parametrize("T", [16, 64])
def test_attention_packed_vjp_matches_pallas(T, h, d):
    B, C = 2, h * d
    q, k, v = attn_inputs(12, (B, T, C))
    g = np.random.RandomState(13).randn(B, T, C).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: fused_attention_packed(q, k, v, h, d ** -0.5,
                                                            interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = np.concatenate([np.asarray(t) for t in vjp(jnp.asarray(g))], -1)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    ops.reset_launches()
    out = ops.attention.attention_packed(qkv, h, d ** -0.5)
    got, = torch.autograd.grad(out, [qkv], grad_outputs=torch.from_numpy(g))
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert got.shape == (B, T, 3 * C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T", [16, 64])
def test_attention_vjp_matches_pallas(T):
    q, k, v = attn_inputs(14, (3, T, 64))
    g = np.random.RandomState(15).randn(3, T, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: fused_attention(q, k, v, 0.125, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.attention.attention(qt, kt, vt, 0.125)
    got = torch.autograd.grad(out, [qt, kt, vt], grad_outputs=torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5, err_msg=f"d{name}")


def test_forward_saves_nothing_without_grad():
    """With no input needing a gradient the ops take their forward-only
    route: no autograd graph on the output."""
    x, kw = gn_inputs(16, 1, 8, 16, 1, "affine")
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    y = ops.groupnorm.group_norm(to_torch_nchw(x), 4, **tkw)
    o = ops.attention.attention_packed(torch.zeros(1, 4, 3 * 64), 1, 0.125)
    assert y.grad_fn is None and o.grad_fn is None
    tkw["gamma"].requires_grad_()
    assert ops.groupnorm.group_norm(to_torch_nchw(x), 4, **tkw).grad_fn is not None


# On the card: the backward kernels against the plain backward passes. fp32:
# summation order (1e-4 of the largest gradient; the parameter gradients
# sum up to B*H*W terms). bf16: both compute in fp32 from the same bf16
# inputs and round once, so an element differs by at most two bf16 steps
# (rtol 1.6e-2), beside the fp32 order term.
def _grad_close(got, want, dtype, what):
    got, want = got.float(), want.float()
    big = float(want.abs().max())
    atol = 1e-4 * max(big, 1.0)
    rtol = 0.0 if dtype == torch.float32 else 1.6e-2
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), f"{what}: max err {float(err.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_group_norm_bwd_kernel_matches_plain(cuda, form, dtype):
    GN = ops.groupnorm
    names = PARAM_NAMES[form]
    for B, C, H, N in GN_KERNEL_CASES:
        xt, tkw = _gn_case(cuda, dtype, B, C, H, N, form)
        xt.requires_grad_()
        if names == ("scale", "shift"):
            ss = torch.cat([tkw["scale"], tkw["shift"]], 1).requires_grad_()
            tkw["scale"], tkw["shift"] = ss.chunk(2, dim=1)
            leaves = [xt, ss]
        else:
            leaves = [xt] + [tkw[n].requires_grad_() for n in names]
        G = num_groups_for(C)
        g = torch.randn(xt.shape, device=cuda).to(dtype).contiguous(
            memory_format=torch.channels_last)
        ops.reset_launches()
        got = torch.autograd.grad(GN.group_norm(xt, G, **tkw), leaves, grad_outputs=g)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["gn_fused"] == 1 and ops.LAUNCHES["gn_fused_bwd"] == 1
        with ops.reference_ops():
            want = torch.autograd.grad(GN.group_norm(xt, G, **tkw), leaves, grad_outputs=g)
        for i, (a, b) in enumerate(zip(got, want)):
            _grad_close(a, b, dtype, f"C={C} H={H} N={N} input {i}")


# bf16: each gradient is rounded once (2^-8 of its size), and the row term
# D = rowsum(dO * O) uses the forward's output, whose p the tensor cores
# rounded to bf16 (2^-8 relative): together within 2^-6 of the largest entry.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_bwd_kernel_matches_plain(cuda, dtype):
    for T, h in [(64, 4), (100, 2), (256, 3), (1024, 2)]:
        q, k, v = attn_inputs(8, (2, T, 64 * h))
        qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(cuda, dtype).requires_grad_()
        g = torch.randn(2, T, 64 * h, device=cuda).to(dtype)
        ops.reset_launches()
        got, = torch.autograd.grad(ops.attention.attention_packed(qkv, h, 0.125), [qkv],
                                   grad_outputs=g)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["attention_fwd"] == 1 and ops.LAUNCHES["attention_bwd"] == 1
        with ops.reference_ops():
            want, = torch.autograd.grad(ops.attention.attention_packed(qkv, h, 0.125), [qkv],
                                        grad_outputs=g)
        rel = 1e-4 if dtype == torch.float32 else 2.0 ** -6
        for i, part in enumerate("qkv"):
            a, b = (t[..., i * 64 * h:(i + 1) * 64 * h].float() for t in (got, want))
            err = float((a - b).abs().max())
            assert err <= rel * float(b.abs().max()), f"T={T} h={h} d{part}: max err {err}"
        # no atomics: the kernel alone gives the same bits twice
        qd = qkv.detach()
        o, lse = ops.attention.attention_packed_fwd(qd, h, 0.125, True)
        once = ops.attention.attention_packed_bwd(qd, o, lse, g, h, 0.125)
        assert torch.equal(once, ops.attention.attention_packed_bwd(qd, o, lse, g, h, 0.125))
        assert torch.equal(once, got)
        if dtype == torch.bfloat16:   # per element, as chip_smoke
            atol, rtol = ops.attention.bf16_bwd_tolerances(qd, g, h, 0.125)["plain"]
            err = (got.float() - want.float()).abs()
            assert bool((err <= atol + rtol * want.float().abs()).all()), \
                f"T={T} h={h}: per-element max err {float(err.max())}"
