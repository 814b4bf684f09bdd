"""The port's `fused_leaky_relu` op and the GroupNorm microbenchmark's
`make_copy` / `gn_variant` against the JAX package, on the same numpy inputs.

The JAX `fused_leaky_relu` runs its Pallas kernel in interpret mode. The JAX
tool `tools/profile_gn2.py` passes no `interpret`, so it is loaded here with
importlib and its module's `pl` is replaced by a shim whose `pallas_call`
runs in interpret mode; the tool's file is not changed.

On the CPU the port's wrappers take their plain PyTorch versions; the `cuda`
tests hold the Hopper kernels against those plain versions and skip without
a card (on the card: `python -m pytest --noconftest
tests/test_torch_port_tools.py -m cuda`, where the JAX comparisons skip)."""

import functools
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from mcvd_tpu_torch import ops
from mcvd_tpu_torch.ops import fused_act
from mcvd_tpu_torch.tools import profile_gn2 as tool

try:
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from mcvd_tpu.ops import fused_act as jax_fused_act
    from mcvd_tpu.ops.lab.groupnorm import _group_matrix as jax_group_matrix
except ImportError:  # no jax: only the `cuda` tests can run
    jnp = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs jax: the JAX package is the reference")


@pytest.fixture(scope="module")
def jax_tool():
    """`tools/profile_gn2.py` with its pallas_call in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "jax_profile_gn2", os.path.join(REPO, "tools", "profile_gn2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = shim
    return mod


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps of want (fp32 spacing * 2^16)."""
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return np.abs(got - want) / ulp


# ---------------------------------------------------------------------------
# fused_leaky_relu
# ---------------------------------------------------------------------------


def act_inputs(seed, shape=(2, 4, 4, 8)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 3).astype(np.float32), rng.randn(shape[-1]).astype(np.float32)


# fp32: 1e-6 as tests/test_ops.py holds the Pallas kernel to its reference.
# bf16: the port computes in fp32 and rounds once; the JAX op rounds to bf16
# after the bias add, after the slope and after the scale (with the slope and
# scale themselves rounded to bf16). Without a bias that is at most one bf16
# ulp of the JAX result, with a bias at most two.
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_fused_leaky_relu_matches_pallas(dtype, with_bias):
    x, b = act_inputs(0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jb = jnp.asarray(b, jdt) if with_bias else None   # the JAX op takes x's dtype
    want = np.asarray(jax_fused_act.fused_leaky_relu(jnp.asarray(x, jdt), jb,
                                                     interpret=True).astype(jnp.float32))
    tb = torch.from_numpy(b).to(dtype) if with_bias else None
    got = fused_act.fused_leaky_relu(torch.from_numpy(x).to(dtype), tb)
    assert got.dtype == dtype and got.shape == x.shape
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert bf16_ulps(got, want).max() <= (2 if with_bias else 1)


def test_fused_leaky_relu_layouts():
    """NCHW stored channels_last (dim=1) is the same memory as (..., C): the
    same values come out, in the input's layout; other layouts raise."""
    x, b = act_inputs(1)
    nhwc = torch.from_numpy(x)
    nchw = nhwc.permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    want = fused_act.fused_leaky_relu(nhwc, torch.from_numpy(b), 0.1, 1.5)
    got = fused_act.fused_leaky_relu(nchw, torch.from_numpy(b), 0.1, 1.5, dim=1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.permute(0, 2, 3, 1), want)
    with pytest.raises(ValueError, match="channels_last"):
        fused_act.fused_leaky_relu(nchw.contiguous(), torch.from_numpy(b), dim=1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_act.fused_leaky_relu(nchw, torch.from_numpy(b))
    with pytest.raises(ValueError, match="bias"):
        fused_act.fused_leaky_relu(nhwc, torch.zeros(3))
    with pytest.raises(ValueError, match="dim=2"):
        fused_act.fused_leaky_relu(nhwc, dim=2)


# ---------------------------------------------------------------------------
# the GroupNorm microbenchmark
# ---------------------------------------------------------------------------


def gn_inputs(seed, B=2, H=8, W=8, C=16):
    """The JAX tool's kind of input: x in U[0, 1), generic gamma/beta/AdaGN."""
    rng = np.random.RandomState(seed)
    return (rng.rand(B, H, W, C).astype(np.float32),
            (1 + 0.1 * rng.randn(C)).astype(np.float32),
            (0.1 * rng.randn(C)).astype(np.float32),
            (0.1 * rng.randn(B, C)).astype(np.float32),
            (0.1 * rng.randn(B, C)).astype(np.float32))


def nchw(x_nhwc, dtype):
    return torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)


def nhwc_numpy(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("frames_last", [1, 2])
def test_group_matrix_matches_jax(frames_last):
    for CN, G in [(16, 4), (64, 32), (128, 32)]:
        np.testing.assert_array_equal(tool.group_matrix(CN * frames_last, G, frames_last),
                                      jax_group_matrix(CN * frames_last, G, frames_last))


def test_copy_matches_jax_tool(jax_tool):
    """Bit for bit: both give bf16(x * 1.0000001), which is x."""
    x = np.random.RandomState(2).rand(2, 8, 4, 16).astype(np.float32)
    want = np.asarray(jax_tool.make_copy(x.shape, 2)(jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(BF16)
    got = tool.make_copy(x.shape)(xt)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(want, xt.float().numpy())
    with pytest.raises(ValueError, match="made for"):
        tool.make_copy((1, 2))(xt)


# fp32: atol 1e-5, summation order only. bf16: both sides compute y in fp32
# from the same statistics (summed in another order) and round once, so they
# may differ by one bf16 rounding step where the fp32 values straddle a
# boundary: rtol 2^-7.
VARIANT_TOL = {torch.float32: dict(rtol=0, atol=1e-5), BF16: dict(rtol=2 ** -7, atol=1e-5)}


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", [{}, dict(parallel=True), dict(hsplit=2, parallel=True),
                                dict(stats_bf16=True, parallel=True),
                                dict(hsplit=2, stats_bf16=True)],
                         ids=["base", "parallel", "hsplit2", "stats_bf16", "hsplit2_bf16"])
def test_gn_variant_matches_jax_tool(jax_tool, kw, dtype):
    x, gamma, beta, scale, shift = gn_inputs(3)
    G = 4
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_tool.gn_variant(jnp.asarray(x, jdt), G, *map(
        jnp.asarray, (gamma, beta, scale, shift)), **kw).astype(jnp.float32))
    got = tool.gn_variant(nchw(x, dtype), G, *map(torch.from_numpy, (gamma, beta, scale,
                                                                     shift)), **kw)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc_numpy(got), want, **VARIANT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_gn_variant_is_group_norm(dtype):
    """hsplit=1 is the port's GroupNorm + affine + AdaGN + SiLU at eps 1e-5."""
    x, gamma, beta, scale, shift = gn_inputs(4, C=32)
    G = 8
    xt = nchw(x, dtype)
    prm = [torch.from_numpy(a) for a in (gamma, beta, scale, shift)]
    got = tool.gn_variant(xt, G, *prm)
    want = ops.groupnorm.group_norm(xt, G, eps=tool.EPS, gamma=prm[0], beta=prm[1],
                                    scale=prm[2], shift=prm[3], act=True)
    tol = dict(rtol=0, atol=1e-5) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **tol)


def test_gn_variant_refuses_what_it_does_not_take():
    x, gamma, beta, scale, shift = gn_inputs(5)
    prm = [torch.from_numpy(a) for a in (gamma, beta, scale, shift)]
    xt = nchw(x, BF16)
    with pytest.raises(ValueError, match="tiles"):
        tool.gn_variant(xt, 4, *prm, hsplit=3)
    with pytest.raises(ValueError, match="channels_last"):
        tool.gn_variant(xt.contiguous(), 4, *prm)
    with pytest.raises(ValueError, match="scale"):
        tool.gn_variant(xt, 4, prm[0], prm[1], prm[2][:1], prm[3])


# (B, hsplit, rows, CN, dtype) -> (route, cluster, bytes a block, blocks):
# the microbenchmark's lines (B=16, 64x64, C=64, and the lane-full 64x32,
# C=128) and a shape past what a cluster of 8 holds.
PLAN_TABLE = [
    ((16, 1, 4096, 64, BF16), ("resident", 8, 64 * 1024, 128)),
    ((16, 1, 4096, 64, torch.float32), ("resident", 8, 128 * 1024, 128)),
    ((16, 4, 1024, 64, BF16), ("resident", 2, 64 * 1024, 128)),
    ((16, 4, 1024, 64, torch.float32), ("resident", 2, 128 * 1024, 128)),
    ((16, 1, 2048, 128, BF16), ("resident", 8, 64 * 1024, 128)),
    ((2, 1, 256 * 256, 64, BF16), ("streamed", 8, 1024 * 1024, 16)),
    ((2, 1, 256 * 256, 64, torch.float32), ("streamed", 8, 2048 * 1024, 16)),
]


@pytest.mark.parametrize("args,want", PLAN_TABLE, ids=[
    "bf16", "f32", "h4_bf16", "h4_f32", "lane_full", "streamed_bf16", "streamed_f32"])
def test_variant_plan_at_the_tools_shapes(args, want):
    B, hsplit, rows, CN, dtype = args
    p = tool.variant_plan(*args)
    esz = dtype.itemsize
    assert (p.route, p.cluster, p.rows_per_block * CN * esz, p.blocks) == want
    assert p.smem == tool.variant_smem(p.threads, esz, CN, p.chunk_rows, p.stages, p.cluster)
    if p.route == "resident":   # the block's rows in one bulk copy, held
        assert (p.stages, p.chunk_rows) == (1, p.rows_per_block)
    else:                       # a ring, and x read twice
        assert p.stages == tool.VARIANT_RING and p.chunk_rows * CN * esz <= tool.VARIANT_CHUNK
    assert tool.variant_plan(*args, route=p.route) == p


def test_variant_plan_keeps_one_wave():
    """Where the card holds fewer clusters of a size at once than there are
    domains (the H100 80GB HBM3 holds 15 clusters of 7 or 8 blocks of 512
    threads), the plan takes the largest size that it holds in one wave."""
    def at_once(p):
        return {8: 15, 7: 15}.get(p.cluster, 132 // p.cluster)

    for dtype in (BF16, torch.float32):
        p = tool.variant_plan(16, 1, 4096, 64, dtype, clusters_at_once=at_once)
        assert (p.route, p.cluster, p.blocks) == ("resident", 6, 96)
        assert p.rows_per_block == 683   # 5 blocks of 683 rows, one of 681
    # every size in one wave: the largest within the SMs, as without the query
    assert tool.variant_plan(16, 4, 1024, 64, BF16, clusters_at_once=at_once).cluster == 2
    # no size in one wave: the smallest that holds the domain
    p = tool.variant_plan(16, 1, 4096, 64, BF16, clusters_at_once=lambda p: 1)
    assert p.route == "resident" and p.cluster == 3
    # past the portable 8 only where the query holds the clusters: two
    # examples of 8 MB in clusters of 16, or of 8 where 16 do not fit
    p = tool.variant_plan(2, 1, 256 * 256, 64, BF16, clusters_at_once=lambda p: 7)
    assert (p.route, p.cluster, p.blocks) == ("streamed", 16, 32)
    p = tool.variant_plan(2, 1, 256 * 256, 64, BF16,
                          clusters_at_once=lambda p: 1 if p.cluster > 8 else 15)
    assert (p.route, p.cluster) == ("streamed", 8)
    assert tool.variant_plan(2, 1, 256 * 256, 64, BF16).cluster == 8   # no query: portable


def test_variant_plan_covers_every_shape():
    """At many shapes of both dtypes: no empty block, shared memory within
    227 KB; the resident route wherever a cluster of up to 8 holds the
    domain, the largest such cluster within the 132 SMs (else the
    smallest); the streamed route past it, with its ring of whole row
    sweeps."""
    for dtype in (BF16, torch.float32):
        esz = dtype.itemsize
        for CN in (8, 24, 64, 192, 1024):
            for rows in (1, 3, 7, 64, 255, 4096, 40000, 300000):
                for B, hsplit in ((1, 1), (16, 1), (16, 4), (200, 1), (65535, 2)):
                    p = tool.variant_plan(B, hsplit, rows, CN, dtype)
                    k, rpb, D = p.cluster, p.rows_per_block, B * hsplit
                    assert 1 <= k <= 8 and p.blocks == D * k
                    assert rpb == -(-rows // k) and rpb * (k - 1) < rows, (p, rows)
                    nv = CN * esz // 16
                    rstep = p.threads // nv
                    assert p.threads % nv == 0 and 512 - nv < p.threads <= 512
                    assert p.smem <= tool.VARIANT_SMEM, p
                    sizes = [c for c in range(1, 9) if -(-rows // c) * (c - 1) < rows]
                    held = [c for c in sizes if tool.variant_smem(
                        p.threads, esz, CN, -(-rows // c), 1, c) <= tool.VARIANT_SMEM]
                    want = held if p.route == "resident" else sizes
                    assert k == max([c for c in want if D * c <= 132], default=want[0])
                    if p.route == "streamed":
                        assert not held and p.stages <= tool.VARIANT_RING
                        chunk = max(rstep, tool.VARIANT_CHUNK // (CN * esz) // rstep * rstep)
                        assert p.chunk_rows == min(chunk, rpb)
                        with pytest.raises(ValueError, match="do not fit"):
                            tool.variant_plan(B, hsplit, rows, CN, dtype, route="resident")
                    else:
                        assert (p.stages, p.chunk_rows) == (1, rpb)


def test_variant_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiples of 8"):
        tool.variant_plan(2, 1, 64, 12, BF16)
    with pytest.raises(ValueError, match="up to 1024"):
        tool.variant_plan(2, 1, 64, 1028, torch.float32)
    with pytest.raises(ValueError, match="65,535"):
        tool.variant_plan(65536, 1, 64, 64, BF16)
    with pytest.raises(ValueError, match="65,535"):
        tool.variant_plan(2, 65536, 64, 64, BF16)
    with pytest.raises(ValueError, match="rows"):
        tool.variant_plan(2, 1, 0, 64, BF16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tool.variant_plan(2, 1, 64, 64, torch.float16)
    with pytest.raises(ValueError, match="route"):
        tool.variant_plan(2, 1, 64, 64, BF16, route="tiled")
    with pytest.raises(ValueError, match="do not fit"):
        tool.variant_plan(2, 1, 256 * 256, 64, BF16, route="resident")
    x, gamma, beta, scale, shift = gn_inputs(5)
    with pytest.raises(ValueError, match="route"):
        tool.gn_variant(nchw(x, BF16), 4, *map(torch.from_numpy, (gamma, beta, scale, shift)),
                        route="tiled")


def test_profile_gn2_needs_the_card(monkeypatch):
    """The tool measures the card only: no CPU fallback."""
    with pytest.raises(RuntimeError, match="no CPU mode"):
        tool.measure(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.measure()


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


def _kernel_and_plain(fn):
    ops.reset_launches()
    with torch.inference_mode():
        got = fn()
        with ops.reference_ops():
            want = fn()
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_fused_leaky_relu_kernel_matches_plain(cuda, dtype):
    x, b = act_inputs(6, (3, 5, 7, 24))
    xt = torch.from_numpy(x).to(cuda, dtype)
    bt = torch.from_numpy(b).to(cuda)
    for args, kw in [((xt, bt), {}), ((xt, None), {}),
                     ((xt.permute(0, 3, 1, 2), bt), dict(dim=1))]:
        got, want = _kernel_and_plain(lambda: fused_act.fused_leaky_relu(*args, **kw))
        assert ops.LAUNCHES["fused_leaky_relu"] == 1
        assert got.stride() == args[0].stride()
        # both compute in fp32 and round once: equal up to fp32 rounding
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_gn_copy_kernel_is_exact(cuda):
    for shape in [(16, 64, 64, 64), (3, 5, 7)]:   # the tool's and a ragged one
        x = torch.rand(shape, device=cuda).to(BF16)
        got, want = _kernel_and_plain(lambda: tool.make_copy(shape)(x))
        assert ops.LAUNCHES["gn_copy"] == 1
        assert torch.equal(got, want) and torch.equal(got, x)


# (B, H, W, C, G): examples on clusters of 8 or more (the first three, where
# the card holds them), fewer blocks as B grows (20, 40) down to one (140),
# and one example past what a cluster of 16 holds (8 MB in bf16), on the
# streamed route.
CARD_SHAPES = [(2, 16, 16, 64, 32), (3, 8, 4, 128, 32), (2, 8, 8, 24, 4), (20, 8, 8, 64, 32),
               (40, 4, 4, 32, 8), (140, 4, 4, 32, 8), (1, 256, 256, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_gn_variant_kernel_matches_plain(cuda, dtype):
    seen = set()
    for (B, H, W, C, G) in CARD_SHAPES:
        x, gamma, beta, scale, shift = gn_inputs(7, B, H, W, C)
        xt = nchw(x, dtype).to(cuda)
        prm = [torch.from_numpy(a).to(cuda) for a in (gamma, beta, scale, shift)]
        for kw in [{}, dict(hsplit=4, parallel=True), dict(stats_bf16=True),
                   dict(route="streamed")]:
            hs = kw.get("hsplit", 1)
            p = tool.card_plan(xt, hs, kw.get("route"))
            seen.add((p.route, p.cluster, "route" in kw))
            got, want = _kernel_and_plain(lambda: tool.gn_variant(xt, G, *prm, **kw))
            assert ops.LAUNCHES["gn_variant"] == 1
            torch.testing.assert_close(got.float(), want.float(), **variant_card_tol(dtype, kw))
            with torch.inference_mode():
                again = tool.gn_variant(xt, G, *prm, **kw)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["gn_variant"] == 2
            assert torch.equal(got, again), (B, H, W, C, kw)   # no atomics: the same bits
    # clusters from one block to the most the card holds in one wave on the
    # resident route, and the streamed route where the plan picks it
    # (1, 128, 128, 64) and where it is forced
    resident = {k for r, k, _ in seen if r == "resident"}
    assert 1 in resident and max(resident) >= 6 and len(resident) >= 3, seen
    assert any(r == "streamed" and k >= 8 and not forced for r, k, forced in seen), seen
    assert len({k for r, k, _ in seen if r == "streamed"}) > 1, seen


def variant_card_tol(dtype, kw):
    """Kernel vs plain on the card. fp32: summation order (1e-4). bf16: one
    rounding step, as VARIANT_TOL. stats_bf16: each channel's fp32 sums,
    taken in another order, are rounded to bf16; where the two land on
    either side of a bf16 boundary, a statistic moves by one bf16 step
    (2^-8 relative), which moves y by up to ~1e-2 at these inputs."""
    if kw.get("stats_bf16"):
        return dict(rtol=1.6e-2, atol=1e-2)
    return dict(rtol=0, atol=1e-4) if dtype == torch.float32 else VARIANT_TOL[BF16]
