"""The attention kernels' one route on the card.

`ops.attention.attention_route` gives every supported (dtype, head dim) the
wgmma kernels (`csrc/attention_wgmma.cuh`: head dims 24-192, any T; head
dim 24's short sequences in the packed form, `attention_plan`). On the CPU
these tests hold the route function at every shape `chip_smoke.py` runs and
the entry point it names, and the bf16 kernels' emulation over many key
tiles against the JAX package's `fused_attention_packed` (Pallas, interpret
mode). The `cuda` test holds the wgmma kernels against their plain versions
(both forward block shapes, sequences shorter than a tile, head dim 24 in
both forms) and skips without a card; on the card machine (no jax) it runs
with `python -m pytest --noconftest tests/test_torch_port_attention_route.py
tests/test_torch_port_attention_short.py -m cuda`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from mcvd_tpu_torch import ops
from mcvd_tpu_torch.ops import attention as A

try:
    import jax.numpy as jnp

    from mcvd_tpu.ops.lab.attention import fused_attention_packed
except ImportError:  # no jax: only the `cuda` test can run
    jnp = None

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs jax: the JAX package is the reference")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("T,h,d", chip_smoke.ATTN_CASES)
def test_every_chip_smoke_case_takes_the_wgmma_route(T, h, d, dtype):
    assert A.attention_route(dtype, d) == "wgmma"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_the_3d_family_keeps_the_mma_sync_route(dtype):
    """Head dim 24 (the 3D family) no longer keeps a route of its own: its
    mma.sync kernels are retired and it takes the wgmma family's."""
    assert A.attention_route(dtype, 24) == "wgmma"


@pytest.mark.parametrize("d", A.SUPPORTED_HEAD_DIMS)
def test_the_route_names_its_entry_points(d):
    """Each dtype and head dim reaches the C entry point of the one family,
    by dtype."""
    lib = SimpleNamespace(**{f"attention_{x}_wgmma_{t}": (x, t) for x in ("fwd", "bwd")
                             for t in ("f32", "bf16")})
    for dtype, t in zip(DTYPES, ("f32", "bf16")):
        for x in ("fwd", "bwd"):
            assert A._entry(lib, x, dtype, d) == (x, t)


def test_the_route_refuses_what_neither_kernel_takes():
    with pytest.raises(ValueError, match="head dim 32"):
        A.attention_route(torch.float32, 32)
    with pytest.raises(TypeError):
        A.attention_route(torch.float16, 64)


def _heads(t, h):
    B, T, C = t.shape
    return t.reshape(B, T, h, C // h).transpose(1, 2).reshape(B * h, T, C // h)


def _packed(t, B):
    BH, T, d = t.shape
    return t.reshape(B, BH // B, T, d).transpose(1, 2).reshape(B, T, BH // B * d)


def _jax_packed(qkv, h, scale):
    """fused_attention_packed (interpret mode) on packed fp32 qkv."""
    q, k, v = (jnp.asarray(t) for t in np.split(qkv, 3, axis=-1))
    return np.asarray(fused_attention_packed(q, k, v, h, scale, interpret=True))


# ---------------------------------------------------------------------------
# On the card: the wgmma kernels against their plain versions.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# fp32: summation order (1e-4 forward; 1e-4 of the largest gradient). bf16:
# per element within `bf16_tolerances` / `bf16_bwd_tolerances` of the plain
# version (rounding p and ds to bf16, then one rounding of each output), as
# chip_smoke holds them. (B, T, heads, D): ragged tiles, sequences shorter
# than a tile (7 and 16 tokens), and both forward block shapes: one
# consumer warpgroup while the blocks of 64 query rows fit the 132 SMs, two
# past that (B=140 at T=7: a second warpgroup with no valid row; B=24 at
# T=384). Head dim 24, one head: packed at T <= 64 (9, 32, 4 and 1 sequences
# a tile, B not a multiple of them: the last tile's missing sequences and
# the rows past G*T), tiled at 65 and 256.
WGMMA_CUDA_CASES = [(2, 64, 2, 64), (2, 100, 2, 64), (2, 7, 2, 64), (3, 16, 1, 192),
                    (2, 256, 1, 96), (2, 128, 2, 128), (2, 200, 1, 192), (140, 7, 1, 96),
                    (24, 384, 1, 128), (70, 7, 1, 24), (33, 2, 1, 24), (5, 16, 1, 24),
                    (3, 33, 1, 24), (2, 64, 1, 24), (2, 65, 1, 24), (2, 256, 1, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_wgmma_kernels_match_plain(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, T, h, d in WGMMA_CUDA_CASES:
        assert A.attention_route(dtype, d) == "wgmma"
        scale, C = d ** -0.5, h * d
        what = f"B={B} T={T} h={h} D={d}"
        qkv = torch.randn(B, T, 3 * C, generator=g, device=cuda).to(dtype)
        dy = torch.randn(B, T, C, generator=g, device=cuda).to(dtype)
        want = A.attention_packed_reference(qkv, h, scale)
        tol = (1e-4, 0.0) if dtype == torch.float32 else A.bf16_tolerances(qkv, h, scale)["plain"]
        ops.reset_launches()
        got = A.attention_packed(qkv, h, scale)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["attention_fwd"] == 1
        err = (got.float() - want.float()).abs()
        assert bool((err <= tol[0] + tol[1] * want.float().abs()).all()), \
            f"{what}: max err {float(err.max())}"
        o, lse = A.attention_packed_fwd(qkv, h, scale, True)
        once = A.attention_packed_bwd(qkv, o, lse, dy, h, scale)
        assert torch.equal(once, A.attention_packed_bwd(qkv, o, lse, dy, h, scale)), what
        ref = A.attention_packed_bwd_reference(qkv, dy, h, scale)
        if dtype == torch.float32:
            for i in range(3):
                a, b = (t[..., i * C:(i + 1) * C] for t in (once, ref))
                assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), what
        else:
            atol, rtol = A.bf16_bwd_tolerances(qkv, dy, h, scale)["plain"]
            err = (once.float() - ref.float()).abs()
            assert bool((err <= atol + rtol * ref.float().abs()).all()), \
                f"{what}: per-element max err {float(err.max())}"


# The bf16 forward's key tile (64 keys: the running max moves once a tile,
# and p is rounded against it), as the emulation walks it over several
# tiles and a ragged last one, against the Pallas entry on the same bf16
# values, per element: rounding p to bf16 moves an output by at most 2^-8
# sum_j p_j |v_j| / l, on each side (the Pallas kernel rounds the normalised
# p), plus two bf16 steps relative.
@pytest.mark.parametrize("d", [24, 64, 96])
def test_bf16_emulation_over_many_key_tiles_against_pallas(d):
    assert A.TC_KEYS_PER_TILE == 64
    B, h, T = 2, 1, 320   # five 64-key tiles
    scale = d ** -0.5
    rng = np.random.RandomState(30 + d)
    qkv = torch.from_numpy(rng.randn(B, T, 3 * h * d).astype(np.float32)).to(torch.bfloat16)
    q, k, v = (_heads(t, h) for t in qkv.split(h * d, dim=-1))
    got = _packed(A.attention_tc_emulation(q, k, v, scale), B).float().numpy()
    want = _jax_packed(qkv.float().numpy(), h, scale)
    atol, rtol = A.bf16_tolerances(qkv, h, scale)["plain"]
    bound = 2 * atol.numpy() + rtol * np.abs(want)
    err = np.abs(got - want)
    assert (err <= bound).all(), f"max err {err.max()}, worst margin {(err / bound).max()}"
