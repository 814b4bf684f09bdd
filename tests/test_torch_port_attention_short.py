"""Head dim 24's short sequences on the packed form of the attention kernels.

The 3D family's attention (one head of D=24 over 7 or 2 frames and over 16
or 256 space tokens) takes the wgmma kernels in two forms that
`ops.attention.attention_plan` picks: T <= 64 "packed", G = 64 // T whole
sequences in a 64-row tile with every key outside a query's own sequence
masked; T > 64 "tiled". On the CPU these tests hold

  * the plan at every attention call of `smmnist_DDPM_small5_3d.yml` and its
    pseudo-3D twin (read by `tools.gn_calls.model_calls`) and at the main
    path's head dims;
  * a plain emulation of packed tiles (the sequences laid into 64 rows, the
    rows past the batch and past G*T zero, the block-diagonal mask) against
    the kernels' emulations run one sequence at a time, bit for bit, in bf16
    (`attention_tc_emulation`, `attention_bwd_tc_emulation`) and 3xTF32
    (`attention_tf32x3_emulation`, `attention_bwd_tf32x3_emulation`),
    forward and VJP;
  * the same packed emulation against the JAX package's
    `fused_attention_packed` and its custom VJP (Pallas, interpret mode) on
    packed (B, T, 72) qkv, at the tolerances of the per-sequence tests in
    `tests/test_torch_port_ops.py`.

The `cuda` tests hold the kernels on the card (the plan the library takes,
and the packed kernels against their emulation and plain versions) and skip
without one; on the card machine (no jax) they run with `python -m pytest
--noconftest tests/test_torch_port_attention_route.py
tests/test_torch_port_attention_short.py -m cuda`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mcvd_tpu_torch import ops
from mcvd_tpu_torch.config import load_config
from mcvd_tpu_torch.ops import attention as A
from mcvd_tpu_torch.tools.gn_calls import model_calls

try:
    import jax
    import jax.numpy as jnp

    from mcvd_tpu.ops.lab.attention import fused_attention_packed
except ImportError:  # no jax: only the `cuda` tests can run
    jax = None

DTYPES = [torch.float32, torch.bfloat16]
TORCH_THREADS = 2
CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "smmnist_DDPM_small5_3d.yml")
ARCHS = {"3d": [], "pseudo3d": ["model.arch=unetmorepseudo3d"]}
SCALE = 24 ** -0.5
# (T, B): B not a multiple of G = 64 // T where G > 1, so the last tile holds
# fewer sequences; T = 33 and 64 one sequence a tile, rows past T zero.
SHORT = [(2, 65), (7, 19), (16, 9), (33, 3), (64, 3)]


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jax is None and "cuda" not in request.keywords:
        pytest.skip("needs jax: the JAX package is the reference")


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's packed entry (interpret mode on the CPU) and its
    VJP, on packed fp32 numpy qkv (one head of 24)."""

    def fwd(qkv):
        q, k, v = (jnp.asarray(t) for t in np.split(qkv, 3, axis=-1))
        return np.asarray(fused_attention_packed(q, k, v, 1, SCALE, interpret=True))

    def vjp(qkv, g):
        q, k, v = (jnp.asarray(t) for t in np.split(qkv, 3, axis=-1))
        _, back = jax.vjp(lambda q, k, v: fused_attention_packed(q, k, v, 1, SCALE,
                                                                 interpret=True), q, k, v)
        return np.concatenate([np.asarray(t) for t in back(jnp.asarray(g))], -1)

    return fwd, vjp


def expected_plan(d, T, B, H):
    if d == 24 and T <= 64:
        G = 64 // T
        return A.AttentionPlan("packed", G, H * -(-B // G))
    return A.AttentionPlan("tiled", 1, H * B * -(-T // 64))


def calls_3d(arch, batch):
    return model_calls(load_config(CONFIG, ARCHS[arch]), batch)[1]


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [4, 64, 1000])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_3d_attention_call_takes_its_plan(arch, batch):
    """Packed with G = 64 // T at the time attention (7 and 2 frames) and the
    4x4 space attention (16 tokens), tiled at the 16x16 space attention (256
    tokens), in both dtypes."""
    calls = calls_3d(arch, batch)
    assert sorted({a["T"] for a in calls}) == [2, 7, 16, 256]
    for a in calls:
        assert a["D"] == 24 and a["heads"] == 1
        want = expected_plan(24, a["T"], a["B"], 1)
        for dtype in DTYPES:
            assert A.attention_plan(dtype, 24, a["T"], a["B"], 1) == want, a
        assert want.form == ("packed" if a["T"] <= 64 else "tiled")


@pytest.mark.parametrize("d", [64, 96, 128, 192])
def test_the_main_path_head_dims_stay_tiled(d):
    for T in (2, 7, 16, 64, 100, 1024):
        for dtype in DTYPES:
            assert A.attention_plan(dtype, d, T, 16, 2) == expected_plan(d, T, 16, 2)
            assert A.attention_plan(dtype, d, T, 16, 2).form == "tiled"


# ---------------------------------------------------------------------------
# The packed tile, emulated
# ---------------------------------------------------------------------------


def pack_tiles(t, T):
    """(B, T, D) sequences -> (tiles, 64, D): G = 64 // T whole sequences a
    tile, rows g*T + t, zeros for the sequences past B and the rows past G*T
    (what the kernel's tiles hold)."""
    B, _, D = t.shape
    G = 64 // T
    n = -(-B // G)
    full = torch.zeros(n * G, T, D, dtype=t.dtype)
    full[:B] = t
    tiles = full.reshape(n, G * T, D)
    return torch.cat([tiles, torch.zeros(n, 64 - G * T, D, dtype=t.dtype)], dim=1)


def unpack_tiles(t, B, T):
    """The inverse of `pack_tiles` on (tiles, 64, ...): the B sequences."""
    G = 64 // T
    return t[:, :G * T].reshape(t.shape[0] * G, T, *t.shape[2:])[:B]


def tile_mask(B, T):
    """(tiles, 64, 64): key c for query r where both rows hold one sequence
    of the batch (the kernel's block-diagonal mask; the rows of the missing
    sequences and past G*T take no key)."""
    G = 64 // T
    n = -(-B // G)
    seq = torch.arange(64) // T
    real = (seq < G)[None] & (torch.arange(n)[:, None] * G + seq[None] < B)
    return (seq[:, None] == seq[None])[None] & real[:, :, None] & real[:, None, :]


def packed_emulation(arithmetic, q, k, v, g=None, o=None, lse=None):
    """The kernels' emulation (`arithmetic` "bf16" or "tf32x3") on packed
    tiles of one head's (B, T, 24) q, k, v: forward (o and, in bf16, lse) or,
    with the output gradient g, the VJP (dq, dk, dv; bf16 from the forward's
    o and lse, packed with zeros where the tiles hold no sequence)."""
    B, T, _ = q.shape
    mask = tile_mask(B, T)
    qp, kp, vp = (pack_tiles(t, T) for t in (q, k, v))
    if arithmetic == "tf32x3":
        if g is None:
            return unpack_tiles(A.attention_tf32x3_emulation(qp, kp, vp, SCALE, mask), B, T)
        grads = A.attention_bwd_tf32x3_emulation(qp, kp, vp, pack_tiles(g, T), SCALE, mask)
        return tuple(unpack_tiles(t, B, T) for t in grads)
    if g is None:
        op, lsep = A.attention_tc_emulation(qp, kp, vp, SCALE, want_lse=True, mask=mask)
        return unpack_tiles(op, B, T), unpack_tiles(lsep, B, T)
    lsep = pack_tiles(lse[..., None], T)[..., 0]
    grads = A.attention_bwd_tc_emulation(qp, kp, vp, pack_tiles(g, T), SCALE,
                                         o=pack_tiles(o, T), lse=lsep, mask=mask)
    return tuple(unpack_tiles(t, B, T) for t in grads)


def short_inputs(T, B, seed, dtype):
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(B, T, 72).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.randn(B, T, 24).astype(np.float32)).to(dtype)
    return qkv, dy


def test_packed_tiles_hold_whole_sequences():
    """pack/unpack are inverse, the mask is block-diagonal within the batch,
    and the rows past G*T and past the batch are zero."""
    for T, B in SHORT:
        x = torch.randn(B, T, 3)
        tiles = pack_tiles(x, T)
        G = 64 // T
        assert tiles.shape == (-(-B // G), 64, 3)
        assert torch.equal(unpack_tiles(tiles, B, T), x)
        assert not tiles[:, G * T:].any()
        assert not tiles[:, :G * T].reshape(-1, T, 3)[B:].any()
        m = tile_mask(B, T)
        assert int(m.sum()) == B * T * T


@pytest.mark.parametrize("direction", ["fwd", "vjp"])
@pytest.mark.parametrize("arithmetic", ["bf16", "tf32x3"])
@pytest.mark.parametrize("T,B", SHORT)
def test_packed_emulation_is_bit_equal_to_one_sequence_at_a_time(T, B, arithmetic, direction):
    """Each sequence of a packed tile gets the bits the emulation gives it
    alone: the masked p are exact zeros, the row max and the bf16 rounding
    of p are the sequence's, and every product and row sum is rounded once."""
    dtype = torch.bfloat16 if arithmetic == "bf16" else torch.float32
    qkv, dy = short_inputs(T, B, 50 + T, dtype)
    q, k, v = qkv.split(24, dim=-1)
    if arithmetic == "tf32x3":
        if direction == "fwd":
            want = (A.attention_tf32x3_emulation(q, k, v, SCALE),)
            got = (packed_emulation("tf32x3", q, k, v),)
        else:
            want = A.attention_bwd_tf32x3_emulation(q, k, v, dy, SCALE)
            got = packed_emulation("tf32x3", q, k, v, g=dy)
    else:
        o, lse = A.attention_tc_emulation(q, k, v, SCALE, want_lse=True)
        if direction == "fwd":
            want, got = (o, lse), packed_emulation("bf16", q, k, v)
        else:
            want = A.attention_bwd_tc_emulation(q, k, v, dy, SCALE, o=o, lse=lse)
            got = packed_emulation("bf16", q, k, v, g=dy, o=o, lse=lse)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), f"max diff {float((a.float() - b.float()).abs().max())}"


@pytest.mark.parametrize("direction", ["fwd", "vjp"])
@pytest.mark.parametrize("arithmetic", ["bf16", "tf32x3"])
@pytest.mark.parametrize("T,B", SHORT)
def test_packed_emulation_matches_pallas(T, B, arithmetic, direction, pallas):
    """Against `fused_attention_packed` (interpret mode) on the same values:
    bf16 forward per element within twice `bf16_tolerances`' "plain" bound
    (the Pallas kernel rounds its normalised p too) plus two bf16 steps;
    bf16 VJP within `bf16_bwd_tolerances`' "plain" bound (the JAX VJP's
    gradients are fp32); 3xTF32 within atol 1e-5 of the fp32 forward and
    VJP."""
    pallas_fwd, pallas_vjp = pallas
    dtype = torch.bfloat16 if arithmetic == "bf16" else torch.float32
    qkv, dy = short_inputs(T, B, 60 + T, dtype)
    q, k, v = qkv.split(24, dim=-1)
    x, gy = qkv.float().numpy(), dy.float().numpy()
    if direction == "fwd":
        got = packed_emulation(arithmetic, q, k, v)
        got = got[0] if arithmetic == "bf16" else got
        want = pallas_fwd(x)
    else:
        o, lse = A.attention_tc_emulation(q, k, v, SCALE, want_lse=True) \
            if arithmetic == "bf16" else (None, None)
        got = torch.cat(packed_emulation(arithmetic, q, k, v, g=dy, o=o, lse=lse), dim=-1)
        want = pallas_vjp(x, gy)
    got = got.float().numpy()
    if arithmetic == "tf32x3":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    if direction == "fwd":
        atol, rtol = A.bf16_tolerances(qkv, 1, SCALE)["plain"]
        bound = 2 * atol.numpy() + rtol * np.abs(want)
    else:
        atol, rtol = A.bf16_bwd_tolerances(qkv, dy, 1, SCALE)["plain"]
        bound = atol.numpy() + rtol * np.abs(want)
    err = np.abs(got - want)
    assert (err <= bound).all(), f"max err {err.max()}, worst margin {(err / bound).max()}"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 64, 1000])
def test_the_library_takes_the_plan(cuda, batch):
    """The C++ `plan_of` (through `ops.attention.kernel_plan`) agrees with
    `attention_plan` at every 3D-model call and at the main path's head
    dims."""
    shapes = {(a["D"], a["T"], a["B"], a["heads"]) for arch in ARCHS
              for a in calls_3d(arch, batch)}
    shapes |= {(d, T, batch, 2) for d in (64, 96, 128, 192) for T in (7, 64, 1024)}
    for d, T, B, H in sorted(shapes):
        assert A.kernel_plan(d, T, B, H) == A.attention_plan(torch.float32, d, T, B, H)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_packed_kernels_match_their_emulation(cuda, dtype):
    """The packed kernels (one launch each way) at SHORT's shapes: fp32
    within 1e-4 of the plain version forward and 1e-4 of the largest
    gradient; bf16 per element within the "emulation" bounds of
    `bf16_tolerances` and `bf16_bwd_tolerances` against the emulation run one
    sequence at a time on the kernel's own output and logsumexp; the
    backward bit-identical over two calls."""
    for T, B in SHORT:
        qkv, dy = (t.to(cuda) for t in short_inputs(T, B, 70 + T, dtype))
        assert A.attention_plan(dtype, 24, T, B).form == "packed"
        ops.reset_launches()
        o, lse = A.attention_packed_fwd(qkv, 1, SCALE, True)
        dqkv = A.attention_packed_bwd(qkv, o, lse, dy, 1, SCALE)
        assert torch.equal(dqkv, A.attention_packed_bwd(qkv, o, lse, dy, 1, SCALE))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["attention_fwd"] == 1 and ops.LAUNCHES["attention_bwd"] == 2
        what = f"T={T} B={B} {dtype}"
        if dtype == torch.float32:
            want = A.attention_packed_reference(qkv, 1, SCALE)
            assert float((o - want).abs().max()) <= 1e-4, what
            ref = A.attention_packed_bwd_reference(qkv, dy, 1, SCALE)
            for i in range(3):
                a, b = (t[..., 24 * i:24 * (i + 1)] for t in (dqkv, ref))
                assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), what
            continue
        q, k, v = qkv.split(24, dim=-1)
        emu = A.attention_tc_emulation(q, k, v, SCALE)
        atol, rtol = A.bf16_tolerances(qkv, 1, SCALE)["emulation"]
        err = (o.float() - emu.float()).abs()
        assert bool((err <= atol + rtol * emu.float().abs()).all()), what
        emu = torch.cat(A.attention_bwd_tc_emulation(q, k, v, dy, SCALE, o=o, lse=lse[:, 0]),
                        dim=-1)
        atol, rtol = A.bf16_bwd_tolerances(qkv, dy, 1, SCALE, o=o, lse=lse[:, 0])["emulation"]
        err = (dqkv.float() - emu.float()).abs()
        assert bool((err <= atol + rtol * emu.float().abs()).all()), what
