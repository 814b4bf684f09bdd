"""The port's legacy ncsn family against the JAX package on the same numpy
weights and inputs: the InstanceNorm++ zoo (`models/normalization.py`), the
RefineNet blocks (`models/legacy_blocks.py`, also against upstream's goldens
in `tests/golden/legacy_blocks.npz`), and every shipped config built by
`models.build` at a tiny width. The models themselves (NCSNv2 / Deeper /
Deepest and NCSNv1 at sizes that take each dispatch, the GroupNorm option,
one fp32 DSM step) are `test_torch_port_ncsnv2_models.py`'s, which shares
this file's helpers (one file each, so `--dist loadfile` runs them apart).

The JAX side is never initialised: `jax.eval_shape` of its init gives the
tree, numpy fills it from a seed, and the port takes the same tree through
the weight bridge (layout "ncsn"); the JAX forward is jitted (a third of
the eager forward's compile time here). On the CPU the GroupNorm takes its plain
version. Tolerances (fp32 on both sides, sums in another order): a norm or
block within rtol 1e-4 / atol 1e-5, a model within 1e-4 of its largest
output, upstream's goldens at the JAX golden test's rtol 2e-4 / atol 2e-4."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.models import legacy_blocks as jlb
from mcvd_tpu.models import normalization as jnorm
from mcvd_tpu_torch.compat import torch_state_dict_from_flax
from mcvd_tpu_torch.config import load_config
from mcvd_tpu_torch.models import build
from mcvd_tpu_torch.models import legacy_blocks as lb
from mcvd_tpu_torch.models import normalization as norm
from mcvd_tpu_torch.models.layers import init_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "legacy_blocks.npz")
TORCH_THREADS = 2
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_REL = 1e-4
GOLDEN_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def np_params(module, seed, *args, static=()):
    """A flax param tree for `module` on `args` and then the static `static`
    (shapes from eval_shape), filled from numpy: kernels N(0, 1/fan_in),
    GroupNorm scales 1 + N(0, 0.1^2), the rest (biases, the norms' stored
    scales and class tables) N(0, 0.05^2)."""
    shapes = jax.eval_shape(lambda k, *a: module.init(k, *a, *static),
                            jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(
                np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.05 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def port_with(module, params):
    """`module` with the flax tree loaded strictly through the bridge."""
    module.load_state_dict(torch_state_dict_from_flax(params, "ncsn"), strict=True)
    return module.eval()


# ------------------------------------------------------------ normalizations

NORMS = {  # id: (JAX module, port module, conditional)
    "instance_plus": (lambda: jnorm.InstanceNorm2dPlus(6),
                      lambda: norm.InstanceNorm2dPlus(6), False),
    "instance_plus_nobias": (lambda: jnorm.InstanceNorm2dPlus(6, bias=False),
                             lambda: norm.InstanceNorm2dPlus(6, bias=False), False),
    "cond_instance_plus": (lambda: jnorm.ConditionalInstanceNorm2dPlus(6, 5),
                           lambda: norm.ConditionalInstanceNorm2dPlus(6, 5), True),
    "cond_instance_plus_nobias": (
        lambda: jnorm.ConditionalInstanceNorm2dPlus(6, 5, bias=False),
        lambda: norm.ConditionalInstanceNorm2dPlus(6, 5, bias=False), True),
    "variance": (lambda: jnorm.VarianceNorm2d(6), lambda: norm.VarianceNorm2d(6), False),
}


@pytest.mark.parametrize("name", list(NORMS))
def test_norm_matches_jax(name):
    jmod, pmod, cond = NORMS[name]
    rng = np.random.RandomState(1)
    x = (3.0 * rng.randn(2, 5, 7, 6) + rng.randn(1, 1, 1, 6)).astype(np.float32)
    y = np.array([4, 1], np.int32)
    args = (jnp.asarray(x), jnp.asarray(y)) if cond else (jnp.asarray(x),)
    params = np_params(jmod(), 2, *args)
    want = np.asarray(jax.jit(jmod().apply)({"params": params}, *args))
    mod = port_with(pmod(), params)
    with torch.no_grad():
        got = mod(nchw(x), torch.from_numpy(y).long()) if cond else mod(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, **BLOCK_TOL)


def test_instance_norm_plus_statistics_and_storage():
    """The instance variance is biased and the variance across channel means
    unbiased, as written out in numpy; the stored scales are zero-centred
    (zeros give the scale 1), and init draws them N(0, 0.02^2)."""
    rng = np.random.RandomState(3)
    x = (2.0 * rng.randn(2, 6, 5, 7) + rng.randn(1, 6, 1, 1)).astype(np.float32)
    m = x.mean(axis=(2, 3), keepdims=True)
    inorm = (x - m) / np.sqrt(x.var(axis=(2, 3), keepdims=True, ddof=0) + 1e-5)
    means = x.mean(axis=(2, 3))
    mn = (means - means.mean(-1, keepdims=True)) / np.sqrt(
        means.var(-1, keepdims=True, ddof=1) + 1e-5)
    mod = norm.InstanceNorm2dPlus(6)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, inorm + mn[:, :, None, None], rtol=1e-5, atol=1e-5)
    init_weights(mod, torch.Generator().manual_seed(0))
    big = norm.ConditionalInstanceNorm2dPlus(64, 100)
    init_weights(big, torch.Generator().manual_seed(0))
    for t in (mod.alpha, mod.gamma, big.embed.weight):
        assert abs(float(t.mean())) < 0.02 and 0.01 < float(t.detach().std()) < 0.03
    assert float(big.embed.weight.detach().std()) == pytest.approx(0.02, rel=0.05)
    assert float(mod.beta.detach().abs().max()) == 0.0


# ------------------------------------------------------------------- blocks

def _cnorm(c):
    return norm.ConditionalInstanceNorm2dPlus(c, 5)


JN = jnorm.ConditionalInstanceNorm2dPlus
BLOCKS = {  # id: (JAX module, port module, input shapes NHWC, conditional, size arg)
    "conv_mean_pool": (lambda: jlb.ConvMeanPool(6, 3), lambda: lb.ConvMeanPool(4, 6, 3),
                       [(2, 8, 8, 4)], False, None),
    "conv_mean_pool_adjust": (lambda: jlb.ConvMeanPool(6, 3, adjust_padding=True),
                              lambda: lb.ConvMeanPool(4, 6, 3, adjust_padding=True),
                              [(2, 7, 7, 4)], False, None),
    "mean_pool_conv": (lambda: jlb.MeanPoolConv(6, 3), lambda: lb.MeanPoolConv(4, 6, 3),
                       [(2, 8, 8, 4)], False, None),
    "upsample_conv_c4": (lambda: jlb.UpsampleConv(6, 3), lambda: lb.UpsampleConv(4, 6, 3),
                         [(2, 5, 5, 4)], False, None),
    "upsample_conv_c6": (lambda: jlb.UpsampleConv(4, 3), lambda: lb.UpsampleConv(6, 4, 3),
                         [(2, 5, 5, 6)], False, None),
    "crp_max": (lambda: jlb.CRPBlock(8, 2), lambda: lb.CRPBlock(8, 2), [(2, 7, 7, 8)],
                False, None),
    "crp_avg": (lambda: jlb.CRPBlock(8, 3, maxpool=False),
                lambda: lb.CRPBlock(8, 3, maxpool=False), [(2, 6, 6, 8)], False, None),
    "cond_crp": (lambda: jlb.CondCRPBlock(8, 2, 5, JN), lambda: lb.CondCRPBlock(8, 2, _cnorm),
                 [(2, 6, 6, 8)], True, None),
    "rcu": (lambda: jlb.RCUBlock(8, 2, 2), lambda: lb.RCUBlock(8, 2, 2), [(2, 6, 6, 8)],
            False, None),
    "cond_rcu": (lambda: jlb.CondRCUBlock(8, 2, 2, 5, JN),
                 lambda: lb.RCUBlock(8, 2, 2, normalizer=_cnorm), [(2, 6, 6, 8)], True, None),
    "msf": (lambda: jlb.MSFBlock(6, 2), lambda: lb.MSFBlock([4, 8], 6),
            [(2, 8, 8, 4), (2, 4, 4, 8)], False, (8, 8)),
    "cond_msf": (lambda: jlb.CondMSFBlock(6, 2, 5, JN), lambda: lb.MSFBlock([4, 8], 6, _cnorm),
                 [(2, 8, 8, 4), (2, 4, 4, 8)], True, (8, 8)),
    "refine2": (lambda: jlb.RefineBlock(6, 2), lambda: lb.RefineBlock([4, 8], 6),
                [(2, 8, 8, 4), (2, 4, 4, 8)], False, (8, 8)),
    "refine1_end": (lambda: jlb.RefineBlock(8, 1, end=True, maxpool=False),
                    lambda: lb.RefineBlock([8], 8, end=True, maxpool=False),
                    [(2, 6, 6, 8)], False, (6, 6)),
    "cond_refine2": (lambda: jlb.CondRefineBlock(6, 2, 5, JN),
                     lambda: lb.RefineBlock([4, 8], 6, normalizer=_cnorm),
                     [(2, 8, 8, 4), (2, 4, 4, 8)], True, (8, 8)),
    "res_plain_same": (lambda: jlb.ResidualBlock(8, 8), lambda: lb.ResidualBlock(8, 8),
                       [(2, 8, 8, 8)], False, None),
    "res_plain_wide": (lambda: jlb.ResidualBlock(4, 8), lambda: lb.ResidualBlock(4, 8),
                       [(2, 8, 8, 4)], False, None),
    "res_down": (lambda: jlb.ResidualBlock(4, 8, resample="down"),
                 lambda: lb.ResidualBlock(4, 8, resample="down"), [(2, 8, 8, 4)], False, None),
    "res_down_adjust": (lambda: jlb.ResidualBlock(4, 8, resample="down", adjust_padding=True),
                        lambda: lb.ResidualBlock(4, 8, resample="down", adjust_padding=True),
                        [(2, 7, 7, 4)], False, None),
    "cond_res_plain_same": (lambda: jlb.ConditionalResidualBlock(8, 8, 5),
                            lambda: lb.ResidualBlock(8, 8, num_classes=5), [(2, 8, 8, 8)],
                            True, None),
    "cond_res_down": (lambda: jlb.ConditionalResidualBlock(4, 8, 5, resample="down"),
                      lambda: lb.ResidualBlock(4, 8, resample="down", num_classes=5),
                      [(2, 8, 8, 4)], True, None),
    # the dilated branches (no golden: upstream's are shape-broken)
    "res_dil_down": (lambda: jlb.ResidualBlock(4, 8, resample="down", dilation=2),
                     lambda: lb.ResidualBlock(4, 8, resample="down", dilation=2),
                     [(2, 8, 8, 4)], False, None),
    "res_dil_wide": (lambda: jlb.ResidualBlock(4, 8, dilation=4),
                     lambda: lb.ResidualBlock(4, 8, dilation=4), [(2, 9, 9, 4)], False, None),
    "res_dil_same": (lambda: jlb.ResidualBlock(8, 8, dilation=2),
                     lambda: lb.ResidualBlock(8, 8, dilation=2), [(2, 8, 8, 8)], False, None),
    "cond_res_dil_down": (lambda: jlb.ConditionalResidualBlock(4, 8, 5, resample="down",
                                                               dilation=2),
                          lambda: lb.ResidualBlock(4, 8, resample="down", dilation=2,
                                                   num_classes=5),
                          [(2, 8, 8, 4)], True, None),
}


def _block_call(xs, y, size, jax_side):
    """The block's arguments: JAX (x or xs, [y]) (a list block's size comes
    after, as a static argument); the port's list blocks (xs, size, [y]),
    the others (x, [y])."""
    ys = [] if y is None else [y]
    if size is None:
        return [xs[0]] + ys
    return [xs] + ys if jax_side else [xs, size] + ys


@pytest.mark.parametrize("name", list(BLOCKS))
def test_legacy_block_matches_jax(name):
    jmod, pmod, shapes, cond, size = BLOCKS[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    y = np.array([3, 0], np.int32) if cond else None
    jargs = _block_call([jnp.asarray(x) for x in xs], None if y is None else jnp.asarray(y),
                        size, True)
    static = () if size is None else (size,)
    params = np_params(jmod(), 7, *jargs, static=static)
    jm = jmod()
    want = np.asarray(jax.jit(lambda p, *a: jm.apply(p, *a, *static))({"params": params}, *jargs))
    mod = port_with(pmod(), params)
    targs = _block_call([nchw(x) for x in xs], None if y is None else torch.from_numpy(y).long(),
                        size, False)
    with torch.no_grad():
        got = mod(*targs)
    np.testing.assert_allclose(nhwc(got), want, **BLOCK_TOL)


def golden_state_dict(sd):
    """An upstream state dict of the goldens in the port's names and storage:
    `convs.i`, `norms.i`, `adapt_convs.i` become `_i` names, the adjust pad's
    Sequential index goes, InstanceNorm++ scales lose their 1.0 and the class
    tables their concat([ones(2C), zeros(C)])."""
    out = {}
    for key, v in sd.items():
        segs, parts = key.split("."), []
        for s in segs:
            if s.isdigit() and parts and parts[-1] in ("convs", "norms", "adapt_convs"):
                parts[-1] = f"{parts[-1]}_{s}"
            elif s.isdigit() and parts and parts[-1] == "conv":
                continue
            else:
                parts.append(s)
        v = np.asarray(v, np.float32)
        if parts[-1] in ("alpha", "gamma"):
            v = v - 1.0
        elif parts[-2:] == ["embed", "weight"]:
            C = v.shape[1] // 3
            v = v - np.concatenate([np.ones(2 * C), np.zeros(C)]).astype(np.float32)
        out[".".join(parts)] = torch.from_numpy(v)
    return out


GOLDEN_CASES = sorted(n for n in BLOCKS if "_dil" not in n)


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_legacy_block_matches_upstream_golden(name):
    _, pmod, _, cond, size = BLOCKS[name]
    z = np.load(GOLDEN)
    rec = {k.split("::", 1)[1]: z[k] for k in z.files if k.startswith(name + "::")}
    sd = {k[4:]: v for k, v in rec.items() if k.startswith("sd::")}
    xs = [torch.from_numpy(rec[f"x{i}"]) for i in range(8) if f"x{i}" in rec]
    mod = pmod()
    mod.load_state_dict(golden_state_dict(sd), strict=True)
    y = torch.from_numpy(rec["y"]).long() if cond else None
    with torch.no_grad():
        got = mod.eval()(*_block_call(xs, y, size, False))
    np.testing.assert_allclose(got.numpy(), rec["out"], **GOLDEN_TOL)


def test_pools_and_resize_match_jax():
    """The 5x5 pools (count_include_pad) and the align_corners resize against
    the JAX package's reduce_window and interpolation matrices."""
    x = np.random.RandomState(5).randn(2, 7, 9, 3).astype(np.float32)
    for jf, pf in ((jlb.max_pool_5x5, lb.max_pool_5x5), (jlb.avg_pool_5x5, lb.avg_pool_5x5)):
        np.testing.assert_allclose(nhwc(pf(nchw(x))), np.asarray(jf(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    for size in ((14, 18), (3, 4), (7, 9), (1, 5)):
        np.testing.assert_allclose(
            nhwc(lb.interpolate_bilinear_align(nchw(x), size)),
            np.asarray(jlb.interpolate_bilinear_align(jnp.asarray(x), size)),
            rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- models

def ncsn_dict(arch="ncsnv2", size=32, ngf=4, normalization="InstanceNorm++", **data):
    return {"data": {"channels": 3, "image_size": size, "num_frames": 1,
                     "num_frames_cond": 0, "num_frames_future": 0, "logit_transform": False,
                     "rescaled": False, "dataset": "CIFAR10", "uniform_dequantization": False,
                     "gaussian_dequantization": False, "prob_mask_cond": 0.0, **data},
            "model": {"arch": arch, "ngf": ngf, "num_classes": 5, "version": "SMLD",
                      "sigma_dist": "geometric", "sigma_begin": 50.0, "sigma_end": 0.01,
                      "normalization": normalization, "nonlinearity": "elu",
                      "dropout": 0.0, "ema": False, "gamma": False, "noise_in_cond": False,
                      "output_all_frames": False},
            "optim": {"optimizer": "Adam", "lr": 2e-4, "beta1": 0.9, "eps": 1e-8,
                      "weight_decay": 0.0, "warmup": 0, "grad_clip": 1.0, "amsgrad": False},
            "training": {"L1": False, "compute_dtype": "float32"}}


# ------------------------------------------------------------- the configs

CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))


def tiny_mods(config):
    """Mods that cut a shipped config to a tiny width (the legacy UNet's 32
    GroupNorm groups need ngf 32)."""
    arch = config.model.arch
    mods = {"unet": ["model.ngf=32"], "ncsn": ["model.ngf=4"], "ncsnv2": ["model.ngf=4"]}
    return mods.get(arch, ["model.ngf=4", "model.num_res_blocks=1",
                           "model.n_head_channels=4", "model.spade_dim=4"])


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_every_shipped_config_builds(path):
    """`models.build` builds all 20 shipped configs (the list of
    `tests/test_configs.py`), and the tiny model evaluates once (B=1) to the
    predicted frames' shape, finite. (At B=1 a Conv3d's output came back
    NCHW-contiguous, which the GroupNorm refuses: `layers.nchw_unfold`.)"""
    assert len(CONFIGS) == 20
    config = load_config(path, tiny_mods(load_config(path)))
    model = build(config)
    init_weights(model, torch.Generator().manual_seed(0))
    d = config.data
    fc = d.num_frames_cond + getattr(d, "num_frames_future", 0)
    B, sz = 1, d.image_size
    x = torch.rand(B, d.channels * d.num_frames, sz, sz).contiguous(
        memory_format=torch.channels_last)
    cond = torch.rand(B, d.channels * fc, sz, sz) if fc else None
    cond_mask = (torch.ones(B, dtype=torch.int32)
                 if getattr(config.model, "cond_emb", False) else None)
    kw = {"cond_noise": torch.zeros_like(cond)} if (
        getattr(config.model, "noise_in_cond", False) and cond is not None) else {}
    with torch.no_grad():
        out = model.eval()(x, torch.zeros(B, dtype=torch.long), cond, cond_mask, **kw)
    frames = d.num_frames + (fc if getattr(config.model, "output_all_frames", False) else 0)
    assert out.shape == (B, d.channels * frames, sz, sz)
    assert bool(torch.isfinite(out).all())


def test_plain_group_norm_computes_fp64_in_fp64():
    """The plain GroupNorm (the CPU's, and the card's under
    `reference_ops()`) takes fp64 and computes in it, forward and backward,
    so an fp64 step can witness the fp32 steps' rounding (`chip_smoke.py`
    smld); fp32 agrees with it to fp32's rounding, and other dtypes still
    raise."""
    from mcvd_tpu_torch import ops

    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(2, 8, 5, 5)).contiguous(memory_format=torch.channels_last)
    gamma, beta = (torch.from_numpy(rng.randn(8)) for _ in range(2))
    outs = {}
    for dt in (torch.float64, torch.float32):
        xd = x.to(dt).requires_grad_(True)
        y = ops.groupnorm.group_norm(xd, 4, eps=1e-6, gamma=gamma.to(dt).requires_grad_(True),
                                     beta=beta.to(dt), act=True)
        (dx,) = torch.autograd.grad((y * y).sum(), [xd])
        assert y.dtype == dx.dtype == dt
        outs[dt] = (y.detach(), dx)
    for a, b in zip(outs[torch.float32], outs[torch.float64]):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(TypeError, match="dtype"):
        ops.groupnorm.group_norm(x.half(), 4, eps=1e-6)
