"""The rest of the port's 2D NCSN++ family against the JAX package: SPADE
(`nearest_resize`, `MySPADE`, `ActNorm(norm="spade")`, the SPADE BigGAN
resblock), the DDPM resblock with its fused FIR up/down convs
(`UpDownConv2d`, `Upsample`, `Downsample`, `upsample_conv_2d`,
`conv_downsample_2d`), tiny SPADE and DDPM-resblock models, `noise_in_cond`
with the JAX draw replayed, and the shipped `*_spade.yml` configs. Weights
cross with `compat/bridge` (perturbed, so every parameter matters); fp32,
dropout off. The upstream goldens of these variants are in
`test_torch_port_model.py::test_forward_matches_upstream_golden`."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.config import load_config as jax_load_config
from mcvd_tpu.config import namespace2dict
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.models import blocks as jax_blocks
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu.models import resample as jax_resample
from mcvd_tpu_torch.compat import load_flax_params
from mcvd_tpu_torch.config import dict2namespace, load_config
from mcvd_tpu_torch.models import UNetMoreDDPM, blocks, get_model, resample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPADE_CONFIGS = ["smmnist_DDPM_big5_spade", "bair_big_spade", "kth64_big_spade",
                 "cityscapes_big_spade"]

# Single blocks: a few convs deep, fp32 on both sides, summation order only
# (test_torch_port_model.py's BLOCK_TOL).
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
# Whole tiny models, fp32: the forward tolerance of test_torch_port_model.py
# (no looser than the JAX package's own golden test).
FWD_TOL = dict(rtol=2e-3, atol=2e-4)


def nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def perturbed(params, seed, std=0.05):
    """Init params plus noise, so zero-init convs, zero biases and unit
    norm scales all become generic."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + std * rng.randn(*a.shape)).astype(np.float32),
        dict(params))


def block_parity(jmod, tmod, args, images, seed, tol=BLOCK_TOL):
    """JAX `jmod` and port `tmod` on the same inputs and bridged weights:
    `args` numpy, NHWC where `images[i]`, passed NCHW to the port."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = perturbed(jmod.init(jax.random.PRNGKey(seed), *jargs)["params"], seed)
    want = np.asarray(jmod.apply({"params": params}, *jargs))
    load_flax_params(tmod, params)
    tmod.eval()
    targs = [None if a is None else nhwc_to_nchw(a) if img else torch.from_numpy(a)
             for a, img in zip(args, images)]
    with torch.no_grad():
        got = tmod(*targs)
    assert got.is_contiguous(memory_format=torch.channels_last) or got.shape[1] == 1
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **tol)


# ------------------------------------------------------------ resampling

@pytest.mark.parametrize("out", [32, 16, 8, 4, 24])
def test_nearest_resize_matches_jax(out):
    """floor(i*in/out) on both axes, 64 -> out (24: a ratio that is not an
    integer), exactly."""
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax_blocks.nearest_resize(jnp.asarray(x), (out, out)))
    got = blocks.nearest_resize(nhwc_to_nchw(x), (out, out))
    np.testing.assert_array_equal(nchw_to_nhwc(got), want)


@pytest.mark.parametrize("name", ["upsample_conv_2d", "conv_downsample_2d"])
def test_fused_fir_conv_matches_jax(name):
    """The StyleGAN2 fused up/down convs: the JAX HWIO weight is the port's
    (O, I, kh, kw) transposed."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    w = rng.randn(3, 3, 6, 10).astype(np.float32)
    want = np.asarray(getattr(jax_resample, name)(jnp.asarray(x), jnp.asarray(w),
                                                  k=[1, 3, 3, 1]))
    got = getattr(resample, name)(nhwc_to_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                                  k=[1, 3, 3, 1])
    assert got.shape[2] == (16 if name.startswith("up") else 4)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **BLOCK_TOL)


@pytest.mark.parametrize("kind", ["up", "down", "same"])
def test_up_down_conv2d_matches_jax(kind):
    x = np.random.RandomState(2).randn(2, 8, 8, 6).astype(np.float32)
    kw = dict(up=kind == "up", down=kind == "down")
    block_parity(jax_blocks.UpDownConv2d(6, 10, 3, **kw), blocks.UpDownConv2d(6, 10, 3, **kw),
                 [x], [True], 2)


@pytest.mark.parametrize("fir", [True, False], ids=["fir", "no_fir"])
@pytest.mark.parametrize("with_conv", [True, False], ids=["conv", "no_conv"])
@pytest.mark.parametrize("which", ["Upsample", "Downsample"])
def test_resample_modules_match_jax(which, with_conv, fir):
    x = np.random.RandomState(3).randn(2, 8, 8, 6).astype(np.float32)
    kw = dict(in_ch=6, out_ch=10 if with_conv else None, with_conv=with_conv, fir=fir)
    jmod = getattr(jax_blocks, which)(**kw)
    tmod = getattr(blocks, which)(**kw)
    if not with_conv:   # no parameters: nothing to bridge
        want = np.asarray(jmod.apply({}, jnp.asarray(x)))
        np.testing.assert_allclose(nchw_to_nhwc(tmod(nhwc_to_nchw(x))), want, **BLOCK_TOL)
        return
    block_parity(jmod, tmod, [x], [True], 3)


# ------------------------------------------------------------ SPADE blocks

def _conv3x3():
    return jax_blocks.make_convs("2d", 1, jax.nn.silu)[0]


def _spade_inputs(seed, C=16, cond_ch=4, emb_dim=24):
    """x at 8 px, the cond frames at 16 px (resized to x's size), emb."""
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 8, 8, C).astype(np.float32),
            rng.randn(2, emb_dim).astype(np.float32),
            rng.randn(2, 16, 16, cond_ch).astype(np.float32))


def test_myspade_matches_jax():
    x, _, cond = _spade_inputs(4)
    jmod = jax_blocks.MySPADE(norm_nc=16, label_nc=4, act=jax.nn.silu, conv3x3=_conv3x3(),
                              spade_dim=12)
    block_parity(jmod, blocks.MySPADE(16, 4, 12), [x, cond], [True, True], 4)


@pytest.mark.parametrize("emb", [True, False], ids=["emb", "no_emb"])
def test_actnorm_spade_matches_jax(emb):
    """SPADE, then (with emb) the AdaGN (1+scale)+shift, then SiLU."""
    x, e, cond = _spade_inputs(5)
    jmod = jax_blocks.ActNorm(act=jax.nn.silu, norm="spade", ch=16,
                              emb_dim=24 if emb else None, cond_ch=4, spade_dim=12,
                              conv3x3=_conv3x3())
    tmod = blocks.ActNorm(16, 24 if emb else None, norm="spade", cond_ch=4, spade_dim=12)
    block_parity(jmod, tmod, [x, e if emb else None, cond], [True, False, True], 5)


@pytest.mark.parametrize("kind", ["plain", "up", "down"])
def test_resnet_block_biggan_spade_matches_jax(kind):
    x, temb, cond = _spade_inputs(6)
    kw = dict(in_ch=16, out_ch=24 if kind == "plain" else None, temb_dim=24,
              up=kind == "up", down=kind == "down", dropout=0.0, norm="spade", cond_ch=4,
              spade_dim=12)
    jmod = jax_blocks.ResnetBlockBigGAN(act=jax.nn.silu, num_frames_cond=2, **kw)
    block_parity(jmod, blocks.ResnetBlockBigGAN(**kw), [x, temb, cond], [True, False, True], 6)


@pytest.mark.parametrize("norm", ["group", "spade"])
@pytest.mark.parametrize("width", ["same", "nin", "conv_shortcut"])
def test_resnet_block_ddpm_matches_jax(norm, width):
    """The DDPM resblock with group (one GroupNorm+SiLU call) and SPADE
    norms, at its width and with the NIN or 3x3 conv shortcut, with and
    without skip_rescale."""
    x, temb, cond = _spade_inputs(7)
    kw = dict(in_ch=16, out_ch=16 if width == "same" else 24, temb_dim=24, dropout=0.0,
              conv_shortcut=width == "conv_shortcut", skip_rescale=width == "nin",
              init_scale=0.5, norm=norm)
    if norm == "spade":
        kw.update(cond_ch=4, spade_dim=12)
    jmod = jax_blocks.ResnetBlockDDPM(act=jax.nn.silu, num_frames_cond=2, **kw)
    block_parity(jmod, blocks.ResnetBlockDDPM(**kw), [x, temb, cond], [True, False, True], 7)


# ------------------------------------------------------------ tiny models

def tiny_config(spade=False, resblock_type="biggan", noise_in_cond=False, gamma=False):
    """The golden tests' 16 px config (ngf 16, ch_mult [1,2], attention at 8
    px in 8-channel heads), 2 predicted frames on 2 cond frames."""
    return {
        "data": {"channels": 1, "image_size": 16, "num_frames": 2, "num_frames_cond": 2,
                 "num_frames_future": 0, "logit_transform": False, "rescaled": True,
                 "prob_mask_cond": 0.0},
        "model": {"arch": "unetmore", "version": "DDPM", "spade": spade, "spade_dim": 16,
                  "cond_emb": False, "time_conditional": True, "dropout": 0.0,
                  "sigma_dist": "linear", "sigma_begin": 0.02, "sigma_end": 0.0001,
                  "num_classes": 20, "ngf": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [8], "n_head_channels": 8, "conditional": True,
                  "noise_in_cond": noise_in_cond, "output_all_frames": False, "gamma": gamma,
                  "resblock_type": resblock_type},
    }


VARIANTS = {"spade": dict(spade=True), "ddpm": dict(resblock_type="ddpm"),
            "spade_ddpm": dict(spade=True, resblock_type="ddpm")}


def _tiny_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 16, 16, 2).astype(np.float32),
            rng.randn(2, 16, 16, 2).astype(np.float32), np.array([3, 17], np.int32))


@pytest.fixture(scope="module", params=list(VARIANTS))
def tiny_variant(request):
    """(name, config dict, perturbed JAX params, inputs, JAX output): one JAX
    init and apply per variant for the module."""
    d = tiny_config(**VARIANTS[request.param])
    jmodel = jax_get_model(jax_dict2namespace(d))
    x, cond, y = _tiny_inputs(8)
    params = perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(8), jnp.asarray(x),
                                            jnp.asarray(y), jnp.asarray(cond))["params"], 8)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                            jnp.asarray(y), jnp.asarray(cond)))
    return request.param, d, params, (x, cond, y), want


def test_tiny_variant_forward_matches_jax(tiny_variant):
    """Every flax leaf lands on one port parameter and none is left unset
    (`load_flax_params` raises otherwise); the forward matches."""
    name, d, params, (x, cond, y), want = tiny_variant
    model = get_model(dict2namespace(d), device="cpu").eval()
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(list(model.parameters()))
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(nhwc_to_nchw(x), torch.from_numpy(y).long(), nhwc_to_nchw(cond))
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **FWD_TOL)
    assert np.abs(want).max() > 0.1   # perturbed weights: a generic output


@pytest.mark.parametrize("gamma", [False, True], ids=["normal", "gamma"])
def test_noise_in_cond_matches_jax(gamma):
    """UNetMoreDDPM with noise_in_cond diffuses cond to the labels' level with
    the JAX rng's draw, replayed: N(0, 1), or Gamma(k_cum[y], 1) with gamma;
    without the draw it raises, as the JAX model does without an rng."""
    d = tiny_config(noise_in_cond=True, gamma=gamma)
    jconfig = jax_dict2namespace(d)
    jmodel = jax_get_model(jconfig)
    sched = jax_make_schedule(jconfig)
    x, cond, y = _tiny_inputs(9)
    jx, jc, jy = jnp.asarray(x), jnp.asarray(cond), jnp.asarray(y)
    key = jax.random.PRNGKey(10)
    init = jax.jit(lambda k, r: jmodel.init(k, jx, jy, jc, sched=sched, rng=r))
    params = perturbed(init(jax.random.PRNGKey(9), key)["params"], 9)
    apply = jax.jit(lambda p, r: jmodel.apply({"params": p}, jx, jy, jc, sched=sched, rng=r))
    want = np.asarray(apply(params, key))
    if gamma:
        k = jnp.asarray(sched.k_cum)[jy].reshape(2, 1, 1, 1)
        draw = jax.random.gamma(key, jnp.broadcast_to(k, jc.shape))
    else:
        draw = jax.random.normal(key, jc.shape, dtype=jc.dtype)
    model = get_model(dict2namespace(d), device="cpu").eval()
    load_flax_params(model, params)
    args = (nhwc_to_nchw(x), torch.from_numpy(y).long(), nhwc_to_nchw(cond))
    with torch.no_grad():
        got = model(*args, cond_noise=nhwc_to_nchw(np.asarray(draw)))
        plain = model(*args, cond_noise=torch.zeros_like(args[2]))
        with pytest.raises(ValueError, match="cond-noise draw"):
            model(*args)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **FWD_TOL)
    # the draw matters: cond is not diffused with zero noise in the gamma form
    assert np.abs(nchw_to_nhwc(plain) - want).max() > 10 * FWD_TOL["atol"]


def test_draw_cond_noise_shapes_and_moments():
    """`draw_cond_noise` from a generator: cond's shape; N(0, 1), or with
    gamma Gamma(k_cum[y], 1) per example (mean k, variance k); without a
    generator it raises."""
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.models.ncsnpp import draw_cond_noise

    cond = torch.zeros(2, 2, 64, 64)
    for gamma in (False, True):
        config = dict2namespace(tiny_config(noise_in_cond=True, gamma=gamma))
        sched = make_schedule(config)
        y = torch.tensor([0, 19])
        z = draw_cond_noise(config, sched, y, cond, torch.Generator().manual_seed(0))
        assert z.shape == cond.shape and z.dtype == torch.float32
        for b in range(2):
            mean = float(sched.k_cum[y[b]]) if gamma else 0.0
            std = float(np.sqrt(sched.k_cum[y[b]])) if gamma else 1.0
            assert abs(float(z[b].mean()) - mean) < 0.05 * std
            assert abs(float(z[b].std()) - std) < 0.05 * std
        with pytest.raises(ValueError, match="Generator"):   # no global-RNG draw
            draw_cond_noise(config, sched, y, cond, None)


# ------------------------------------------------------------ the shipped configs

@pytest.mark.parametrize("name", SPADE_CONFIGS)
def test_spade_yml_loads_as_jax_and_builds(name):
    """The port's load of `configs/<name>.yml` equals the JAX package's; its
    model has the JAX init's parameter count (jax.eval_shape, no compile)
    and SPADE in every norm; built on the meta device (no weights drawn)."""
    path = os.path.join(REPO, "configs", f"{name}.yml")
    config = load_config(path)
    jconfig = jax_load_config(path)

    def to_dict(ns):
        return {k: to_dict(v) if hasattr(v, "__dict__") else v for k, v in vars(ns).items()}

    assert to_dict(config) == namespace2dict(jconfig)
    sz, ch = jconfig.data.image_size, jconfig.data.channels
    x = jax.ShapeDtypeStruct((1, sz, sz, ch * jconfig.data.num_frames), jnp.float32)
    c = jax.ShapeDtypeStruct((1, sz, sz, ch * jconfig.data.num_frames_cond), jnp.float32)
    shapes = jax.eval_shape(jax_get_model(jconfig).init, jax.random.PRNGKey(0), x,
                            jax.ShapeDtypeStruct((1,), jnp.int32), c)["params"]
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = UNetMoreDDPM(config)
    assert sum(p.numel() for p in model.parameters()) == want
    n_spade = sum(isinstance(m, blocks.MySPADE) for m in model.modules())
    n_norm = sum(isinstance(m, blocks.ActNorm) for m in model.modules())
    assert n_spade == n_norm
    # the input conv sees the predicted frames only
    assert model.unet.all_modules[2].in_channels == ch * jconfig.data.num_frames


def test_chip_smoke_wide_config_counts():
    """chip_smoke.py's WIDE_CONFIGS parameter counts are the JAX init's and
    the port's, for each shipped config it builds (read with the port's
    load_config)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert {"bair_big_spade", "cityscapes_big_spade"} <= set(chip_smoke.WIDE_CONFIGS)
    for name, (head_dim, count) in chip_smoke.WIDE_CONFIGS.items():
        config = load_config(os.path.join(REPO, "configs", f"{name}.yml"))
        with torch.device("meta"):
            model = UNetMoreDDPM(config)
        assert sum(p.numel() for p in model.parameters()) == count, name
        attn = [m for m in model.modules() if isinstance(m, blocks.AttnBlock)]
        assert {m.NIN_0.W.shape[0] // m.n_heads for m in attn} == {head_dim}, name
