"""The port's NCSN++ against the JAX package: the flax->torch weight bridge,
block parity (FIR resample, AttnBlock, ResnetBlockBigGAN), the tiny-config
forward on the XLA and Pallas paths, upstream's golden outputs, and the
flagship's parameter names and shapes. Dropout is off (eval mode)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from mcvd_tpu import ops as jax_ops
from mcvd_tpu.compat.torch_ckpt import _flax_path_to_torch, convert_state_dict
from mcvd_tpu.models import blocks as jax_blocks
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu.models import resample as jax_resample
from mcvd_tpu_torch.compat import load_flax_params, torch_state_dict_from_flax
from mcvd_tpu_torch.compat.flax_names import flax_path_to_torch
from mcvd_tpu_torch.config import dict2namespace, flagship_config
from mcvd_tpu_torch.models import blocks, get_model, resample

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# Counted once from jax.eval_shape(model.init) of the flagship config
# (__graft_entry__._flagship_config()); chip_smoke.py asserts the same count.
FLAGSHIP_PARAM_COUNT = 27_941_765

# Forward parity, fp32: no looser than tests/test_torch_parity.py (the JAX
# package against upstream), since both sides run the same fp32 math and
# differ only in conv/matmul summation order.
FWD_TOL = dict(rtol=2e-3, atol=2e-4)
# Single blocks: a few convs deep, summation order only.
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)


def nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def as_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), dict(tree))


def perturbed(params, seed, std=0.05):
    """Init params plus noise: the zero-init convs/NINs (init_scale 0), the
    zero biases and the unit GroupNorm scales all become generic, so parity
    sees every parameter."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + std * rng.randn(*a.shape)).astype(np.float32),
        as_numpy_tree(params))


def tiny_config():
    config = __graft_entry__._flagship_config(tiny=True)
    config.model.dropout = 0.0
    return config


def test_flagship_config_matches_jax():
    def to_dict(ns):
        return {k: to_dict(v) if hasattr(v, "__dict__") else v for k, v in vars(ns).items()}

    for kw in ({}, {"tiny": True}, {"image_size": 32, "ngf": 32}):
        assert to_dict(flagship_config(**kw)) == to_dict(__graft_entry__._flagship_config(**kw))


@pytest.fixture(scope="module")
def tiny_params():
    """The tiny flagship's JAX init, perturbed; built once for the module."""
    config = tiny_config()
    x = jnp.zeros((1, config.data.image_size, config.data.image_size, 5))
    params = jax.jit(jax_get_model(config).init)(
        jax.random.PRNGKey(1), x, jnp.zeros((1,), jnp.int32), x)["params"]
    return perturbed(params, 5)


def test_bridge_round_trip_tiny(tiny_params):
    """flax params -> port state dict -> back through the JAX package's own
    torch->flax converter gives the same tree; every flax leaf lands on
    exactly one port parameter and no port parameter is left unset."""
    config = tiny_config()
    params = tiny_params
    sd = torch_state_dict_from_flax(params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves

    model = get_model(config, device="cpu")
    port_params = dict(model.named_parameters())
    assert set(sd) == set(port_params)
    load_flax_params(model, params)
    back = convert_state_dict(params, {k: v.detach().numpy() for k, v in
                                       model.state_dict().items()})
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def _param_paths(tree):
    return [tuple(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _flagship_param_shapes():
    """jax.eval_shape of the flagship init: the param tree's shapes, no compile."""
    config = __graft_entry__._flagship_config()
    x = jax.ShapeDtypeStruct((1, 64, 64, 5), jnp.float32)
    y = jax.ShapeDtypeStruct((1,), jnp.int32)
    return jax.eval_shape(jax_get_model(config).init, jax.random.PRNGKey(0), x, y, x)["params"]


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_flax_name_map_matches_jax(which, request):
    """The port's copy of the flax->torch name map gives the JAX package's
    (key, kind, base) for every param path of the tiny and flagship inits,
    and both raise on a leaf neither maps."""
    tree = (request.getfixturevalue("tiny_params") if which == "tiny"
            else _flagship_param_shapes())
    paths = _param_paths(tree)
    assert len(paths) > 50
    for path in paths:
        assert flax_path_to_torch(path) == _flax_path_to_torch(path), path
    for odd in [("a", "Conv_0", "bias"), ("Conv_0", "Conv_0", "kernel"), ("x", "weights"),
                ("temb_dense_1", "kernel"), ("mlp_shared", "Conv_0", "kernel")]:
        assert flax_path_to_torch(odd) == _flax_path_to_torch(odd), odd
    with pytest.raises(KeyError):
        _flax_path_to_torch(("a", "nope"))
    with pytest.raises(KeyError):
        flax_path_to_torch(("a", "nope"))


def test_get_model_defaults_to_the_card(monkeypatch):
    """With no device, get_model builds on CUDA or raises: it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(tiny_config())
    assert next(get_model(tiny_config(), device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("name", ["upsample_2d", "downsample_2d", "naive_upsample_2d",
                                  "naive_downsample_2d"])
def test_resample_matches_jax(name):
    x = np.random.RandomState(1).randn(2, 8, 8, 6).astype(np.float32)
    kw = dict(k=[1, 3, 3, 1]) if not name.startswith("naive") else {}
    want = np.asarray(getattr(jax_resample, name)(jnp.asarray(x), factor=2, **kw))
    got = getattr(resample, name)(nhwc_to_nchw(x), factor=2, **kw)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **BLOCK_TOL)
    if not name.startswith("naive"):  # the main path's resamples keep the layout
        assert got.is_contiguous(memory_format=torch.channels_last)


def _block_parity(jmod, tmod, args_np, seed):
    jargs = [jnp.asarray(a) for a in args_np]
    params = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(seed), *jargs)["params"], seed)
    want = np.asarray(jmod.apply({"params": params}, *jargs))
    load_flax_params(tmod, params)
    tmod.eval()
    targs = [nhwc_to_nchw(args_np[0])] + [torch.from_numpy(a) for a in args_np[1:]]
    with torch.no_grad():
        got = tmod(*targs)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **BLOCK_TOL)


@pytest.mark.parametrize("C,n_head_channels", [(16, 8), (24, 8), (16, -1)])
def test_attn_block_matches_jax(C, n_head_channels):
    x = np.random.RandomState(2).randn(2, 8, 8, C).astype(np.float32)
    jmod = jax_blocks.AttnBlock(channels=C, n_head_channels=n_head_channels)
    tmod = blocks.AttnBlock(C, n_head_channels=n_head_channels)
    _block_parity(jmod, tmod, [x], 2)


@pytest.mark.parametrize("kind", ["plain", "up", "down"])
def test_resnet_block_biggan_matches_jax(kind):
    rng = np.random.RandomState(3)
    in_ch, out_ch, temb_dim = 16, (32 if kind == "plain" else None), 24
    x = rng.randn(2, 8, 8, in_ch).astype(np.float32)
    temb = rng.randn(2, temb_dim).astype(np.float32)
    kw = dict(in_ch=in_ch, out_ch=out_ch, temb_dim=temb_dim, up=kind == "up",
              down=kind == "down", dropout=0.0)
    jmod = jax_blocks.ResnetBlockBigGAN(act=jax.nn.silu, **kw)
    tmod = blocks.ResnetBlockBigGAN(**kw)
    _block_parity(jmod, tmod, [x, temb], 3)


def test_actnorm_head_matches_jax():
    x = np.random.RandomState(4).randn(2, 8, 8, 16).astype(np.float32)
    jmod = jax_blocks.ActNorm(act=jax.nn.silu, norm="group", ch=16)
    _block_parity(jmod, blocks.ActNorm(16), [x], 4)


def _tiny_inputs(config, seed):
    rng = np.random.RandomState(seed)
    B, sz = 2, config.data.image_size
    x = rng.randn(B, sz, sz, 5).astype(np.float32)
    cond = rng.randn(B, sz, sz, 5).astype(np.float32)
    y = np.array([3, 971], np.int32)
    return x, cond, y


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
def test_tiny_forward_matches_jax(tiny_params, pallas):
    """The tiny flagship (16 px, ngf 16, ch_mult [1,2], attention at 8 px in
    8-channel heads) on perturbed weights, against the JAX forward on its XLA
    path and with the Pallas kernels on (interpret mode)."""
    config = tiny_config()
    jmodel = jax_get_model(config)
    x, cond, y = _tiny_inputs(config, 5)
    params = tiny_params
    jax_ops.set_use_pallas(pallas)
    try:
        want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                                jnp.asarray(y), jnp.asarray(cond)))
    finally:
        jax_ops.set_use_pallas(False)
    model = get_model(config, device="cpu").eval()
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(nhwc_to_nchw(x), torch.from_numpy(y).long(), nhwc_to_nchw(cond))
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **FWD_TOL)


def golden_config(cond_emb):
    return dict2namespace({
        "data": {"channels": 1, "image_size": 16, "num_frames": 2, "num_frames_cond": 2,
                 "num_frames_future": 0, "logit_transform": False, "rescaled": True,
                 "prob_mask_cond": 0.5 if cond_emb else 0.0},
        "model": {"arch": "unetmore", "version": "DDPM", "spade": False,
                  "cond_emb": cond_emb, "time_conditional": True, "dropout": 0.0,
                  "sigma_dist": "linear", "sigma_begin": 0.02, "sigma_end": 0.0001,
                  "num_classes": 20, "ngf": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [8], "n_head_channels": 8, "conditional": True,
                  "noise_in_cond": False, "output_all_frames": False, "gamma": False},
    })


@pytest.mark.parametrize("name,cond_emb", [("unetmore2d", False),
                                           ("unetmore2d_condemb", True)])
def test_forward_matches_upstream_golden(name, cond_emb):
    """Upstream's own state dict (buffers included) loads strictly and the
    forward reproduces upstream's output."""
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    assert len(sd) == (139 if cond_emb else 138)
    model = get_model(golden_config(cond_emb), device="cpu").eval()
    model.load_state_dict(sd, strict=True)
    cond_mask = torch.from_numpy(z["cond_mask"]) if cond_emb else None
    with torch.no_grad():
        out = model(torch.from_numpy(z["x"]), torch.from_numpy(z["y"]),
                    torch.from_numpy(z["cond"]), cond_mask)
    np.testing.assert_allclose(out.numpy(), z["out"], **FWD_TOL)


def test_flagship_param_names_and_shapes_match_jax():
    """jax.eval_shape of the flagship init (no compile): each flax leaf's
    torch key and shape equals the port's parameter of that name."""
    shapes = _flagship_param_shapes()
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        names = tuple(str(getattr(p, "key", p)) for p in path)
        key, kind, _ = _flax_path_to_torch(names)
        s = tuple(leaf.shape)
        if kind == "conv_or_dense":
            s = s[::-1] if len(s) == 2 else (s[3], s[2], s[0], s[1])
        want[key] = s
    assert sum(int(np.prod(s)) for s in want.values()) == FLAGSHIP_PARAM_COUNT
    model = get_model(flagship_config(), device="cpu")
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
