"""The port's 3D / pseudo-3D NCSN++ (`unetmore3d`, `unetmorepseudo3d`)
against upstream's goldens and the JAX package: strict loads and forwards
of the four goldens, bridged JAX inits (the weight map both ways, the
forward with `noise_in_cond`'s draw replayed; one train step is
`test_torch_port_legacy_3d_train.py`'s), the CPU CLI on
smmnist_DDPM_small5_3d.yml, the attention kernels' arithmetic at head dim
24 over the 3D model's short sequences, and the GroupNorm plans the new
shapes take. The legacy UNet's tests are `test_torch_port_legacy_unet.py`'s,
which shares this file's tables and helpers. Dropout is off. On the CPU the
GroupNorm and attention take their plain versions (the card's kernels are
held to those by `chip_smoke.py`)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.compat.torch_ckpt import _flax_path_to_torch, convert_state_dict
from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu_torch import ops
from mcvd_tpu_torch.compat import load_flax_params, torch_state_dict_from_flax
from mcvd_tpu_torch.compat.flax_names import flax_path_to_torch
from mcvd_tpu_torch.config import dict2namespace
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.models.layers import num_groups_for
from tests.test_torch_port_model import FWD_TOL, nchw_to_nhwc, nhwc_to_nchw
from tests.test_torch_port_ops import (check_bwd_tc_numerics, check_tc_numerics,
                                       check_tf32x3)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def tiny_dict(arch, spade=False, ngf=16, **model):
    """tests/test_torch_parity.py's golden config (16 px, ch_mult [1, 2],
    attention at 8 px)."""
    return {
        "data": {"channels": 1, "image_size": 16, "num_frames": 2, "num_frames_cond": 2,
                 "num_frames_future": 0, "logit_transform": False, "rescaled": True,
                 "prob_mask_cond": 0.0},
        "model": {"arch": arch, "version": "DDPM", "spade": spade, "spade_dim": 16,
                  "cond_emb": False, "time_conditional": True, "dropout": 0.0,
                  "sigma_dist": "linear", "sigma_begin": 0.02, "sigma_end": 0.0001,
                  "num_classes": 20, "ngf": ngf, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [8], "n_head_channels": 8, "conditional": True,
                  "noise_in_cond": False, "output_all_frames": False, "gamma": False,
                  **model},
        "optim": {"optimizer": "Adam", "lr": 2e-4, "beta1": 0.9, "eps": 1e-8,
                  "weight_decay": 0.0, "warmup": 0, "grad_clip": 1.0, "amsgrad": False},
        "training": {"L1": False, "compute_dtype": "float32"},
    }


# ------------------------------------------------------------------ goldens

GOLDENS = [  # name, tiny_dict kwargs, state dict entries
    ("unet_legacy", dict(arch="unet", ngf=32), 331),
    ("unetmore3d", dict(arch="unetmore3d"), 178),
    ("unetmore3d_spade", dict(arch="unetmore3d", spade=True), 334),
    ("pseudo3d", dict(arch="unetmorepseudo3d"), 236),
    ("pseudo3d_spade", dict(arch="unetmorepseudo3d", spade=True), 560),
]


def is_unet(name):
    return name in ("unet_legacy", "unet", "smmnist_DDPM_small5.yml")


GOLDENS_3D = [g for g in GOLDENS if not is_unet(g[0])]


@pytest.mark.parametrize("name,kw,n_entries", GOLDENS_3D, ids=[g[0] for g in GOLDENS_3D])
def test_forward_matches_upstream_golden(name, kw, n_entries):
    """Upstream's state dict (buffers included) loads strictly by name and
    the forward reproduces upstream's output at the 2D goldens' tolerance
    (`test_torch_port_model.py`), and within 1e-3 of the largest output."""
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    assert len(sd) == n_entries
    model = get_model(dict2namespace(tiny_dict(**kw)), device="cpu").eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(z["x"]), torch.from_numpy(z["y"]),
                    torch.from_numpy(z["cond"]))
    np.testing.assert_allclose(out.numpy(), z["out"], **FWD_TOL)
    assert np.abs(out.numpy() - z["out"]).max() <= 1e-3 * np.abs(z["out"]).max()


# ------------------------------------------------------- bridged JAX inits

ARCHS = {  # id: tiny_dict kwargs
    "unet": dict(arch="unet", ngf=32),
    "unetmore3d": dict(arch="unetmore3d"),
    "unetmorepseudo3d": dict(arch="unetmorepseudo3d"),
    "unetmore3d_spade": dict(arch="unetmore3d", spade=True),
    "unetmore3d_full": dict(arch="unetmore3d", full3d_attn=True),
    "pseudo3d_ddpm": dict(arch="unetmorepseudo3d", resblock_type="ddpm"),
}


def perturbed(params, seed, std=0.05):
    """Init params plus noise, so the zero-init layers take part."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + std * rng.randn(*a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, dict(params)))


def inputs(seed, B=2, sz=16):
    rng = np.random.RandomState(seed)
    x, cond = (rng.rand(B, sz, sz, 2).astype(np.float32) for _ in range(2))
    return x, cond, rng.randint(0, 20, B).astype(np.int32)


ARCHS_3D = [a for a in ARCHS if not is_unet(a)]


def make_jax_inits(names):
    """{arch id: (JAX config, JAX model, perturbed params)} of `names`, one
    init each."""
    out = {}
    for name in names:
        i, kw = list(ARCHS).index(name), ARCHS[name]
        jcfg = jax_dict2namespace(tiny_dict(**kw, noise_in_cond=True))
        model = jax_get_model(jcfg)
        x, cond, y = inputs(0)
        variables = jax.jit(lambda k, *a: model.init(
            k, *a, sched=jax_make_schedule(jcfg), rng=jax.random.PRNGKey(1)))(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(cond))
        out[name] = (jcfg, model, perturbed(variables["params"], 40 + i))
    return out


@pytest.fixture(scope="module")
def jax_inits():
    return make_jax_inits(ARCHS_3D)


def flax_paths(params):
    return [tuple(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(params)]


@pytest.mark.parametrize("arch", ARCHS_3D)
def test_weight_map_matches_jax_both_ways(jax_inits, arch):
    """Every flax param path of the tiny model: the port's copy of the name
    map gives the JAX package's (key, kind, base); the bridged state dict
    loads into the port's model strictly; and the JAX package's own
    converter, fed that state dict, gives back the flax params exactly."""
    _, _, params = jax_inits[arch]
    for path in flax_paths(params):
        assert flax_path_to_torch(path) == _flax_path_to_torch(path), path
    sd = torch_state_dict_from_flax(params)
    model = get_model(dict2namespace(tiny_dict(**ARCHS[arch])), device="cpu")
    load_flax_params(model, params)
    assert set(sd) == {n for n, _ in model.named_parameters()}
    back = convert_state_dict(params, {k: v.numpy() for k, v in sd.items()})
    for (p1, a), (p2, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert p1 == p2
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p1))


@pytest.mark.parametrize("arch", ARCHS_3D)
def test_forward_matches_jax(jax_inits, arch):
    """The tiny model on perturbed JAX weights with `noise_in_cond` on: the
    JAX forward with its rng, the port's with that rng's normal draw."""
    jcfg, jmodel, params = jax_inits[arch]
    x, cond, y = inputs(5)
    sched = jax_make_schedule(jcfg)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, sched=sched,
                                                         rng=rng))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(cond)))
    z = np.asarray(jax.random.normal(rng, cond.shape, dtype=jnp.float32))
    model = get_model(dict2namespace(tiny_dict(**ARCHS[arch], noise_in_cond=True)),
                      device="cpu").eval()
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(nhwc_to_nchw(x), torch.from_numpy(y).long(), nhwc_to_nchw(cond),
                    cond_noise=nhwc_to_nchw(z))
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **FWD_TOL)


# ------------------------------------------------------------------ the CLI

SMALL_MODS = {
    "smmnist_DDPM_small5.yml": ["model.ngf=32"],
    "smmnist_DDPM_small5_3d.yml": ["model.ngf=4", "model.ch_mult=[1,2]",
                                   "model.attn_resolutions=[32]"],
}


@pytest.mark.parametrize("yml", [y for y in SMALL_MODS if not is_unet(y)])
def test_cli_trains_and_video_gens_the_small_configs(tmp_path, yml):
    """--train to 2 steps, then --video_gen from checkpoint 2, on the CPU in
    subprocesses, the shipped yml cut to a tiny width and traffic (64 px,
    the SMMNIST reader's least; 2 cond and 2 predicted frames): the
    checkpoint, finite metrics, the launch-count line."""
    mods = SMALL_MODS[yml] + [
        "model.num_res_blocks=1", "data.num_frames=2", "data.num_frames_cond=2",
        "data.num_digits=1", "data.subset=16", "data.test_subset=4",
        "training.batch_size=2", "training.n_iters=2", "training.checkpoint_freq=2",
        "training.snapshot_freq=2", "training.snapshot_sampling=False",
        "training.val_freq=2", "training.log_freq=1", "sampling.subsample=2",
        "sampling.num_frames_pred=2", "sampling.batch_size=2", "sampling.max_data_iter=1",
        "sampling.fvd=False"]
    env = dict(os.environ, OMP_NUM_THREADS=str(TORCH_THREADS))
    base = [sys.executable, "-m", "mcvd_tpu_torch.main", "--config",
            os.path.join("configs", yml), "--exp", str(tmp_path / "exp"), "--ni",
            "--device", "cpu"]
    for mode in (["--train"], ["--video_gen", "--ckpt", "2"]):
        r = subprocess.run(base + mode + ["--config_mod", *mods], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
    logs = tmp_path / "exp" / "logs"
    assert {"checkpoint", "checkpoint_2"} <= set(os.listdir(logs))
    vid = (tmp_path / "exp" / "video_samples" / "videos" / "vid_metrics.yml").read_text()
    assert "nan" not in vid.lower() and "ssim" in vid


# ------------------------------------------------- attention at head dim 24

# The 3D model's attention: one head of D=24 over the space tokens (16x16
# and 4x4) and over the frames (7 and 2): the packed (B, T, 72) qkv, so a
# kernel that read past a head's 24 columns would read k's or v's data.
SHORT_T = [2, 7, 16, 256]


@pytest.mark.parametrize("against", ["plain", "pallas"])
@pytest.mark.parametrize("T", SHORT_T)
def test_attention_d24_tc_numerics_match(T, against):
    check_tc_numerics(T, 1, 24, against)


@pytest.mark.parametrize("against", ["plain", "pallas"])
@pytest.mark.parametrize("T", SHORT_T)
def test_attention_d24_bwd_tc_numerics_match(T, against):
    check_bwd_tc_numerics(T, 1, 24, against)


@pytest.mark.parametrize("direction", ["fwd", "vjp"])
@pytest.mark.parametrize("T", SHORT_T)
def test_attention_d24_tf32x3_matches_pallas(T, direction):
    check_tf32x3(T, 1, 24, direction)


# ---------------------------------------------------------- GroupNorm plans

@pytest.mark.parametrize("S", [(64, 64), (32, 32), (16, 16)])
def test_gn_plans_take_84_channels_in_bf16(S):
    """84 folded channels (12 x 7 frames) are not a multiple of 8 bf16
    values: the plans take 8-byte vectors (4 bf16), 21 a row, and cover the
    rows with no empty block; fp32 keeps 16-byte vectors."""
    H, W = S
    G = num_groups_for(12)   # over the true channels
    p = ops.groupnorm.plan(84, H, W, torch.bfloat16, G)
    assert p.vec == 4 and p.threads % 21 == 0
    assert p.rows * p.cluster >= H * W > p.rows * (p.cluster - 1)
    assert p.smem == ops.groupnorm.smem_bytes(p.threads, 4, 84, G)
    assert ops.groupnorm.plan(84, H, W, torch.float32, G).vec == 4
    assert ops.groupnorm.plan(96, H, W, torch.bfloat16, G).vec == 8
    for B in (64, 70_000):
        for bp in ops.groupnorm.bwd_plans(B, 84, H, W, torch.bfloat16, G, 7):
            assert bp.vec == 4 and bp.threads % 21 == 0
            assert bp.rows * bp.blocks >= H * W > bp.rows * (bp.blocks - 1)
        assert ops.groupnorm.bwd_plan(B, 84, H, W, torch.bfloat16, G, 7).vec == 4
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.groupnorm.plan(86, H, W, torch.bfloat16, 2)


@pytest.mark.parametrize("S,CN", [(7, 24), (2, 24), (16, 24), (1024, 64)])
@pytest.mark.parametrize("B", [64 * 256, 70_000])
def test_gn_plans_short_examples_and_large_batches(S, CN, B):
    """The time attention's GroupNorm sees (B*256, 24, 7 or 2, 1): S rows an
    example. The plans leave no block empty and give a block at least 8
    rows (one block an example below 16 rows); a batch past the grid's
    65,535 is the launch's to chunk, not the plan's to refuse."""
    G = num_groups_for(CN)
    for dtype in (torch.float32, torch.bfloat16):
        p = ops.groupnorm.plan(CN, S, 1, dtype, G)
        assert p.rows * p.cluster >= S > p.rows * (p.cluster - 1)
        assert p.rows >= min(S, 8)
        for bp in ops.groupnorm.bwd_plans(B, CN, S, 1, dtype, G):
            assert bp.rows * bp.blocks >= S > bp.rows * (bp.blocks - 1)
        bp = ops.groupnorm.bwd_plan(B, CN, S, 1, dtype, G, 1, True)
        assert bp.ws_floats == ops.groupnorm.bwd_workspace(
            B, CN, G, CN, bp.blocks if bp.split else 0)["total"]
