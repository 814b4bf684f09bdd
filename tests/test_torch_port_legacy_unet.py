"""The port's legacy UNet (`arch: unet`, the network of
smmnist_DDPM_small5.yml) against upstream's golden and the JAX package: the
strict load and forward of its golden, its bridged JAX init (the weight map
both ways, the forward with `noise_in_cond`'s draw replayed; its train step
is `test_torch_port_legacy_3d_train.py`'s), and the CPU CLI on the yml.
The tables and helpers are `test_torch_port_legacy_3d.py`'s, whose 3D /
pseudo-3D tests these were split from (one file a model family, so
`--dist loadfile` runs them on two workers). Dropout is off; on the CPU the
GroupNorm and attention take their plain versions."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.compat.torch_ckpt import _flax_path_to_torch, convert_state_dict
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu_torch.compat import load_flax_params, torch_state_dict_from_flax
from mcvd_tpu_torch.compat.flax_names import flax_path_to_torch
from mcvd_tpu_torch.config import dict2namespace
from mcvd_tpu_torch.models import get_model
from tests.test_torch_port_legacy_3d import (ARCHS, GOLDEN_DIR, GOLDENS, REPO, SMALL_MODS,
                                             TORCH_THREADS, flax_paths, inputs, is_unet,
                                             make_jax_inits, tiny_dict,
                                             torch_threads)  # noqa: F401
from tests.test_torch_port_model import FWD_TOL, nchw_to_nhwc, nhwc_to_nchw

GOLDENS_UNET = [g for g in GOLDENS if is_unet(g[0])]
ARCHS_UNET = [a for a in ARCHS if is_unet(a)]


@pytest.fixture(scope="module")
def jax_inits():
    return make_jax_inits(ARCHS_UNET)


@pytest.mark.parametrize("name,kw,n_entries", GOLDENS_UNET, ids=[g[0] for g in GOLDENS_UNET])
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


@pytest.mark.parametrize("arch", ARCHS_UNET)
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


@pytest.mark.parametrize("arch", ARCHS_UNET)
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


@pytest.mark.parametrize("yml", [y for y in SMALL_MODS if is_unet(y)])
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
