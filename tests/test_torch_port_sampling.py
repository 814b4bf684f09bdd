"""The port's schedules, DDPM sampler and autoregressive video prediction
against the JAX package, with the JAX random draws replayed into the port
(split the keys as the JAX code does, draw in JAX, hand the arrays over)."""

import copy
import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.diffusion import samplers as jax_samplers
from mcvd_tpu.diffusion.schedules import subsample_schedule as jax_subsample
from mcvd_tpu.eval import video_gen as jax_video_gen
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu_torch.compat import load_flax_params, torch_state_dict_from_flax
from mcvd_tpu_torch.data import data_transform, inverse_data_transform
from mcvd_tpu_torch.diffusion import make_schedule, samplers
from mcvd_tpu_torch.diffusion.schedules import subsample_schedule
from mcvd_tpu_torch.eval import video_gen
from mcvd_tpu_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Sampler chains, fp32: atol 1e-3. Each step divides by sqrt(alpha) (down to
# ~0.07 at the most-noised level of the 1000-step schedule), so the eps
# networks' ~1e-6 differences in summation order grow along the chain.
CHAIN_TOL = dict(rtol=0, atol=1e-3)


def sched_config(version="DDPM", dist="linear", gamma=False, T=1000):
    begin, end = (0.02, 0.0001) if version != "SMLD" else (1.0, 0.01)
    return jax_dict2namespace({"model": {"version": version, "sigma_dist": dist,
                                         "sigma_begin": begin, "sigma_end": end,
                                         "num_classes": T, "gamma": gamma}})


@pytest.mark.parametrize("version,dist,gamma", [
    ("DDPM", "linear", False), ("DDPM", "cosine", False), ("DDPM", "linear", True),
    ("SMLD", "geometric", False)])
def test_schedule_tables_match_jax(version, dist, gamma):
    config = sched_config(version, dist, gamma)
    want, got = jax_make_schedule(config), make_schedule(config)
    assert (got.version, got.schedule, got.T) == (want.version, want.schedule, want.T)
    for name in ("sigmas", "betas", "alphas", "alphas_prev", "k_cum", "theta_t"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=name)
    if version != "SMLD":
        for sub in (None, 100, 7):
            for a, b in zip(jax_subsample(want, sub), subsample_schedule(got, sub)):
                if a is None:
                    assert b is None
                else:
                    np.testing.assert_array_equal(b, a)


def replay_sampler_draws(key, shape, L):
    """The draws `ddpm_sampler` makes from `key`: split(key) -> (key,
    inj_key), then split(key, L), one normal per step."""
    key, inj_key = jax.random.split(key)
    step_keys = jax.random.split(key, L)
    step = np.stack([np.array(jax.random.normal(k, shape, jnp.float32)) for k in step_keys])
    inj = np.array(jax.random.normal(inj_key, shape, jnp.float32))
    return torch.from_numpy(inj), torch.from_numpy(step)


def toy_eps_jax(x, labels):
    c = 0.05 + 0.0005 * labels.astype(jnp.float32)
    return c.reshape(-1, *([1] * (x.ndim - 1))) * x


def toy_eps_torch(x, labels):
    c = 0.05 + 0.0005 * labels.float()
    return c.reshape(-1, *([1] * (x.ndim - 1))) * x


@pytest.mark.parametrize("kw", [
    dict(subsample_steps=100),
    dict(subsample_steps=10, final_only=False),
    dict(subsample_steps=20, t_min=0.5, just_beta=True),
    dict(frac_steps=0.3, clip_before=False, denoise=False),
    dict(subsample_steps=25, same_noise=True),
], ids=["sub100", "traj", "tmin_justbeta", "frac_noclip", "same_noise"])
def test_ddpm_sampler_toy_matches_jax(kw):
    sched = jax_make_schedule(sched_config())
    shape = (2, 4, 4, 3)
    x_init = np.random.RandomState(0).randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_samplers.ddpm_sampler(key, jnp.asarray(x_init), toy_eps_jax,
                                                sched, **kw))
    L = len(jax_samplers._prepare_tables(sched, kw.get("subsample_steps"),
                                         kw.get("frac_steps"), kw.get("t_min", -1.0)).steps)
    inj, step = replay_sampler_draws(key, shape, L)
    got = samplers.ddpm_sampler(torch.from_numpy(x_init), toy_eps_torch,
                                make_schedule(sched_config()), inj_noise=inj,
                                step_noise=step, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)


def test_ddpm_sampler_draws_from_generator_only_when_needed():
    sched = make_schedule(sched_config())
    x = torch.zeros(1, 2, 2, 1)
    with pytest.raises(ValueError, match="Generator"):
        samplers.ddpm_sampler(x, toy_eps_torch, sched, subsample_steps=5)
    g = torch.Generator().manual_seed(0)
    a = samplers.ddpm_sampler(x, toy_eps_torch, sched, subsample_steps=5, generator=g)
    b = samplers.ddpm_sampler(x, toy_eps_torch, sched, subsample_steps=5,
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        samplers.get_sampler("DDIM")


def test_init_noise_defaults_to_the_card(monkeypatch):
    """With no device, init_noise draws on CUDA or raises; on the CPU only
    when asked."""
    config = sched_config()
    sched = make_schedule(config)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        video_gen.init_noise(config, sched, (1, 2, 2, 1), generator=torch.Generator())
    z = video_gen.init_noise(config, sched, (1, 2, 2, 1),
                             generator=torch.Generator().manual_seed(0), device="cpu")
    assert z.device.type == "cpu" and z.shape == (1, 2, 2, 1)


def ar_config():
    """The tiny flagship at 2 pred + 2 cond frames, 5-step subsampled DDPM."""
    config = __graft_entry__._flagship_config(tiny=True)
    config.data.num_frames = 2
    config.data.num_frames_cond = 2
    config.model.dropout = 0.0
    config.sampling.subsample = 5
    return config


@pytest.fixture(scope="module")
def tiny_models():
    """(config, JAX model, perturbed JAX params, port model with those weights)."""
    config = ar_config()
    jmodel = jax_get_model(config)
    sz = config.data.image_size
    x = jnp.zeros((1, sz, sz, 2))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), x, jnp.zeros((1,), jnp.int32),
                                  x)["params"]
    rng = np.random.RandomState(3)
    # zero-init output layers and biases become generic, so eps is not ~0
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(np.float32),
        dict(params))
    model = get_model(config, device="cpu").eval()
    load_flax_params(model, params)
    return config, jmodel, params, model


def test_ddpm_sampler_tiny_model_matches_jax(tiny_models):
    config, jmodel, params, model = tiny_models
    jsched, sched = jax_make_schedule(config), make_schedule(config)
    rng = np.random.RandomState(4)
    shape = (2, 16, 16, 2)
    x_init = rng.randn(*shape).astype(np.float32)
    cond = rng.randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def run_jax(key, x_init, cond):
        eps_fn = lambda x, t: jmodel.apply({"params": params}, x, t, cond)
        return jax_samplers.ddpm_sampler(key, x_init, eps_fn, jsched, subsample_steps=5)

    want = np.asarray(jax.jit(run_jax)(key, jnp.asarray(x_init), jnp.asarray(cond)))
    inj, step = replay_sampler_draws(key, shape, 5)
    cond_t = torch.from_numpy(cond).permute(0, 3, 1, 2)

    def eps_fn(x, t):
        return model(x.permute(0, 3, 1, 2), t, cond_t).permute(0, 2, 3, 1)

    with torch.no_grad():
        got = samplers.ddpm_sampler(torch.from_numpy(x_init), eps_fn, sched,
                                    subsample_steps=5, inj_noise=inj, step_noise=step)
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)


def test_autoregressive_predict_matches_jax(tiny_models):
    """B=2, 2 cond + 2 pred frames, 5 frames predicted in 3 blocks (the last
    partial), 5 sampler steps; every block's init, injection and step noise
    replayed from the JAX key splits."""
    config, jmodel, params, model = tiny_models
    jsched, sched = jax_make_schedule(config), make_schedule(config)
    cond = np.random.RandomState(5).rand(2, 16, 16, 2).astype(np.float32) * 2 - 1
    key = jax.random.PRNGKey(21)
    n_pred, shape = 5, (2, 16, 16, 2)

    jblock = jax_video_gen.make_block_sampler(config, jmodel, jsched)
    want = np.asarray(jax_video_gen.autoregressive_predict(
        config, jblock, params, key, jnp.asarray(cond), None, n_pred, 0, jsched))

    draws, k = [], key
    for _ in range(3):
        k, k_init, k_samp = jax.random.split(k, 3)
        inj, step = replay_sampler_draws(k_samp, shape, 5)
        draws.append({"init": torch.from_numpy(np.array(jax.random.normal(k_init, shape))),
                      "inj_noise": inj, "step_noise": step})
    block = video_gen.make_block_sampler(config, model, sched)
    got = video_gen.autoregressive_predict(config, block, port_params(params),
                                           torch.from_numpy(cond), None, n_pred, 0, sched,
                                           draws=draws)
    assert got.shape == want.shape == (2, 16, 16, 5)
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)


def port_params(params):
    """The JAX params as the port's state dict (name -> tensor)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in torch_state_dict_from_flax(params).items()}


def sampler_inputs(config, seed):
    rng = np.random.RandomState(seed)
    shape = (2, 16, 16, 2)
    init, cond = (torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(2))
    step = torch.from_numpy(rng.randn(config.sampling.subsample, *shape).astype(np.float32))
    return init, cond, step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sampler_takes_weights_per_call(tiny_models, dtype):
    """One sampler called with two sets of weights gives what a fresh sampler
    gives on each, and an in-place change of the weights between two calls
    reaches the next call (in bf16 through the cast cache); building and
    calling the sampler leave the caller's model and its training flag
    alone."""
    config, _, params, model = tiny_models
    sched = make_schedule(config)
    cfg = copy.deepcopy(config)
    cfg.sampling.compute_dtype = dtype
    init, cond, step = sampler_inputs(cfg, 8)
    w1 = port_params(params)
    w2 = {k: v * 1.01 if v.is_floating_point() else v for k, v in w1.items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    one = video_gen.make_block_sampler(cfg, model, sched)
    got = [one(w, init, cond, step_noise=step) for w in (w1, w2)]
    for w, g in zip((w1, w2), got):
        fresh = video_gen.make_block_sampler(cfg, model, sched)
        assert torch.equal(g, fresh(w, init, cond, step_noise=step))
    assert not torch.equal(got[0], got[1])
    # an optimizer-style in-place update of the same tensors
    live = {k: v.clone() for k, v in w1.items()}
    a = one(live, init, cond, step_noise=step)
    assert torch.equal(a, got[0])
    with torch.no_grad():
        for k, v in live.items():
            if v.is_floating_point():
                v.mul_(1.01)
    assert torch.equal(one(live, init, cond, step_noise=step), got[1])
    assert model.training
    model.eval()
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("future,one_frame", [(0, False), (0, True), (1, False), (1, True)])
def test_slide_cond_window_matches_jax(future, one_frame):
    config = jax_dict2namespace({"data": {"channels": 2, "num_frames": 3,
                                          "num_frames_cond": 4}})
    rng = np.random.RandomState(6)
    cond = rng.randn(1, 2, 2, 2 * (4 + future)).astype(np.float32)
    gen = rng.randn(1, 2, 2, 6).astype(np.float32)
    want = np.asarray(jax_video_gen.slide_cond_window(config, jnp.asarray(cond),
                                                      jnp.asarray(gen), future, one_frame))
    got = video_gen.slide_cond_window(config, torch.from_numpy(cond), torch.from_numpy(gen),
                                      future, one_frame)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["rescaled", "logit"])
def test_data_transforms_match_jax(mode):
    from mcvd_tpu.data import transforms as jax_tf

    config = jax_dict2namespace({"data": {"rescaled": mode == "rescaled",
                                          "logit_transform": mode == "logit"}})
    X = np.random.RandomState(7).rand(2, 3, 4).astype(np.float32)
    fwd = data_transform(config, torch.from_numpy(X))
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jax_tf.data_transform(config, X)),
                               rtol=1e-6, atol=1e-6)
    inv = inverse_data_transform(config, fwd)
    np.testing.assert_allclose(
        inv.numpy(), np.asarray(jax_tf.inverse_data_transform(config, jnp.asarray(fwd.numpy()))),
        rtol=1e-6, atol=1e-6)


def test_import_loads_no_jax_flax_or_yaml():
    """Every module of the port imports, and the flax->torch bridge runs, with
    no jax, flax, yaml or module of the JAX package loaded."""
    code = """
import importlib, pkgutil, sys
import numpy as np
import mcvd_tpu_torch
for m in pkgutil.walk_packages(mcvd_tpu_torch.__path__, "mcvd_tpu_torch."):
    importlib.import_module(m.name)
from mcvd_tpu_torch.compat import torch_state_dict_from_flax
sd = torch_state_dict_from_flax({"all_modules_0": {"kernel": np.zeros((2, 3)),
                                                   "bias": np.zeros(3)}})
assert sorted(sd) == ["all_modules.0.bias", "all_modules.0.weight"], sorted(sd)
assert "mcvd_tpu_torch.tools.profile_gn2" in sys.modules
print(sorted(m for m in sys.modules if m in ("jax", "flax", "yaml", "mcvd_tpu")
             or m.startswith(("jax.", "flax.", "mcvd_tpu."))))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_port_sources_import_nothing_of_the_jax_package():
    """Static scan: no file of the port, nor chip_smoke.py, imports jax, flax,
    yaml or any `mcvd_tpu` module (lazy imports inside functions included)."""
    bad = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|yaml|mcvd_tpu)(?![\w])", re.M)
    files = sorted(glob.glob(os.path.join(REPO, "mcvd_tpu_torch", "**", "*.py"),
                             recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    hits = [(f, m.group(0).strip()) for f in files
            for m in bad.finditer(open(f, encoding="utf-8").read())]
    assert hits == []
    # the pattern does catch what it must
    assert bad.search("    from mcvd_tpu.compat import x") and bad.search("import jax.numpy")
    assert not bad.search("from mcvd_tpu_torch import ops")
