"""The port's SMLD samplers against the JAX package with the same draws:
annealed Langevin dynamics and its consistent form (`diffusion/samplers.py`),
the four specialty samplers (`diffusion/langevin_extras.py`, also against
the trajectories of upstream's own functions in
`tests/golden/langevin_extras.npz` at the JAX oracle's rtol 2e-4 / atol
2e-5), `check_n_steps_each`, an SMLD block through both packages'
`make_block_sampler` on a tiny NCSNv2, and the runner's inpainting and
interpolation branches on the CPU.

The JAX samplers draw from keys; the tests replay those draws (the same
`jax.random.split` and `normal`) into the port's explicit draws. A toy
network (closed form, as the golden generator's) stands in for the score
network where the sampler is the subject. Tolerance of a chain against its
JAX twin, fp32 on both sides: within 1e-5 of the largest |x| (rtol 1e-5)."""

import argparse
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.diffusion import langevin_extras as jle
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.diffusion import samplers as jsamplers
from mcvd_tpu.eval.video_gen import make_block_sampler as jax_make_block_sampler
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu_torch.compat import load_flax_params
from mcvd_tpu_torch.config import dict2namespace
from mcvd_tpu_torch.diffusion import langevin_extras as le
from mcvd_tpu_torch.diffusion import make_schedule, samplers
from mcvd_tpu_torch.diffusion.schedules import DiffusionSchedule
from mcvd_tpu_torch.eval import make_block_sampler
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.runners.runner import Runner
from mcvd_tpu_torch.train import create_train_state
from mcvd_tpu_torch.train.checkpoints import save_checkpoint
from tests.test_torch_port_ncsnv2 import ncsn_dict, np_params, torch_threads  # noqa: F401

GOLD = os.path.join(os.path.dirname(__file__), "golden", "langevin_extras.npz")
CHAIN_REL = 1e-5
ORACLE_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_langevin_extras_oracle.py
B, H, W, C = 2, 8, 8, 3


def ladder(L=5, begin=1.0, end=0.01):
    return np.exp(np.linspace(np.log(begin), np.log(end), L)).astype(np.float32)


def scheds(sigmas):
    from mcvd_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule

    return (JaxSchedule(version="SMLD", schedule="geometric", sigmas=sigmas),
            DiffusionSchedule(version="SMLD", schedule="geometric", sigmas=sigmas))


def toy_eps(sigmas, lib):
    """The golden generator's closed-form network: by label, and by sigma."""
    def f(x, s):
        sb = s.reshape((-1,) + (1,) * (x.ndim - 1))
        return -0.5 * x / (1.0 + sb) + 0.05 * lib.sin(3.0 * x)
    if lib is jnp:
        sig = jnp.asarray(sigmas)
        return (lambda x, labels: f(x, sig[labels])), f
    sig = torch.from_numpy(sigmas)
    return (lambda x, labels: f(x, sig[labels.cpu()])), f


def normals(key, n, shape):
    """The JAX samplers' per-step draws: normal(k, shape) for each of n keys."""
    keys = jax.random.split(key, n)
    return np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys])


def close(got, want, rel=CHAIN_REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def x0(seed=0, shape=(B, H, W, C)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- samplers

LANGEVIN = {  # id: keyword arguments of both samplers
    "final": {},
    "trajectory": dict(final_only=False),
    "no_denoise_trajectory": dict(final_only=False, denoise=False),
    "harm_mean": dict(harm_mean=True),
    "frac_steps": dict(frac_steps=0.6, final_only=False),
}


@pytest.mark.parametrize("name", list(LANGEVIN))
def test_anneal_langevin_matches_jax(name):
    kw, n = LANGEVIN[name], 3
    sig = ladder()
    js, ts = scheds(sig)
    key = jax.random.PRNGKey(4)
    x = x0()
    L = len(sig) if "frac_steps" not in kw else len(sig) - int((1 - kw["frac_steps"]) * len(sig))
    want = jsamplers.anneal_langevin_dynamics(key, jnp.asarray(x), toy_eps(sig, jnp)[0], js,
                                              n_steps_each=n, step_lr=1e-3, **kw)
    noise = normals(key, L * n, x.shape).reshape(L, n, *x.shape)
    got = samplers.anneal_langevin_dynamics(torch.from_numpy(x), toy_eps(sig, torch)[0], ts,
                                            n_steps_each=n, step_lr=1e-3,
                                            step_noise=torch.from_numpy(noise), **kw)
    assert got.shape == want.shape
    close(got, want)


def test_anneal_langevin_same_noise_and_generator():
    """same_noise reuses noise_val (x_init when None) at every step, as the
    JAX sampler does; with neither draws nor a generator the sampler raises."""
    sig = ladder()
    js, ts = scheds(sig)
    x = x0(1)
    want = jsamplers.anneal_langevin_dynamics(jax.random.PRNGKey(0), jnp.asarray(x),
                                              toy_eps(sig, jnp)[0], js, n_steps_each=2,
                                              step_lr=1e-3, same_noise=True)
    got = samplers.anneal_langevin_dynamics(torch.from_numpy(x), toy_eps(sig, torch)[0], ts,
                                            n_steps_each=2, step_lr=1e-3, same_noise=True)
    close(got, want)
    with pytest.raises(ValueError, match="Generator"):
        samplers.anneal_langevin_dynamics(torch.from_numpy(x), toy_eps(sig, torch)[0], ts,
                                          n_steps_each=2)
    g = torch.Generator().manual_seed(0)
    out = samplers.anneal_langevin_dynamics(torch.from_numpy(x), toy_eps(sig, torch)[0], ts,
                                            n_steps_each=2, generator=g)
    assert out.shape == (1,) + x.shape and bool(torch.isfinite(out).all())
    assert samplers.get_sampler("smld") is samplers.anneal_langevin_dynamics


@pytest.mark.parametrize("denoise", ["label", "sigma", "none_trajectory"])
def test_anneal_langevin_consistent_matches_jax(denoise):
    sig, n = ladder(4), 2
    js, ts = scheds(sig)
    key = jax.random.PRNGKey(6)
    x = x0(2)
    kw = dict(n_steps_each=n, step_lr=1e-4)
    jl, jsig = toy_eps(sig, jnp)
    tl, tsig = toy_eps(sig, torch)
    if denoise == "none_trajectory":
        kw.update(denoise=False, final_only=False)
    want = jsamplers.anneal_langevin_dynamics_consistent(
        key, jnp.asarray(x), jsig, js, eps_fn_label=jl if denoise == "label" else None, **kw)
    T = (len(sig) - 1) * n + 1
    noise = normals(key, T, x.shape)
    got = samplers.anneal_langevin_dynamics_consistent(
        torch.from_numpy(x), tsig, ts, eps_fn_label=tl if denoise == "label" else None,
        step_noise=torch.from_numpy(noise), **kw)
    assert got.shape == want.shape
    close(got, want)
    with pytest.raises(AssertionError, match="Could not satisfy"):
        samplers.anneal_langevin_dynamics_consistent(
            torch.from_numpy(x), tsig, ts, n_steps_each=n, step_lr=1e-2,
            step_noise=torch.from_numpy(noise))


@pytest.mark.parametrize("n", [0, -1, 1, 5])
def test_check_n_steps_each_matches_jax(n):
    if n < 1:
        for f in (jsamplers.check_n_steps_each, samplers.check_n_steps_each):
            with pytest.raises(ValueError, match="n_steps_each"):
                f(n)
    else:
        assert samplers.check_n_steps_each(n) == jsamplers.check_n_steps_each(n) == n


# ------------------------------------------------------------------ extras

def extras_noises(name, key, sig, n, shape):
    """The JAX extras' draws for `key`, in the shapes of their `noises`."""
    L = len(sig)
    Bx, Hx, Wx, Cx = shape
    if name in ("inpainting", "interpolation"):
        keys = jax.random.split(key, L * n)
        pairs = [jax.random.split(k) for k in keys]
        if name == "inpainting":
            corrupt = np.stack([np.asarray(jax.random.normal(a, (Bx, Hx, Wx // 2, Cx)))
                                for a, _ in pairs]).reshape(L, n, Bx, Hx, Wx // 2, Cx)
            step = np.stack([np.asarray(jax.random.normal(b, shape))
                             for _, b in pairs]).reshape(L, n, *shape)
            return corrupt, step
        return np.stack([np.stack([np.asarray(jax.random.normal(a, shape)),
                                   np.asarray(jax.random.normal(b, shape))])
                         for a, b in pairs]).reshape(L, n, 2, *shape)
    if name == "sparse":
        return normals(key, L * n, shape).reshape(L, n, *shape)
    return normals(key, (L - 1) * n + 1, shape)[:-1]


def run_extra(name, lib, x, refer, sig, sched, noises, key, final_only):
    m = jle if lib is jnp else le
    arr = jnp.asarray if lib is jnp else torch.from_numpy
    lab, by_sig = toy_eps(sig, lib)
    kw = dict(n_steps_each=2, final_only=final_only)
    head = (key,) if lib is jnp else ()
    if noises is not None:
        kw["noises"] = (tuple(arr(a) for a in noises) if isinstance(noises, tuple)
                        else arr(noises))
    if name == "inpainting":
        return m.anneal_langevin_inpainting(*head, arr(x), arr(refer), lab, sched,
                                            step_lr=1e-5, **kw)
    if name == "interpolation":
        return m.anneal_langevin_interpolation(*head, arr(x), lab, sched, 3, step_lr=1e-5,
                                               **kw)
    if name == "sparse":
        return m.sparse_anneal_langevin(*head, arr(x), 2.0, lab, sched, step_lr=1e-5, **kw)
    return m.sparse_anneal_langevin_consistent(*head, arr(x), 2.0, by_sig, sched,
                                               step_lr=1e-4, score_fn_label=lab, **kw)


EXTRAS = ["inpainting", "interpolation", "sparse", "sparse_consistent"]


@pytest.mark.parametrize("final_only", [True, False], ids=["final", "trajectory"])
@pytest.mark.parametrize("name", EXTRAS)
def test_langevin_extra_matches_jax(name, final_only):
    """Each extra with the JAX function's own draws (from its key) replayed
    into the port's `noises`."""
    sig = ladder(4)
    js, ts = scheds(sig)
    key = jax.random.PRNGKey(len(name))
    x, refer = x0(3), x0(4)
    want = run_extra(name, jnp, x, refer, sig, js, None, key, final_only)
    noises = extras_noises(name, key, sig, 2, x.shape)
    got = run_extra(name, torch, x, refer, sig, ts, noises, None, final_only)
    assert got.shape == want.shape
    close(got, want)


def _gold_noises(g, tag):
    return [g[f"{tag}::noise{i:04d}"] for i in range(int(g[f"{tag}::n_noise"]))]


def nhwc(a):
    return np.moveaxis(a, -3, -1)


@pytest.mark.parametrize("name", EXTRAS)
def test_langevin_extra_matches_upstream_golden(name):
    """The trajectories of upstream's functions run with a recorded noise
    stream (`tools/make_langevin_goldens.py`), as
    `tests/test_langevin_extras_oracle.py` holds the JAX functions to them."""
    g = np.load(GOLD)
    sig = np.asarray(g["sigmas"], np.float32)
    _, ts = scheds(sig)
    L, n = len(sig), 2
    tag = name
    ns = [nhwc(a) for a in _gold_noises(g, tag)]
    if name == "inpainting":
        x = nhwc(g["inpainting::x0"].reshape(B, C, H, W))
        noises = (np.stack(ns[0::2]).reshape(L, n, B, H, W // 2, C),
                  np.stack(ns[1::2]).reshape(L, n, B, H, W, C))
        got = run_extra(name, torch, x, nhwc(g["inpainting::refer"]), sig, ts, noises, None,
                        False)
        np.testing.assert_allclose(got.numpy(), nhwc(g["inpainting::traj"]), **ORACLE_TOL)
    elif name == "interpolation":
        x = nhwc(g["interpolation::x0"])
        noises = np.stack([np.stack([p, q]) for p, q in zip(ns[0::2], ns[1::2])]).reshape(
            L, n, 2, B, H, W, C)
        got = run_extra(name, torch, x, None, sig, ts, noises, None, False)
        np.testing.assert_allclose(got.numpy(), nhwc(g["interpolation::traj"]), **ORACLE_TOL)
    elif name == "sparse":
        x = nhwc(g["sparse::x0"])
        got = run_extra(name, torch, x, None, sig, ts,
                        np.stack(ns).reshape(L, n, B, H, W, C), None, False)
        np.testing.assert_allclose(got.numpy(), nhwc(g["sparse::traj"]), **ORACLE_TOL)
    else:   # upstream's loop rows all alias its last pre-denoise dense state
        x = nhwc(g["sparse::x0"])
        ref = nhwc(g["sparse_consistent::traj"])
        got = run_extra(name, torch, x, None, sig, ts, np.stack(ns), None, False).numpy()
        T = len(ref) - 1
        np.testing.assert_allclose(got[T - 1], ref[0], **ORACLE_TOL)
        np.testing.assert_allclose(got[T], ref[T], **ORACLE_TOL)
        ns2 = np.stack([nhwc(a) for a in _gold_noises(g, "sparse_consistent_final")])
        final = run_extra(name, torch, x, None, sig, ts, ns2, None, True)
        np.testing.assert_allclose(final.numpy(), nhwc(g["sparse_consistent_final::traj"])[0],
                                   **ORACLE_TOL)


# ---------------------------------------------------------- the SMLD block

def test_smld_block_matches_jax_block_sampler():
    """One SMLD block (4 levels x 2 steps + denoise, B=2) of a tiny NCSNv2 on
    the same numpy weights through both packages' `make_block_sampler`; the
    JAX block's draws (from the key it is given) replayed as the port's
    `step_noise`; the JAX block's SMLD keyword filter (n_steps_each and
    step_lr from the config)."""
    d = ncsn_dict(size=16)
    d["model"]["num_classes"] = 4
    d["sampling"] = {"n_steps_each": 2, "step_lr": 1e-4, "denoise": True, "subsample": 1000,
                     "clip_before": True, "init_prev_t": -1, "compute_dtype": "float32"}
    jcfg, tcfg = jax_dict2namespace(d), dict2namespace(d)
    jmodel = jax_get_model(jcfg)
    jsched, sched = jax_make_schedule(jcfg), make_schedule(tcfg)
    sz, Bb = 16, 2
    params = np_params(jmodel, 21, jnp.zeros((Bb, sz, sz, 3)), jnp.zeros((Bb,), jnp.int32))
    init = np.random.RandomState(22).rand(Bb, sz, sz, 3).astype(np.float32)
    key = jax.random.PRNGKey(23)
    want = np.asarray(jax_make_block_sampler(jcfg, jmodel, jsched)(
        params, key, jnp.asarray(init), None, None))
    model = get_model(tcfg, device="cpu")
    load_flax_params(model, params)
    noise = normals(key, 4 * 2, init.shape).reshape(4, 2, *init.shape)
    got = make_block_sampler(tcfg, model, sched)(dict(model.named_parameters()),
                                                 torch.from_numpy(init), None,
                                                 step_noise=torch.from_numpy(noise))
    assert got.shape == want.shape == (Bb, sz, sz, 3)
    close(got, want, rel=1e-4)


# ------------------------------------------------------------------ runner

def runner_config(**sampling):
    d = ncsn_dict(size=32, ngf=4)
    d["model"].update(num_classes=3, ema=True, ema_rate=0.999)
    d["data"].update(random_flip=False, num_workers=0)
    d["training"].update(batch_size=2)
    d["sampling"] = {"batch_size": 2, "n_steps_each": 2, "step_lr": 6.2e-6,
                     "n_interpolations": 3, "inpainting": False, "interpolation": False,
                     "fid": False, "denoise": True, **sampling}
    return dict2namespace(d)


@pytest.fixture(scope="module")
def smld_run(tmp_path_factory):
    """Synthetic CIFAR-10 pickles and one checkpoint (step 7) of a tiny
    cifar10_ncsnv2-shaped model."""
    tmp = tmp_path_factory.mktemp("smld")
    rng = np.random.default_rng(0)
    (tmp / "data").mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(tmp / "data" / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                         b"labels": [0, 1, 2, 3]}, f)
    config = runner_config()
    model = get_model(config, generator=torch.Generator().manual_seed(1), device="cpu")
    state = create_train_state(config, model, device="cpu")
    state.step = 7
    save_checkpoint(str(tmp / "logs"), state, name="checkpoint")
    return tmp


def smld_runner(tmp, out, **sampling):
    args = argparse.Namespace(data_path=str(tmp / "data"), log_path=str(tmp / "logs"),
                              image_folder=str(out), seed=0, device="cpu")
    return Runner(args, runner_config(**sampling))


def test_runner_inpainting_writes_samples_and_refer(smld_run, tmp_path):
    """`sample` with sampling.inpainting: inpainting_7.npz holds samples and
    refer, (B, 32, 32, 3) in [0, 1]-space; refer is the first test batch;
    the known (left) half ends within a few sigma_L of it."""
    smld_runner(smld_run, tmp_path, inpainting=True).sample()
    z = np.load(tmp_path / "inpainting_7.npz")
    assert sorted(z.files) == ["refer", "samples"]
    assert z["samples"].shape == z["refer"].shape == (2, 32, 32, 3)
    assert np.isfinite(z["samples"]).all()
    with open(smld_run / "data" / "test_batch", "rb") as f:
        raw = pickle.load(f, encoding="bytes")[b"data"][:2]
    want = raw.reshape(2, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    np.testing.assert_allclose(z["refer"], want, rtol=0, atol=1e-6)
    left = np.abs(z["samples"][:, :, :16] - z["refer"][:, :, :16]).max()
    right = np.abs(z["samples"][:, :, 16:] - z["refer"][:, :, 16:]).max()
    assert left < 0.1 < right, (left, right)


def test_runner_interpolation_writes_the_grid(smld_run, tmp_path):
    """`sample` with sampling.interpolation: interpolation_7.npz holds B *
    n_interpolations samples; rows of one input differ only by their noise
    mix; a DDPM-family config refuses the branch."""
    out = smld_runner(smld_run, tmp_path, interpolation=True).sample()
    z = np.load(tmp_path / "interpolation_7.npz")
    assert z.files == ["samples"] and z["samples"].shape == (6, 32, 32, 3)
    np.testing.assert_array_equal(z["samples"], out)
    assert np.isfinite(out).all() and not np.allclose(out[0], out[1])
    runner = smld_runner(smld_run, tmp_path, interpolation=True)
    runner.sched = DiffusionSchedule(version="DDPM", schedule="linear")
    with pytest.raises(ValueError, match="SMLD"):
        runner.sample()


def test_runner_test_and_fid_dump_on_smld(smld_run, tmp_path):
    """The other evaluation modes on the SMLD family: `test` gives the SMLD
    DSM loss of the checkpoint (finite), and `sample` with sampling.fid
    dumps Langevin samples (the block sampler's SMLD branch) as shards."""
    runner = smld_runner(smld_run, tmp_path, fid=True, num_samples4fid=4)
    runner.config.test = dict2namespace({"batch_size": 2, "max_batches": 1})
    losses = runner.test()
    assert len(losses) == 1 and all(np.isfinite(v) for v in losses.values())
    assert runner.sample() == 4
    shards = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("fid_samples_7"))
    assert len(shards) == 2
    z = np.load(tmp_path / shards[0])
    assert z["samples"].shape == (2, 32, 32, 3) and np.isfinite(z["samples"]).all()
