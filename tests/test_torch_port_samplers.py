"""The port's DDIM and F-PNDM samplers and its gamma noise against the JAX
package, with the JAX random draws replayed into the port (split the keys as
the JAX code does, draw in JAX, hand the arrays over): the samplers on a toy
eps, gamma noise in `dsm_loss`, `ddpm_sampler` and `init_noise`, the block
sampler under `version: DDIM` and `FPNDM` on a tiny model, and
`noise_in_cond` through the block sampler and the eval loss step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.diffusion import loss as jax_loss
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.diffusion import samplers as jax_samplers
from mcvd_tpu.eval import video_gen as jax_video_gen
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu.train import make_eval_loss_step as jax_make_eval_loss_step
from mcvd_tpu.train.step import _as_impl_key
from mcvd_tpu_torch.compat import load_flax_params, torch_state_dict_from_flax
from mcvd_tpu_torch.config import dict2namespace
from mcvd_tpu_torch.diffusion import dsm_loss, make_schedule, samplers
from mcvd_tpu_torch.eval import video_gen
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.train import make_eval_loss_step

# Sampler chains, fp32 (test_torch_port_sampling.py's CHAIN_TOL): atol 1e-3.
# Each step divides by sqrt(alpha) (down to ~0.07 at the most-noised level of
# the 1000-step schedule), so ~1e-6 differences in summation order grow
# along the chain.
CHAIN_TOL = dict(rtol=0, atol=1e-3)


def sched_config(gamma=False, T=1000):
    return {"model": {"version": "DDPM", "sigma_dist": "linear", "sigma_begin": 0.02,
                      "sigma_end": 0.0001, "num_classes": T, "gamma": gamma}}


def schedules(gamma=False, T=1000):
    d = sched_config(gamma, T)
    return jax_make_schedule(jax_dict2namespace(d)), make_schedule(dict2namespace(d))


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(0, 3, 1, 2)


def toy_eps_jax(x, labels):
    c = 0.05 + 0.0005 * labels.astype(jnp.float32)
    return c.reshape(-1, *([1] * (x.ndim - 1))) * x + 0.1 * jnp.tanh(x)


class ToyEps:
    """The same toy eps on the port, counting its evaluations."""

    def __init__(self):
        self.calls = 0
        self.labels = []

    def __call__(self, x, labels):
        self.calls += 1
        self.labels.append(int(labels[0]))
        c = 0.05 + 0.0005 * labels.float()
        return c.reshape(-1, *([1] * (x.ndim - 1))) * x + 0.1 * torch.tanh(x)


SHAPE = (2, 4, 4, 3)


def x_init(seed=0):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


def replay_draws(key, L, gamma_k=None):
    """`ddpm_sampler`'s draws from `key`: split(key) -> (key, inj_key), then
    split(key, L), one draw per step: N(0, 1), or with `gamma_k` (the
    subsampled k_cum) Gamma(k_i, 1) as `_gamma_noise` draws it."""
    key, inj_key = jax.random.split(key)
    step_keys = jax.random.split(key, L)
    if gamma_k is None:
        draw = [jax.random.normal(k, SHAPE, jnp.float32) for k in step_keys]
        inj = jax.random.normal(inj_key, SHAPE, jnp.float32)
    else:
        draw = [jax.random.gamma(k, gamma_k[i], shape=SHAPE) for i, k in enumerate(step_keys)]
        inj = jax.random.gamma(inj_key, gamma_k[0], shape=SHAPE)
    return torch.from_numpy(np.array(inj)), torch.from_numpy(np.stack(draw))


# ------------------------------------------------------------ DDIM and F-PNDM

@pytest.mark.parametrize("kw", [
    dict(subsample_steps=10),
    dict(subsample_steps=100),
    dict(subsample_steps=10, clip_before=False),
    dict(subsample_steps=100, clip_before=False, denoise=False),
    dict(subsample_steps=10, final_only=False),
    dict(subsample_steps=20, t_min=0.5),
    dict(frac_steps=0.02),
], ids=["sub10", "sub100", "sub10_noclip", "sub100_noclip_nodenoise", "traj", "tmin",
        "frac"])
def test_ddim_sampler_toy_matches_jax(kw):
    """DDIM (eta 0) on a toy eps; with t_min the injection noise replayed. A
    block of L steps makes L evaluations and one more to denoise."""
    jsched, sched = schedules()
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_samplers.ddim_sampler(key, jnp.asarray(x_init()), toy_eps_jax,
                                                jsched, **kw))
    L = len(jax_samplers._prepare_tables(jsched, kw.get("subsample_steps"),
                                         kw.get("frac_steps"), kw.get("t_min", -1.0)).steps)
    inj, _ = replay_draws(key, L)
    eps = ToyEps()
    got = samplers.ddim_sampler(torch.from_numpy(x_init()), eps, sched, inj_noise=inj, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)
    assert eps.calls == L + kw.get("denoise", True)
    if kw.get("denoise", True):   # the label-L-1 quirk of the denoise step
        assert eps.labels[-1] == L - 1
    if kw == dict(subsample_steps=100):
        assert eps.calls == 101


@pytest.mark.parametrize("sub,kw", [(10, {}), (100, {}), (10, dict(clip_before=False)),
                                    (100, dict(clip_before=False)),
                                    (10, dict(final_only=False)), (2, {}), (1, {}),
                                    (2, dict(final_only=False))],
                         ids=["sub10", "sub100", "sub10_noclip", "sub100_noclip", "traj",
                              "2_steps", "1_step", "2_steps_traj"])
def test_fpndm_sampler_toy_matches_jax(sub, kw):
    """F-PNDM on a toy eps: 4 evaluations on each of the first 3 steps (the
    Runge-Kutta warm-up), one on each after, no denoise (109 at subsample
    100); at most 3 steps is the warm-up alone. Labels: t, then the
    truncated midpoint int((t + t_next) / 2) twice, then t_next (-1 on the
    first step)."""
    jsched, sched = schedules()
    want = np.asarray(jax_samplers.fpndm_sampler(jax.random.PRNGKey(0),
                                                 jnp.asarray(x_init(1)), toy_eps_jax, jsched,
                                                 subsample_steps=sub, **kw))
    eps = ToyEps()
    got = samplers.fpndm_sampler(torch.from_numpy(x_init(1)), eps, sched,
                                 subsample_steps=sub, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)
    L = len(range(0, 1000, 1000 // sub))
    assert eps.calls == 4 * min(L, 3) + max(L - 3, 0)
    if sub == 100:
        assert eps.calls == 109
    assert eps.labels[:4] == [0, 0, 0, -1]   # t=0, t_next=-1: the midpoint is 0


def test_fpndm_needs_subsample_steps():
    _, sched = schedules()
    with pytest.raises(ValueError, match="subsample_steps"):
        samplers.fpndm_sampler(torch.zeros(SHAPE), ToyEps(), sched)


def test_get_sampler_versions():
    """Every `model.version` of the JAX package's SAMPLERS: DDPM, DDIM,
    FPNDM and (since PR 12) SMLD's annealed Langevin dynamics; another name
    raises, as the JAX dispatch does."""
    assert samplers.get_sampler("ddim") is samplers.ddim_sampler
    assert samplers.get_sampler("FPNDM") is samplers.fpndm_sampler
    assert samplers.get_sampler("DDPM") is samplers.ddpm_sampler
    assert samplers.get_sampler("SMLD") is samplers.anneal_langevin_dynamics
    with pytest.raises(KeyError):
        samplers.get_sampler("EULER")


# ------------------------------------------------------------ gamma noise

@pytest.mark.parametrize("kw", [dict(subsample_steps=10), dict(subsample_steps=20, t_min=0.5),
                                dict(subsample_steps=10, final_only=False),
                                dict(subsample_steps=100, t_min=0.95)],
                         ids=["sub10", "tmin", "traj", "tmin_late"])
def test_ddpm_sampler_gamma_matches_jax(kw):
    """DDPM with gamma noise: each step's Gamma(k_i, 1) draw (and the t_min
    injection's Gamma(k_0, 1)) replayed from the JAX keys, centred and
    scaled by the port."""
    jsched, sched = schedules(gamma=True)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_samplers.ddpm_sampler(key, jnp.asarray(x_init(2)), toy_eps_jax,
                                                jsched, gamma=True, **kw))
    t = jax_samplers._prepare_tables(jsched, kw.get("subsample_steps"), None,
                                     kw.get("t_min", -1.0))
    inj, step = replay_draws(key, len(t.steps), gamma_k=t.k_cum)
    got = samplers.ddpm_sampler(torch.from_numpy(x_init(2)), ToyEps(), sched, gamma=True,
                                inj_noise=inj, step_noise=step, **kw)
    # The noise is (g theta - k theta) / sqrt(1 - a) with g and k near k_cum
    # (up to 2.5e10): in fp32 g theta keeps ulp(k theta) of it, some 1% of
    # the noise at the most-noised levels. Eager JAX computes it bit for bit
    # as the port does; XLA's fused scan body rounds in another order. So
    # beside CHAIN_TOL each step may differ by two such roundings, scaled by
    # the step's noise std.
    f32 = np.float32
    a, ap, b = t.alphas, t.alphas_prev, t.betas
    std = np.sqrt((f32(1) - ap) / (f32(1) - a) * b)
    ulp = np.spacing((t.k_cum * t.theta_t).astype(f32))
    atol = CHAIN_TOL["atol"] + float(np.sum(std * 2 * ulp / np.sqrt(f32(1) - a)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    eager = jax_samplers._gamma_noise(jax.random.PRNGKey(1), SHAPE, t.k_cum[0], t.theta_t[0],
                                      t.alphas[0])
    g0 = jax.random.gamma(jax.random.PRNGKey(1), t.k_cum[0], shape=SHAPE)
    assert np.array_equal(samplers._gamma_noise(torch.from_numpy(np.array(g0)), t.k_cum[0],
                                                t.theta_t[0], t.alphas[0]).numpy(),
                          np.asarray(eager))
    # the generator route draws Gamma too: same seed, same chain
    a, b = (samplers.ddpm_sampler(torch.from_numpy(x_init(2)), ToyEps(), sched, gamma=True,
                                  generator=torch.Generator().manual_seed(0), **kw)
            for _ in range(2))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_dsm_loss_gamma_matches_jax():
    """The DSM loss with gamma noise: labels and the Gamma(k_cum[t], 1) draw
    replayed from JAX's split of the key; rtol 1e-6, the same fp32 math."""
    jsched, sched = schedules(gamma=True, T=50)
    rng = np.random.RandomState(5)
    B = 4
    x = rng.randn(B, 8, 8, 3).astype(np.float32)

    def jfn(x_t, labels, c, m):
        return 0.7 * x_t * (1 + labels[:, None, None, None] / 100.0)

    def tfn(x_t, labels, c, m):
        return 0.7 * x_t * (1 + labels[:, None, None, None] / 100.0)

    key = jax.random.PRNGKey(6)
    want = float(jax_loss.dsm_loss(key, jfn, jnp.asarray(x), jsched, gamma=True))
    key_t, key_z = jax.random.split(key)
    labels = jax.random.randint(key_t, (B,), 0, 50)
    k = jnp.asarray(jsched.k_cum)[labels].reshape(B, 1, 1, 1)
    g = jax.random.gamma(key_z, jnp.broadcast_to(k, x.shape))
    got = dsm_loss(tfn, to_nchw(x), sched, labels=torch.from_numpy(np.asarray(labels)),
                   z=to_nchw(g), gamma=True)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    drawn = dsm_loss(tfn, to_nchw(x), sched, gamma=True, generator=torch.Generator())
    assert bool(torch.isfinite(drawn))


def test_init_noise_gamma_matches_jax():
    """init_noise with gamma: g theta_0 - k_0 theta_0 from the Gamma(k_0, 1)
    draw, fed from JAX; from a generator, the same centred distribution."""
    d = sched_config(gamma=True)
    jconfig, config = jax_dict2namespace(d), dict2namespace(d)
    jsched, sched = jax_make_schedule(jconfig), make_schedule(config)
    key = jax.random.PRNGKey(8)
    shape = (2, 8, 8, 3)
    want = np.asarray(jax_video_gen.init_noise(key, jconfig, jsched, shape))
    g = jax.random.gamma(key, float(jsched.k_cum[0]), shape)
    got = video_gen.init_noise(config, sched, shape, device="cpu",
                               draw=torch.from_numpy(np.asarray(g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    z = video_gen.init_noise(config, sched, (64, 64, 64), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    std = float(np.sqrt(sched.k_cum[0]) * sched.theta_t[0])
    assert abs(float(z.mean())) < 0.01 * std and abs(float(z.std()) / std - 1) < 0.01


# ------------------------------------------------------------ on a tiny model

def tiny_config(version="DDPM", noise_in_cond=False):
    """The tiny flagship (16 px, ngf 16, ch_mult [1,2]) at 2 pred + 2 cond
    frames, 5-step subsampled sampling."""
    config = __graft_entry__._flagship_config(tiny=True)
    config.data.num_frames = 2
    config.data.num_frames_cond = 2
    config.model.dropout = 0.0
    config.model.version = version
    config.model.noise_in_cond = noise_in_cond
    config.sampling.subsample = 5
    return config


@pytest.fixture(scope="module")
def tiny_models():
    """noisy -> (JAX model, perturbed JAX params, port model with those
    weights) of the tiny model with and without noise_in_cond; each JAX
    init made once for the module."""
    cache = {}

    def get(noisy):
        if noisy not in cache:
            config = tiny_config(noise_in_cond=noisy)
            jmodel = jax_get_model(config)
            x = jnp.zeros((1, 16, 16, 2))
            sched = jax_make_schedule(config)
            init = jax.jit(lambda k, x, y, r: jmodel.init(k, x, y, x, sched=sched, rng=r))
            params = init(jax.random.PRNGKey(3), x, jnp.zeros((1,), jnp.int32),
                          jax.random.PRNGKey(0))["params"]
            rng = np.random.RandomState(3)
            params = jax.tree_util.tree_map(
                lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(np.float32),
                dict(params))
            model = get_model(config, device="cpu").eval()
            load_flax_params(model, params)
            cache[noisy] = jmodel, params, model
        return cache[noisy]

    return get


def port_params(params):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in torch_state_dict_from_flax(params).items()}


@pytest.mark.parametrize("version,noisy", [("DDIM", False), ("FPNDM", False), ("DDIM", True)],
                         ids=["DDIM-plain", "FPNDM-plain", "DDIM-noise_in_cond"])
def test_block_sampler_versions_match_jax(tiny_models, version, noisy):
    """make_block_sampler under `model.version: DDIM` or `FPNDM` on a tiny
    model against the JAX sampler of that version on the jitted JAX model,
    as the JAX block sampler calls it (its kwargs, its key as the model's
    rng); with noise_in_cond the block's one cond-noise draw is that key's
    normal."""
    jmodel, params, model = tiny_models(noisy)
    config = tiny_config(version, noise_in_cond=noisy)
    jsched, sched = jax_make_schedule(config), make_schedule(config)
    rng = np.random.RandomState(4)
    init, cond = (rng.randn(2, 16, 16, 2).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(11)
    jcond = jnp.asarray(cond)
    apply = jax.jit(lambda x, t: jmodel.apply({"params": params}, x, t, jcond, None,
                                              sched=jsched, rng=key))
    want = np.asarray(jax_samplers.get_sampler(version)(
        key, jnp.asarray(init), apply, jsched, final_only=True, denoise=True,
        subsample_steps=5, clip_before=True, t_min=-1, gamma=False)[-1])
    block = video_gen.make_block_sampler(config, model, sched)
    kw = {}
    if noisy:
        kw["cond_noise"] = to_nchw(jax.random.normal(key, cond.shape))
    got = block(port_params(params), torch.from_numpy(init), torch.from_numpy(cond), **kw)
    assert got.shape == want.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)
    if noisy:   # without the draw it comes from the generator, once a block
        a, b = (block(port_params(params), torch.from_numpy(init), torch.from_numpy(cond),
                      generator=torch.Generator().manual_seed(1)) for _ in range(2))
        assert torch.equal(a, b)


def test_autoregressive_predict_noise_in_cond_matches_jax(tiny_models):
    """noise_in_cond through autoregressive_predict, 2 blocks of 5 DDPM
    steps: each block's init, step noise and one cond-noise draw replayed
    from its JAX key."""
    jmodel, params, model = tiny_models(True)
    config = tiny_config(noise_in_cond=True)
    jsched, sched = jax_make_schedule(config), make_schedule(config)
    cond = np.random.RandomState(5).rand(2, 16, 16, 2).astype(np.float32) * 2 - 1
    key = jax.random.PRNGKey(21)
    jblock = jax_video_gen.make_block_sampler(config, jmodel, jsched)
    want = np.asarray(jax_video_gen.autoregressive_predict(
        config, jblock, params, key, jnp.asarray(cond), None, 4, 0, jsched))
    draws, k = [], key
    for _ in range(2):
        k, k_init, k_samp = jax.random.split(k, 3)
        k_steps, _ = jax.random.split(k_samp)
        step = np.stack([np.asarray(jax.random.normal(s, (2, 16, 16, 2)))
                         for s in jax.random.split(k_steps, 5)])
        draws.append({"init": torch.from_numpy(np.asarray(jax.random.normal(k_init,
                                                                            (2, 16, 16, 2)))),
                      "step_noise": torch.from_numpy(step),
                      "cond_noise": to_nchw(jax.random.normal(k_samp, (2, 16, 16, 2)))})
    block = video_gen.make_block_sampler(config, model, sched)
    got = video_gen.autoregressive_predict(config, block, port_params(params),
                                           torch.from_numpy(cond), None, 4, 0, sched,
                                           draws=draws)
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)


def test_autoregressive_predict_gamma_noise_in_cond_matches_jax(tiny_models):
    """noise_in_cond with gamma noise through autoregressive_predict, 2
    blocks of 5 DDPM steps on the 20-level schedule (k_cum up to 2.2e5, so
    fp32 keeps the centred Gamma noise to ~3e-5 of its std): each block's
    init and Gamma step noise replayed from its JAX key, and its cond noise
    as the JAX block draws it, from the block's one key at each evaluation's
    level, stacked one draw per evaluation through the `draws` route."""
    _, params, _ = tiny_models(True)
    config = tiny_config(noise_in_cond=True)
    config.model.gamma = True
    config.model.num_classes = 20
    jmodel = jax_get_model(config)
    jsched, sched = jax_make_schedule(config), make_schedule(config)
    cond = np.random.RandomState(7).rand(2, 16, 16, 2).astype(np.float32) * 2 - 1
    key = jax.random.PRNGKey(23)
    jblock = jax_video_gen.make_block_sampler(config, jmodel, jsched)
    want = np.asarray(jax_video_gen.autoregressive_predict(
        config, jblock, params, key, jnp.asarray(cond), None, 4, 0, jsched))
    t = jax_samplers._prepare_tables(jsched, 5, None, -1.0)
    L = len(t.steps)
    levels = list(t.steps) + [L - 1]   # one evaluation a step, then the denoise
    k_cum = jnp.asarray(jsched.k_cum)
    draws, k = [], key
    for _ in range(2):
        k, k_init, k_samp = jax.random.split(k, 3)
        k_steps, _ = jax.random.split(k_samp)
        step = np.stack([np.asarray(jax.random.gamma(s, t.k_cum[i], shape=(2, 16, 16, 2)))
                         for i, s in enumerate(jax.random.split(k_steps, L))])
        cond_noise = torch.stack([to_nchw(jax.random.gamma(
            k_samp, jnp.broadcast_to(k_cum[jnp.full((2,), y)].reshape(2, 1, 1, 1),
                                     (2, 16, 16, 2)))) for y in levels])
        init = jax_video_gen.init_noise(k_init, config, jsched, (2, 16, 16, 2))
        draws.append({"init": torch.from_numpy(np.asarray(init)),
                      "step_noise": torch.from_numpy(step), "cond_noise": cond_noise})
    model = get_model(config, device="cpu").eval()
    load_flax_params(model, params)
    block = video_gen.make_block_sampler(config, model, sched)
    got = video_gen.autoregressive_predict(config, block, port_params(params),
                                           torch.from_numpy(cond), None, 4, 0, sched,
                                           draws=draws)
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)
    short = [dict(d, cond_noise=d["cond_noise"][:L]) for d in draws]
    with pytest.raises(ValueError, match="gamma draws"):
        video_gen.autoregressive_predict(config, block, port_params(params),
                                         torch.from_numpy(cond), None, 4, 0, sched,
                                         draws=short)


@pytest.mark.parametrize("noisy", [False, True], ids=["plain", "noise_in_cond"])
def test_eval_loss_noise_in_cond_matches_jax(tiny_models, noisy):
    """The eval loss step with noise_in_cond: labels, z and the cond-noise
    draw ("cond_noise", from the step's k_cond) replayed from the JAX key;
    without them the port draws all three from its generator."""
    jmodel, params, model = tiny_models(noisy)
    config = tiny_config(noise_in_cond=noisy)
    jsched, sched = jax_make_schedule(config), make_schedule(config)
    X = np.random.RandomState(6).rand(2, 4, 16, 16, 1).astype(np.float32)
    key = jax.random.PRNGKey(41)
    want = float(jax_make_eval_loss_step(jmodel, jsched, config)(params, jnp.asarray(X), key))
    _, _, k_loss, _, k_cond = jax.random.split(_as_impl_key(key, config), 5)
    key_t, key_z = jax.random.split(k_loss)
    draws = {"labels": torch.from_numpy(np.asarray(jax.random.randint(key_t, (2,), 0, 1000))),
             "z": to_nchw(jax.random.normal(key_z, (2, 16, 16, 2)))}
    if noisy:
        draws["cond_noise"] = to_nchw(jax.random.normal(k_cond, (2, 16, 16, 2)))
    eval_step = make_eval_loss_step(model, sched, config)
    got = float(eval_step(port_params(params), torch.from_numpy(X), draws=draws))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    drawn = eval_step(port_params(params), torch.from_numpy(X),
                      generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(drawn))
