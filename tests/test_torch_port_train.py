"""The port's training slice against the JAX package: data transforms with
dequantization, masked conditioning, the DSM loss, the optimizer chain, EMA,
and whole train steps of the tiny flagship from bridged weights with the JAX
draws replayed (dropout off). On the CPU the GroupNorm and attention take
their plain forward and backward passes (`tests/test_torch_port_ops.py`
holds those against `jax.vjp`, and the kernels against them on the card).

Draws: the JAX step converts its key to the `rbg` impl and splits it into
(deq, mask, loss, dropout, cond) keys; the loss key splits into the noise
level's and the noise's. `jax_draws` makes the same draws with the JAX
functions and hands them to the port as explicit tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.data import conditioning as jax_cond
from mcvd_tpu.data import transforms as jax_tf
from mcvd_tpu.diffusion import loss as jax_loss
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.models import ema as jax_ema
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu.train import create_train_state as jax_create_train_state
from mcvd_tpu.train import make_eval_loss_step as jax_make_eval_loss_step
from mcvd_tpu.train import make_train_step as jax_make_train_step
from mcvd_tpu.train.state import make_optimizer as jax_make_optimizer
from mcvd_tpu.train.step import _as_impl_key
from mcvd_tpu_torch import ops
from mcvd_tpu_torch.compat import load_flax_params, torch_state_dict_from_flax
from mcvd_tpu_torch.config import dict2namespace, flagship_config
from mcvd_tpu_torch.data import conditioning_fn, data_transform, fold_frames, get_mode
from mcvd_tpu_torch.data import unfold_frames
from mcvd_tpu_torch.diffusion import dsm_loss, make_schedule
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.models.ema import ema_update
from mcvd_tpu_torch.train import (create_train_state, loss_for_batch, make_eval_loss_step,
                                  make_optimizer, make_train_step)


def nhwc(t):
    """Port NCHW fold -> numpy NHWC (the JAX layout)."""
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).permute(0, 3, 1, 2)


# ------------------------------------------------------------ data and loss

def data_config(**kw):
    return jax_dict2namespace({
        "data": {"channels": 1, "image_size": 8, "num_frames": 2, "num_frames_cond": 2,
                 "num_frames_future": kw.get("future", 0), "rescaled": True,
                 "logit_transform": False, "prob_mask_cond": kw.get("pmc", 0.0),
                 "prob_mask_future": kw.get("pmf", 0.0),
                 "prob_mask_sync": kw.get("sync", False),
                 "uniform_dequantization": kw.get("uniform", False),
                 "gaussian_dequantization": kw.get("gaussian", False)},
        "sampling": {"ssim": kw.get("ssim", True), "fvd": kw.get("fvd", False)},
    })


@pytest.mark.parametrize("uniform,gaussian", [(True, False), (False, True), (True, True)])
def test_dequantization_matches_jax(uniform, gaussian):
    """Same key for both draws, as the JAX transform takes them; rtol 1e-6:
    the same fp32 elementwise ops."""
    config = data_config(uniform=uniform, gaussian=gaussian)
    X = np.random.RandomState(0).rand(2, 3, 4, 4, 1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_tf.data_transform(config, jnp.asarray(X), key=key))
    draws = dict(uniform=torch.tensor(np.asarray(jax.random.uniform(key, X.shape))),
                 normal=torch.tensor(np.asarray(jax.random.normal(key, X.shape))))
    got = data_transform(config, torch.from_numpy(X), **draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # from a generator: dequantized, in range, and a draw of its own
    g = torch.Generator().manual_seed(0)
    a = data_transform(config, torch.from_numpy(X), generator=g)
    assert a.shape == X.shape and not torch.equal(a, data_transform(config, torch.from_numpy(X)))


def test_fold_unfold_match_jax():
    X = np.random.RandomState(1).randn(2, 4, 5, 6, 3).astype(np.float32)
    folded = fold_frames(torch.from_numpy(X))
    assert folded.shape == (2, 12, 5, 6)
    assert folded.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(folded), np.asarray(jax_cond.fold_frames(jnp.asarray(X))))
    np.testing.assert_array_equal(unfold_frames(folded, 4).numpy(), X)


COND_CASES = {"plain": {}, "masked": dict(pmc=0.5), "future": dict(future=1),
              "future_masked": dict(future=1, pmf=0.5),
              "both": dict(pmc=0.5, future=1, pmf=0.5),
              "sync": dict(pmc=0.5, future=1, pmf=0.5, sync=True),
              "future_off": dict(future=1, pmf=1.0)}


@pytest.mark.parametrize("case", list(COND_CASES))
def test_conditioning_matches_jax(case):
    """pred / cond / cond_mask from the same uniforms as JAX's split keys:
    exact (a selection and a product by 0 or 1)."""
    kw = COND_CASES[case]
    config = data_config(**kw)
    B = 6
    X = np.random.RandomState(2).rand(B, 5, 8, 8, 1).astype(np.float32)
    key = jax.random.PRNGKey(4)
    args = dict(num_frames_pred=2, prob_mask_cond=kw.get("pmc", 0.0),
                prob_mask_future=kw.get("pmf", 0.0))
    want = jax_cond.conditioning_fn(config, jnp.asarray(X), key=key, **args)
    draws, k = {}, key
    if args["prob_mask_cond"] > 0:
        k, k1 = jax.random.split(k)
        draws["cond"] = torch.from_numpy(np.asarray(jax.random.uniform(k1, (B,))))
    if 0 < args["prob_mask_future"] < 1 and not kw.get("sync", False):
        k, k2 = jax.random.split(k)
        draws["future"] = torch.from_numpy(np.asarray(jax.random.uniform(k2, (B,))))
    got = conditioning_fn(config, torch.from_numpy(X), mask_draws=draws, **args)
    for name, a, b in zip(("pred", "cond"), got[:2], want[:2]):
        np.testing.assert_array_equal(nhwc(a), np.asarray(b), err_msg=name)
    if want[2] is None:
        assert got[2] is None
    else:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert conditioning_fn(config, torch.from_numpy(X), conditional=False, **args)[1] is None


def test_get_mode_matches_jax():
    cases = [{}, dict(future=2), dict(future=2, pmf=0.5), dict(pmc=0.5),
             dict(pmc=0.5, future=2, pmf=0.5), dict(pmc=0.5, future=2, pmf=0.5, sync=True),
             dict(ssim=False, fvd=True), dict(ssim=False)]
    for kw in cases:
        assert get_mode(data_config(**kw)) == jax_cond.get_mode(data_config(**kw)), kw


def loss_config(version, **model):
    d = {"model": {"version": version, "sigma_dist": "geometric" if version == "SMLD"
                   else "linear", "sigma_begin": 1.0 if version == "SMLD" else 0.02,
                   "sigma_end": 0.01 if version == "SMLD" else 0.0001,
                   "num_classes": 50, "gamma": False, **model}}
    return jax_dict2namespace(d), dict2namespace(d)


@pytest.mark.parametrize("case", ["SMLD", "DDPM", "L1", "all_frames"])
def test_dsm_loss_matches_jax(case):
    """A fixed score function on both sides (elementwise plus a mean over
    channels); labels and z replayed from JAX's split of the key. rtol 1e-6:
    the same fp32 math, summed in another order."""
    version = "SMLD" if case == "SMLD" else "DDPM"
    jcfg, tcfg = loss_config(version)
    jsched, tsched = jax_make_schedule(jcfg), make_schedule(tcfg)
    rng = np.random.RandomState(5)
    B = 4
    x = rng.randn(B, 8, 8, 3).astype(np.float32)
    cond = rng.randn(B, 8, 8, 2).astype(np.float32)
    kw = dict(L1=case == "L1", all_frames=case == "all_frames")

    def jfn(x_t, labels, c, m):
        return 0.7 * x_t * (1 + labels[:, None, None, None] / 100.0) + \
            0.05 * x_t.mean(axis=-1, keepdims=True)

    def tfn(x_t, labels, c, m):
        return 0.7 * x_t * (1 + labels[:, None, None, None] / 100.0) + \
            0.05 * x_t.mean(dim=1, keepdim=True)

    key = jax.random.PRNGKey(6)
    want = float(jax_loss.dsm_loss(key, jfn, jnp.asarray(x), jsched, cond=jnp.asarray(cond),
                                   **kw))
    key_t, key_z = jax.random.split(key)
    T = len(jsched.sigmas if version == "SMLD" else jsched.alphas)
    labels = torch.from_numpy(np.asarray(jax.random.randint(key_t, (B,), 0, T)))
    zshape = (B, 8, 8, 5 if kw["all_frames"] else 3)
    z = to_nchw(jax.random.normal(key_z, zshape))
    got = dsm_loss(tfn, to_nchw(x), tsched, labels=labels, z=z, cond=to_nchw(cond), **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="gamma"):
        dsm_loss(tfn, to_nchw(x), tsched, gamma=True)


# ------------------------------------------------------- optimizer and EMA

OPTIMIZERS = {"Adam": {}, "AdamW": dict(weight_decay=0.05), "amsgrad": dict(amsgrad=True),
              "RMSProp": dict(optimizer="RMSProp"), "SGD": dict(optimizer="SGD")}


def optim_config(name, warmup):
    optim = {"optimizer": "Adam", "lr": 1e-2, "warmup": warmup, "beta1": 0.9,
             "amsgrad": False, "eps": 1e-8, "grad_clip": 1.0, "weight_decay": 0.0,
             **OPTIMIZERS[name]}
    return jax_dict2namespace({"optim": optim}), dict2namespace({"optim": optim})


# rtol 1e-5, atol 1e-7: the same fp32 update rules in the same order, up to
# the global norm's summation order and the pow of the bias correction
# (one ulp each), over three steps.
OPT_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_chain_matches_optax(name, warmup):
    """Three updates of clip-by-global-norm + the optimizer with linear
    warmup: the clip both triggers (norm 3) and not (norm 0.5)."""
    jcfg, tcfg = optim_config(name, warmup)
    rng = np.random.RandomState(7)
    shapes = {"w": (3, 4), "b": (5,), "k": (2, 3, 3, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for norm in (3.0, 0.5, 2.0):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        total = np.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
        grads.append({k: v * np.float32(norm / total) for k, v in g.items()})

    tx = jax_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    opt = make_optimizer(tcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    for i, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **OPT_TOL,
                                       err_msg=f"{name} step {i} {k}")
    assert tstate["count"] == 3
    if warmup:   # the first update used lr 0
        assert opt.lr_at(0) == 0.0
    slots = {"Adam": ("mu", "nu"), "AdamW": ("mu", "nu"), "amsgrad": ("mu", "nu", "nu_max"),
             "RMSProp": ("nu",), "SGD": ("trace",)}[name]
    jslots = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "_fields") and slots[0] in s._fields)
        if hasattr(s, "_fields") and slots[0] in s._fields]
    assert len(jslots) == 1
    for slot in slots:
        for k in shapes:
            np.testing.assert_allclose(tstate[slot][k].numpy(),
                                       np.asarray(getattr(jslots[0], slot)[k]), **OPT_TOL,
                                       err_msg=f"{name} {slot} {k}")


def test_unknown_optimizer_raises():
    _, tcfg = optim_config("Adam", 0)
    tcfg.optim.optimizer = "Adagrad"
    with pytest.raises(NotImplementedError, match="Adagrad"):
        make_optimizer(tcfg)


def test_ema_update_matches_jax():
    """In place and equal to the JAX tree map (the same two fp32 products
    and one sum)."""
    rng = np.random.RandomState(8)
    shadow = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    params = {k: rng.randn(*v.shape).astype(np.float32) for k, v in shadow.items()}
    want = jax_ema.ema_update(shadow, params, 0.999)
    tshadow = {k: torch.from_numpy(v.copy()) for k, v in shadow.items()}
    ptrs = {k: v.data_ptr() for k, v in tshadow.items()}
    out = ema_update(tshadow, {k: torch.from_numpy(v) for k, v in params.items()}, 0.999)
    assert out is tshadow and all(v.data_ptr() == ptrs[k] for k, v in out.items())
    for k in shadow:
        np.testing.assert_array_equal(tshadow[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------ the slice

def tiny_configs(**training):
    jcfg = __graft_entry__._flagship_config(tiny=True)
    tcfg = flagship_config(tiny=True)
    for cfg in (jcfg, tcfg):
        cfg.model.dropout = 0.0
        cfg.optim.warmup = 0   # with warmup the first update is exactly zero
        for k, v in training.items():
            setattr(cfg.training, k, v)
    return jcfg, tcfg


def jax_draws(config, key, X_shape, n_labels):
    """The draws of the JAX step for `key`, as the port's explicit tensors."""
    k_deq, k_mask, k_loss, _k_drop, _k_cond = jax.random.split(_as_impl_key(key, config), 5)
    assert not getattr(config.data, "uniform_dequantization", False)
    assert getattr(config.data, "prob_mask_cond", 0.0) == 0.0
    B, _, H, W, C = X_shape
    key_t, key_z = jax.random.split(k_loss)
    return {"labels": torch.from_numpy(np.asarray(jax.random.randint(key_t, (B,), 0,
                                                                     n_labels))),
            "z": to_nchw(jax.random.normal(key_z, (B, H, W, config.data.num_frames * C)))}


def perturbed(params, seed, std=0.05):
    """Init params plus noise, so the zero-init layers take part."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + std * rng.randn(*a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, dict(params)))


def as_torch(tree):
    return torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, dict(tree)))


@dataclasses.dataclass
class Slice:
    jcfg: object
    tcfg: object
    params0: dict
    X: list
    keys: list
    states: list     # the JAX states after 0, 1, 2 steps
    metrics: list


@pytest.fixture(scope="module")
def jax_slice():
    """Two JAX train steps of the tiny flagship (B=2, fp32) from perturbed
    weights, and the inputs that made them."""
    jcfg, tcfg = tiny_configs()
    model = jax_get_model(jcfg)
    sched = jax_make_schedule(jcfg)
    B, sz = 2, jcfg.data.image_size
    x0 = jnp.zeros((B, sz, sz, 5))
    state = jax_create_train_state(jcfg, model, (x0, jnp.zeros((B,), jnp.int32), x0),
                                   jax.random.PRNGKey(0))
    params0 = perturbed(state.params, 21)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params0),
                          ema_params=jax.tree_util.tree_map(jnp.asarray, params0))
    rng = np.random.RandomState(22)
    X = [rng.rand(B, 10, sz, sz, 1).astype(np.float32) for _ in range(2)]
    keys = [jax.random.PRNGKey(31), jax.random.PRNGKey(32)]
    step = jax_make_train_step(model, sched, jcfg)
    states, metrics = [state], []
    for Xi, k in zip(X, keys):
        state, m = step(state, jnp.asarray(Xi), k)
        states.append(state)
        metrics.append({n: float(v) for n, v in m.items()})
    return Slice(jcfg, tcfg, params0, X, keys, states, metrics)


def port_state(sl, config=None):
    config = config or sl.tcfg
    model = get_model(config, device="cpu")
    load_flax_params(model, sl.params0)
    return model, create_train_state(config, model, device="cpu")


def adam_slots(jstate):
    adam = jstate.opt_state[1][0]
    return as_torch(adam.mu), as_torch(adam.nu)


def assert_close_to_max(got, want, rel, floor, what):
    """max |got - want| <= rel * max(max |want| over the tensor, floor)."""
    err = float((got - want).abs().max())
    assert err <= rel * max(float(want.abs().max()), floor), f"{what}: max err {err}"


# Tolerances of the slice, fp32. loss and grad_norm: rtol 1e-4. Gradients
# (and the Adam moments, mu = 0.1 g and nu = 0.001 g^2 after the first
# step): 1e-3 of each tensor's largest entry -- a few convolutions and
# GroupNorms deep, whose sums run in another order, with cancellations that
# leave some gradients far below their terms -- and no less than 1e-3 of
# 1e-6 of the model's largest gradient, the rounding noise of a gradient
# whose exact value is 0 (the key projection's bias: softmax ignores it).
# Parameters after an Adam step: the update is lr * mu_hat / (sqrt(nu_hat) +
# eps), at most lr in size, and its error is about lr * (error of mu) / |mu|.
# Where |mu| is at least 1e-2 of the tensor's largest (mu held to 1e-3 of
# that), the error is below 0.1*lr; where mu is smaller (its sign may come
# from rounding noise, as for the key bias) the update's own bound, 2*lr.
# EMA: 0.001 of the parameters' tolerance, plus the fp32 rounding of values
# O(1).
SLICE_RTOL = 1e-4
GRAD_REL = 1e-3


def test_train_steps_match_jax(jax_slice):
    sl = jax_slice
    model, state = port_state(sl)
    sched = make_schedule(sl.tcfg)
    step = make_train_step(model, sched, sl.tcfg)
    lr = sl.tcfg.optim.lr
    n_labels = len(sched.alphas)
    ops.reset_launches()
    for i, (Xi, k) in enumerate(zip(sl.X, sl.keys)):
        draws = jax_draws(sl.jcfg, k, Xi.shape, n_labels)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        loss = loss_for_batch(model, sched, sl.tcfg, state.params, torch.from_numpy(Xi),
                              train=True, draws=draws)
        grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
        state, m = step(state, torch.from_numpy(Xi), draws=draws)
        want = sl.metrics[i]
        np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=SLICE_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"], rtol=SLICE_RTOL)
        assert float(loss.detach()) == float(m["loss"])
        jstate = sl.states[i + 1]
        jparams, jema = as_torch(jstate.params), as_torch(jstate.ema_params)
        mu, nu = adam_slots(jstate)
        clip = min(1.0, 1.0 / want["grad_norm"])
        floor = 1e-6 * clip * max(float(g.abs().max()) for g in grads.values())
        if i == 0:
            # the JAX gradients, clipped: mu after one step is 0.1 * g
            for n, g in grads.items():
                assert_close_to_max(g * clip, mu[n] / 0.1, GRAD_REL, floor, f"grad {n}")
        for n in state.params:
            assert_close_to_max(state.opt_state["mu"][n], mu[n], GRAD_REL, 0.1 * floor,
                                f"mu {n}")
            assert_close_to_max(state.opt_state["nu"][n], nu[n], 2 * GRAD_REL,
                                1e-3 * floor ** 2, f"nu {n}")
            small = mu[n].abs() < 1e-2 * float(mu[n].abs().max())
            atol = torch.where(small, 2 * lr, 0.1 * lr)
            err = (state.params[n].detach() - jparams[n]).abs()
            assert bool((err <= atol).all()), f"param {n} step {i}: max err {float(err.max())}"
            ema_tol = 1e-3 * atol + 1e-6
            assert bool(((state.ema_params[n] - jema[n]).abs() <= ema_tol).all()), f"ema {n}"
            assert not torch.equal(state.params[n], before[n])
    assert state.step == 2 and state.opt_state["count"] == 2
    assert all(v == 0 for v in ops.LAUNCHES.values())   # plain versions on the CPU
    for p in state.params.values():
        assert p.dtype == torch.float32


def test_eval_loss_matches_jax(jax_slice):
    """The eval loss on the EMA after two steps, fp32 and dropout off."""
    sl = jax_slice
    jcfg = sl.jcfg
    jmodel = jax_get_model(jcfg)
    sched = make_schedule(sl.tcfg)
    key = jax.random.PRNGKey(41)
    jema = sl.states[2].ema_params
    want = float(jax_make_eval_loss_step(jmodel, jax_make_schedule(jcfg), jcfg)(
        jema, jnp.asarray(sl.X[0]), key))
    model, _ = port_state(sl)
    ema = {n: t for n, t in as_torch(jema).items()}
    eval_step = make_eval_loss_step(model, sched, sl.tcfg)
    got = eval_step(ema, torch.from_numpy(sl.X[0]),
                    draws=jax_draws(jcfg, key, sl.X[0].shape, len(sched.alphas)))
    np.testing.assert_allclose(float(got), want, rtol=SLICE_RTOL)


def test_bf16_step_within_the_jax_bf16_bounds(jax_slice):
    """training.compute_dtype=bfloat16 against the JAX fp32 step on the same
    weights and draws, held to the JAX package's own bf16 test's bounds
    (tests/test_data_and_train.py:167-206): loss within 5%, update cosine
    > 0.9; the master parameters stay fp32 and the metrics finite."""
    sl = jax_slice
    _, tcfg = tiny_configs(compute_dtype="bfloat16")
    model, state = port_state(sl, tcfg)
    sched = make_schedule(tcfg)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    draws = jax_draws(sl.jcfg, sl.keys[0], sl.X[0].shape, len(sched.alphas))
    state, m = make_train_step(model, sched, tcfg)(state, torch.from_numpy(sl.X[0]),
                                                   draws=draws)
    l16, l32 = float(m["loss"]), sl.metrics[0]["loss"]
    assert np.isfinite(l16) and np.isfinite(float(m["grad_norm"]))
    assert abs(l16 - l32) / max(abs(l32), 1.0) < 0.05, (l16, l32)
    jparams = as_torch(sl.states[1].params)
    num = den32 = den16 = 0.0
    for n, p in state.params.items():
        assert p.dtype == torch.float32
        d16 = (p.detach() - before[n]).double()
        d32 = (jparams[n] - before[n]).double()
        num += float((d16 * d32).sum())
        den16 += float((d16 * d16).sum())
        den32 += float((d32 * d32).sum())
    assert num / np.sqrt(den16 * den32) > 0.9


def test_train_step_draws_from_its_generator():
    """Dropout on: the step's generator, not torch's global one, draws every
    mask and noise; the same seed gives the same step, another seed another."""
    _, tcfg = tiny_configs()
    tcfg.model.dropout = 0.1
    losses = []
    for seed in (5, 5, 6):
        model = get_model(tcfg, device="cpu")
        state = create_train_state(tcfg, model, device="cpu")
        step = make_train_step(model, make_schedule(tcfg), tcfg)
        X = torch.rand(2, 10, 16, 16, 1, generator=torch.Generator().manual_seed(0))
        rng_before = torch.get_rng_state()
        _, m = step(state, X, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(torch.get_rng_state(), rng_before)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_uint8_clip_matches_float():
    """uint8 X holds round(x*255): the loss equals the float clip's."""
    _, tcfg = tiny_configs()
    model = get_model(tcfg, device="cpu")
    params = dict(model.named_parameters())
    sched = make_schedule(tcfg)
    Xu = torch.randint(0, 256, (2, 10, 16, 16, 1), generator=torch.Generator().manual_seed(1),
                       dtype=torch.uint8)
    draws = {"labels": torch.tensor([3, 700]), "z": torch.randn(2, 5, 16, 16)}
    with torch.no_grad():
        lu = loss_for_batch(model, sched, tcfg, params, Xu, train=False, draws=draws)
        lf = loss_for_batch(model, sched, tcfg, params, Xu.float() / 255.0, train=False,
                            draws=draws)
    assert float(lu) == float(lf)


def test_create_train_state_defaults_to_the_card(monkeypatch):
    _, tcfg = tiny_configs()
    model = get_model(tcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(tcfg, model)
    state = create_train_state(tcfg, model, device="cpu")
    for name, p in state.params.items():
        assert state.ema_params[name].data_ptr() != p.data_ptr()   # a real copy
        assert torch.equal(state.ema_params[name], p)


@pytest.mark.slow
def test_flagship_train_step_matches_jax():
    """The flagship (64 px, ngf 64, 27.9M parameters) at B=1: one step's loss
    and grad_norm, rtol 1e-4."""
    jcfg = __graft_entry__._flagship_config()
    tcfg = flagship_config()
    for cfg in (jcfg, tcfg):
        cfg.model.dropout = 0.0
        cfg.optim.warmup = 0
    jmodel = jax_get_model(jcfg)
    x0 = jnp.zeros((1, 64, 64, 5))
    jstate = jax_create_train_state(jcfg, jmodel, (x0, jnp.zeros((1,), jnp.int32), x0),
                                    jax.random.PRNGKey(0))
    params0 = perturbed(jstate.params, 51)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params0))
    X = np.random.RandomState(52).rand(1, 10, 64, 64, 1).astype(np.float32)
    key = jax.random.PRNGKey(53)
    _, jm = jax_make_train_step(jmodel, jax_make_schedule(jcfg), jcfg)(jstate, jnp.asarray(X),
                                                                        key)
    model = get_model(tcfg, device="cpu")
    load_flax_params(model, params0)
    sched = make_schedule(tcfg)
    state = create_train_state(tcfg, model, device="cpu")
    _, m = make_train_step(model, sched, tcfg)(
        state, torch.from_numpy(X), draws=jax_draws(jcfg, key, X.shape, len(sched.alphas)))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=SLICE_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=SLICE_RTOL)


def test_train_step_after_inference_mode_sampling():
    """The model's cached FIR weights, first made by an evaluation under
    `torch.inference_mode()` (as the sampler runs), serve a train step's
    autograd afterwards."""
    _, tcfg = tiny_configs()
    tcfg.model.ch_mult = [1, 2, 2]   # its own resample widths: a fresh cache entry
    model = get_model(tcfg, device="cpu")
    x = torch.randn(1, 5, 16, 16)
    with torch.inference_mode():
        model(x, torch.zeros(1, dtype=torch.long), x)
    state = create_train_state(tcfg, model, device="cpu")
    _, m = make_train_step(model, make_schedule(tcfg), tcfg)(
        state, torch.rand(1, 10, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"]))
