"""The port's legacy ncsn models against the JAX package on the same numpy
weights and inputs (`models/ncsnv2.py`): NCSNv2 / Deeper / Deepest and
NCSNv1 at sizes that take each size dispatch (28 px with adjust_padding,
32, >=96, >=256 at a tiny ngf and B=1), cond frames, the GroupNorm and
VarianceNorm options, one fp32 DSM train step (SMLD's branch) against
`mcvd_tpu.train.make_train_step`, and `build`'s dispatch against
`get_ncsn_model`'s. The helpers and tolerances are
`test_torch_port_ncsnv2.py`'s: a model within 1e-4 of its largest output;
the step's loss and grad_norm within rtol 1e-4, its gradients within 1e-3
of each tensor's largest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu.train import make_train_step as jax_make_train_step
from mcvd_tpu.train.state import TrainState as JaxTrainState
from mcvd_tpu.train.state import make_optimizer as jax_make_optimizer
from mcvd_tpu_torch.compat import load_flax_params, torch_state_dict_from_flax
from mcvd_tpu_torch.config import dict2namespace
from mcvd_tpu_torch.diffusion import make_schedule
from mcvd_tpu_torch.models import build, get_model
from mcvd_tpu_torch.train import create_train_state, loss_for_batch, make_train_step
from tests.test_torch_port_ncsnv2 import (MODEL_REL, nchw, ncsn_dict, nhwc, np_params,
                                          torch_threads)  # noqa: F401
from tests.test_torch_port_train import GRAD_REL, SLICE_RTOL, assert_close_to_max, jax_draws

MODELS = {  # id: (ncsn_dict kwargs, the port class)
    "ncsnv2_28_adjust": (dict(size=28), "NCSNv2"),
    "ncsnv2_32": (dict(size=32), "NCSNv2"),
    "ncsnv2_32_cond": (dict(size=32, num_frames_cond=1), "NCSNv2"),
    "ncsnv2_deeper_96": (dict(size=96, ngf=2), "NCSNv2Deeper"),
    "ncsnv2_deepest_256": (dict(size=256, ngf=2), "NCSNv2Deepest"),
    "ncsn_v1_32": (dict(arch="ncsn", size=32), "CondRefineNetDilated"),
    "ncsnv2_groupnorm": (dict(size=32, ngf=8, normalization="GroupNorm"), "NCSNv2"),
    "ncsnv2_variance_rescaled": (dict(size=32, normalization="VarianceNorm",
                                      rescaled=True), "NCSNv2"),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    """One evaluation (B=1) on the same numpy weights and input: the port's
    dispatch picks the class the JAX package's does, and the outputs agree
    within 1e-4 of the largest (2e-5 at 256 px: 29 residual and refine
    blocks deep)."""
    kw, cls = MODELS[name]
    d = ncsn_dict(**kw)
    jcfg, tcfg = jax_dict2namespace(d), dict2namespace(d)
    jmodel = jax_get_model(jcfg)
    assert type(jmodel).__name__ == cls
    sz, fc = d["data"]["image_size"], d["data"]["num_frames_cond"]
    rng = np.random.RandomState(len(name))
    x = rng.rand(1, sz, sz, 3).astype(np.float32)
    cond = rng.rand(1, sz, sz, 3 * fc).astype(np.float32) if fc else None
    y = np.array([2], np.int32)
    jargs = (jnp.asarray(x), jnp.asarray(y)) + ((jnp.asarray(cond),) if fc else ())
    params = np_params(jmodel, 11, *jargs)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, *jargs))
    model = get_model(tcfg, device="cpu").eval()
    assert type(model).__name__ == cls
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(y).long(), None if cond is None else nchw(cond))
    assert got.shape == (1, 3, sz, sz)
    err = np.abs(nhwc(got) - want).max()
    assert err <= MODEL_REL * np.abs(want).max(), (err, np.abs(want).max())


def test_ncsnv2_train_step_matches_jax():
    """One fp32 DSM step (SMLD branch) of a tiny NCSNv2 (B=2, 32 px) from the
    same weights, the JAX step's draws replayed: loss and grad_norm within
    rtol 1e-4, the clipped gradients (Adam's first moment is 0.1 g after
    one step) within 1e-3 of each tensor's largest, as the other train-step
    tests hold theirs."""
    d = ncsn_dict(size=32)
    jcfg, tcfg = jax_dict2namespace(d), dict2namespace(d)
    jmodel = jax_get_model(jcfg)
    B, sz = 2, 32
    x0 = jnp.zeros((B, sz, sz, 3))
    params = np_params(jmodel, 13, x0, jnp.zeros((B,), jnp.int32))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(params=jp, opt_state=jax_make_optimizer(jcfg).init(jp),
                           ema_params=jax.tree_util.tree_map(jnp.copy, jp),
                           step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    X = np.random.RandomState(8).rand(B, 1, sz, sz, 3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jstate1, jm = jax_make_train_step(jmodel, jax_make_schedule(jcfg), jcfg)(
        jstate, jnp.asarray(X), key)
    model = get_model(tcfg, device="cpu")
    load_flax_params(model, params)
    sched = make_schedule(tcfg)
    state = create_train_state(tcfg, model, device="cpu")
    draws = jax_draws(jcfg, key, X.shape, len(sched.sigmas))
    loss = loss_for_batch(model, sched, tcfg, state.params, torch.from_numpy(X), train=True,
                          draws=draws)
    grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    state, m = make_train_step(model, sched, tcfg)(state, torch.from_numpy(X), draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=SLICE_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=SLICE_RTOL)
    mu = torch_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, dict(jstate1.opt_state[1][0].mu)), "ncsn")
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    floor = 1e-6 * clip * max(float(g.abs().max()) for g in grads.values())
    for n, g in grads.items():
        assert_close_to_max(g * clip, mu[n] / 0.1, GRAD_REL, floor, f"grad {n}")


def test_ncsn_build_is_the_jax_dispatch():
    """arch ncsn / ncsnv2 by size, as `mcvd_tpu.models.ncsnv2.get_ncsn_model`."""
    for arch, size in (("ncsnv2", 28), ("ncsnv2", 95), ("ncsnv2", 96), ("ncsnv2", 255),
                       ("ncsnv2", 256), ("ncsn", 256)):
        d = ncsn_dict(arch=arch, size=size)
        with torch.device("meta"):
            port = build(dict2namespace(d))
        assert type(port).__name__ == type(jax_get_model(jax_dict2namespace(d))).__name__
