"""One fp32 train step of the port's legacy UNet and 3D / pseudo-3D NCSN++
against `mcvd_tpu.train.make_train_step` from the same bridged weights with
the JAX step's draws replayed (the tiny configs of
`test_torch_port_legacy_3d.py`; dropout off). On the CPU the GroupNorm and
attention take their plain forward and backward passes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu.train import create_train_state as jax_create_train_state
from mcvd_tpu.train import make_train_step as jax_make_train_step
from mcvd_tpu_torch.compat import load_flax_params, torch_state_dict_from_flax
from mcvd_tpu_torch.config import dict2namespace
from mcvd_tpu_torch.diffusion import make_schedule
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.train import create_train_state, loss_for_batch, make_train_step
from tests.test_torch_port_legacy_3d import ARCHS, perturbed, tiny_dict, torch_threads  # noqa: F401
from tests.test_torch_port_train import (GRAD_REL, SLICE_RTOL, assert_close_to_max,
                                         jax_draws)


@pytest.mark.parametrize("arch", ["unet", "unetmore3d", "unetmorepseudo3d"])
def test_train_step_matches_jax(arch):
    """One fp32 train step (B=2, 16 px) from the same weights with the JAX
    step's draws replayed: loss and grad_norm within rtol 1e-4, the clipped
    gradients (Adam's first moment after one step is 0.1 g) within 1e-3 of
    each tensor's largest, as `test_torch_port_train.py` holds `unetmore`.
    A gradient that is zero in exact arithmetic comes out as rounding noise
    on both sides (in the legacy UNet's 32-channel resblocks, conv0's bias
    and the time embedding's projection `dense` add a constant to each
    channel of each example before a GroupNorm of 32 groups over 32
    channels, one channel a group, which takes it out); such a tensor is
    held to that noise, 1e-6 of the model's largest gradient, on both
    sides."""
    kw = dict(ARCHS[arch])
    jcfg = jax_dict2namespace(tiny_dict(**kw))
    tcfg = dict2namespace(tiny_dict(**kw))
    jmodel = jax_get_model(jcfg)
    B, sz = 2, 16
    x0 = jnp.zeros((B, sz, sz, 2))
    jstate = jax_create_train_state(jcfg, jmodel, (x0, jnp.zeros((B,), jnp.int32), x0),
                                    jax.random.PRNGKey(0))
    params = perturbed(jstate.params, 50)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            ema_params=jax.tree_util.tree_map(jnp.asarray, params))
    X = np.random.RandomState(8).rand(B, 4, sz, sz, 1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jstate1, jm = jax_make_train_step(jmodel, jax_make_schedule(jcfg), jcfg)(
        jstate, jnp.asarray(X), key)
    model = get_model(tcfg, device="cpu")
    load_flax_params(model, params)
    sched = make_schedule(tcfg)
    state = create_train_state(tcfg, model, device="cpu")
    draws = jax_draws(jcfg, key, X.shape, len(sched.alphas))
    loss = loss_for_batch(model, sched, tcfg, state.params, torch.from_numpy(X), train=True,
                          draws=draws)
    grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    state, m = make_train_step(model, sched, tcfg)(state, torch.from_numpy(X), draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=SLICE_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=SLICE_RTOL)
    mu = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           dict(jstate1.opt_state[1][0].mu)))
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    floor = 1e-6 * clip * max(float(g.abs().max()) for g in grads.values())
    for n, g in grads.items():
        want = mu[n] / 0.1
        if float(want.abs().max()) <= floor:
            assert float((g * clip).abs().max()) <= floor, f"grad {n}: not rounding noise"
            continue
        assert_close_to_max(g * clip, want, GRAD_REL, floor, f"grad {n}")
