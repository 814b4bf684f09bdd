"""The JAX package's checkpoints in the port: a TrainState saved by
`mcvd_tpu.train.checkpoints.save_checkpoint` after one JAX train step,
exported by `tools/export_jax_checkpoint.py`, imported by
`mcvd_tpu_torch.compat.jax_ckpt`: the forward on its params and on its EMA
against JAX's, one resumed step against the JAX step from the restored
state, `--video_gen` from the imported run on the CPU, what the importer
refuses, and the committed export `tests/golden/jax_ckpt_tiny.npz` (which
`chip_smoke.py` imports on the card) against a fresh one.

The committed export is remade by `python -m tests.test_torch_port_jax_ckpt`.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.config import load_config as jax_load_config
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu.train import create_train_state as jax_create_train_state
from mcvd_tpu.train import make_train_step as jax_make_train_step
from mcvd_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
from mcvd_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from mcvd_tpu_torch.compat import jax_ckpt, torch_state_dict_from_flax
from mcvd_tpu_torch.config import load_config
from mcvd_tpu_torch.diffusion import make_schedule
from mcvd_tpu_torch.train import checkpoints, create_train_state, make_train_step
from mcvd_tpu_torch.train.state import TrainState
from tests.test_torch_port_model import FWD_TOL, nchw_to_nhwc, nhwc_to_nchw
from tests.test_torch_port_train import GRAD_REL, SLICE_RTOL, assert_close_to_max, jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "golden", "jax_ckpt_tiny.npz")
YML = os.path.join(REPO, "configs", "smmnist_DDPM_big5.yml")
# The flagship yml at the least width the card's kernels take: one level of
# 24 channels, whose middle attention is one head of D=24, no resblock on the
# way down and no time embedding (41,762 parameters), warmup off so that the
# step moves the weights and the EMA parts from them, dropout off (the
# parity tests' rule: the JAX step's dropout masks are not replayed).
FIXTURE_MODS = ["model.ngf=24", "model.ch_mult=[1]", "model.num_res_blocks=0",
                "model.attn_resolutions=[]", "model.n_head_channels=-1",
                "model.time_conditional=False", "model.num_classes=100", "data.num_frames=2",
                "data.num_frames_cond=2", "optim.warmup=0", "model.dropout=0.0"]
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def exporter():
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint", os.path.join(REPO, "tools", "export_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_jax_run(log_dir: str):
    """(config, model, state): the tiny config's JAX state after one train
    step on seeded clips (B=2), saved as `checkpoint_1` in `log_dir`."""
    config = jax_load_config(YML, FIXTURE_MODS)
    model = jax_get_model(config)
    x0 = jnp.zeros((1, 64, 64, 2))
    state = jax_create_train_state(config, model, (x0, jnp.zeros((1,), jnp.int32), x0),
                                   jax.random.PRNGKey(0))
    X = np.random.RandomState(0).rand(2, 4, 64, 64, 1).astype(np.float32)
    state, _ = jax_make_train_step(model, jax_make_schedule(config), config)(
        state, jnp.asarray(X), jax.random.PRNGKey(1))
    jax_save_checkpoint(log_dir, state, name="checkpoint_1")
    return config, model, state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX run, its export and the port run imported from it (with the
    config the export names)."""
    tmp = tmp_path_factory.mktemp("jax_run")
    config, model, state = make_jax_run(str(tmp / "logs"))
    out = str(tmp / "export.npz")
    exporter().export_checkpoint(config, str(tmp / "logs"), out, "checkpoint_1")
    port_logs = str(tmp / "port" / "logs")
    assert jax_ckpt.import_checkpoint(out, port_logs) == 1
    return dict(config=config, model=model, state=state, export=out, port_logs=port_logs,
                tmp=tmp)


def test_export_matches_the_committed_fixture(run):
    """A fresh export of the same run holds the committed fixture's leaves,
    names and config: the same paths, shapes and step; values within fp32
    rounding of the JAX step (a CPU backend's sums may order differently
    on another machine)."""
    with np.load(run["export"]) as fresh, np.load(FIXTURE) as fixed:
        assert sorted(fresh.files) == sorted(fixed.files)
        for k in fresh.files:
            a, b = fresh[k], fixed[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype.kind in "US" or a.ndim == 0 and a.dtype.kind in "iu":
                assert a == b, k
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=k)
    assert os.path.getsize(FIXTURE) < 1_000_000


def test_export_holds_every_leaf_of_the_restored_state(run):
    restored = jax_load_checkpoint(str(run["tmp"] / "logs"), name="checkpoint_1")
    with np.load(run["export"]) as z:
        n_leaves = len(jax.tree_util.tree_leaves(restored))
        assert len(z.files) == n_leaves + 2   # + __config__, __source__
        assert int(z["step"]) == 1 and int(z["opt_state/1/0/count"]) == 1
        assert int(z["opt_state/1/1/count"]) == 1


@pytest.mark.parametrize("which", ["params", "ema_params"])
def test_imported_forward_matches_jax(run, which):
    """The port checkpoint's params and EMA, in the port's model, give JAX's
    forward on the JAX state's params and EMA (which differ after the
    step)."""
    config, jstate = run["config"], run["state"]
    port_config = load_config(os.path.join(run["port_logs"], "config.yml"))
    saved = checkpoints.load_checkpoint(run["port_logs"], name="checkpoint_1")
    from mcvd_tpu_torch.models import get_model

    model = get_model(port_config, device="cpu").eval()
    missing, unexpected = model.load_state_dict(getattr(saved, which), strict=False)
    assert not unexpected and set(missing) <= {n for n, _ in model.named_buffers()}
    rng = np.random.RandomState(3)
    x, cond = (rng.rand(2, 64, 64, 2).astype(np.float32) for _ in range(2))
    y = np.array([5, 60], np.int32)
    want = np.asarray(run["model"].apply({"params": getattr(jstate, which)}, jnp.asarray(x),
                                         jnp.asarray(y), jnp.asarray(cond)))
    with torch.no_grad():
        got = model(nhwc_to_nchw(x), torch.from_numpy(y).long(), nhwc_to_nchw(cond))
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **FWD_TOL)
    assert not np.array_equal(np.asarray(jax.tree_util.tree_leaves(jstate.params)[0]),
                              np.asarray(jax.tree_util.tree_leaves(jstate.ema_params)[0]))


def test_resumed_step_matches_jax(run):
    """One more step from the restored state, the JAX draws replayed: loss
    and grad_norm within rtol 1e-4; Adam's moments (the imported ones carried
    forward), the parameters and the EMA as `test_torch_port_train.py` holds
    a step; the count goes 1 -> 2."""
    config, jmodel = run["config"], run["model"]
    jstate = jax_load_checkpoint(str(run["tmp"] / "logs"), name="checkpoint_1",
                                 target=run["state"])
    X = np.random.RandomState(4).rand(2, 4, 64, 64, 1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jstate2, jm = jax_make_train_step(jmodel, jax_make_schedule(config), config)(
        jstate, jnp.asarray(X), key)
    port_config = load_config(os.path.join(run["port_logs"], "config.yml"))
    from mcvd_tpu_torch.models import get_model

    model = get_model(port_config, device="cpu")
    state = checkpoints.load_checkpoint(run["port_logs"], name="checkpoint_1",
                                        target=create_train_state(port_config, model,
                                                                  device="cpu"))
    assert state.step == 1 and state.opt_state["count"] == 1
    sched = make_schedule(port_config)
    draws = jax_draws(config, key, X.shape, len(sched.alphas))
    state, m = make_train_step(model, sched, port_config)(state, torch.from_numpy(X),
                                                          draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=SLICE_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=SLICE_RTOL)
    assert state.step == 2 and state.opt_state["count"] == 2

    def tree(t):
        return torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, dict(t)))

    adam = jstate2.opt_state[1][0]
    mu, nu = tree(adam.mu), tree(adam.nu)
    jparams, jema = tree(jstate2.params), tree(jstate2.ema_params)
    lr = port_config.optim.lr
    floor = 1e-6 * max(float(t.abs().max()) for t in mu.values()) / 0.1
    for n in state.params:
        assert_close_to_max(state.opt_state["mu"][n], mu[n], GRAD_REL, 0.1 * floor, f"mu {n}")
        assert_close_to_max(state.opt_state["nu"][n], nu[n], 2 * GRAD_REL, 1e-3 * floor ** 2,
                            f"nu {n}")
        small = mu[n].abs() < 1e-2 * float(mu[n].abs().max())
        atol = torch.where(small, 2 * lr, 0.1 * lr)
        assert bool(((state.params[n].detach() - jparams[n]).abs() <= atol).all()), n
        assert bool(((state.ema_params[n] - jema[n]).abs() <= 1e-3 * atol + 1e-6).all()), n


def test_video_gen_runs_from_the_imported_run(run, tmp_path):
    """The importer's entry point in a subprocess (the export's own config),
    then `--video_gen --ckpt 1` on the CPU from that log directory."""
    exp = tmp_path / "exp"
    env = dict(os.environ, OMP_NUM_THREADS=str(TORCH_THREADS))
    r = subprocess.run([sys.executable, "-m", "mcvd_tpu_torch.compat.jax_ckpt", run["export"],
                        str(exp / "logs")], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = ["data.num_digits=1", "data.test_subset=4", "sampling.subsample=2",
            "sampling.num_frames_pred=2", "sampling.batch_size=2", "sampling.max_data_iter=1",
            "sampling.fvd=False"]
    r = subprocess.run([sys.executable, "-m", "mcvd_tpu_torch.main", "--config",
                        str(exp / "logs" / "config.yml"), "--exp", str(exp), "--ni",
                        "--device", "cpu", "--video_gen", "--ckpt", "1", "--config_mod", *mods],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    vid = (exp / "video_samples" / "videos" / "vid_metrics.yml").read_text()
    assert "ssim" in vid and "nan" not in vid.lower()


def test_importer_refuses_a_leaf_it_cannot_place(run, tmp_path):
    """An export leaf with no place in a port checkpoint raises and names
    the leaf: an optax field the port does not keep, a param path the
    bridge cannot map, a stray top-level entry; and moments that are not
    the config's optimizer's."""
    with np.load(run["export"]) as z:
        flat = {k: z[k] for k in z.files}
    mu0 = next(k for k in flat if k.startswith("opt_state/1/0/mu/"))
    cases = {
        "opt_state/1/0/zeta/x": flat[mu0],
        "params/unet/all_modules_0/bogus": flat["step"],
        "extra": flat["step"],
    }
    for key, leaf in cases.items():
        bad = str(tmp_path / "bad.npz")
        np.savez(bad, **flat, **{key: leaf})
        with pytest.raises(KeyError, match=key.split("/")[-1] if "bogus" in key else key):
            jax_ckpt.import_checkpoint(bad, str(tmp_path / "logs"))
    config = load_config(os.path.join(run["port_logs"], "config.yml"))
    config.optim.optimizer = "SGD"
    with pytest.raises(KeyError, match="moments"):
        jax_ckpt.train_state_from_export(run["export"], config)


def test_checkpoint_loads_the_export_bit_equal(run):
    """The port checkpoint's params and EMA are the export's arrays in the
    port layout, bit for bit."""
    parts, _ = jax_ckpt.read_export(run["export"])
    saved = checkpoints.load_checkpoint(run["port_logs"], name="checkpoint_1")
    assert isinstance(saved, TrainState)
    for which in ("params", "ema_params"):
        want = torch_state_dict_from_flax(parts[which])
        got = getattr(saved, which)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k].contiguous(), want[k]), k


if __name__ == "__main__":   # remake the committed export
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        logs = os.path.join(tmp, "logs")
        cfg, _, _ = make_jax_run(logs)
        flat = exporter().export_checkpoint(cfg, logs, FIXTURE, "checkpoint_1")
    print(f"wrote {FIXTURE}: {len(flat)} arrays, {os.path.getsize(FIXTURE)} bytes")
