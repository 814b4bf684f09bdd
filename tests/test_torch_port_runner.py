"""The port's checkpoints, metric harness and runner, held to the JAX
package on the same inputs where it has a counterpart: checkpoint resume
against an uninterrupted run (and the JAX naming policy), `run_video_gen`
against the JAX harness with the same stub block sampler, FVD and LPIPS in
the harness against the JAX package's networks, `Runner.train` and resume on
the CPU (meters and metric keys against the JAX package's), what the runner
refuses, and the video grid. The evaluation modes and the command line are
in `test_torch_port_runner_{eval,fid,cli}.py`, which share this file's
configs and its `trained` fixture (a tiny run with checkpoints at 2 and 4):
each file runs on its own worker under `--dist loadfile`."""

import argparse
import math
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.eval.i3d import make_jax_i3d_embedder
from mcvd_tpu.eval.lpips import make_lpips_fn as jax_make_lpips_fn
from mcvd_tpu.eval.video_gen import run_video_gen as jax_run_video_gen
from mcvd_tpu.runners import meters as jax_meters
from mcvd_tpu.train.checkpoints import latest_numbered_step as jax_latest_numbered_step
from mcvd_tpu_torch.compat import yaml_subset
from mcvd_tpu_torch.config import dict2namespace, flagship_config
from mcvd_tpu_torch.diffusion import make_schedule
from mcvd_tpu_torch.eval import standins
from mcvd_tpu_torch.eval.i3d import make_i3d_embedder
from mcvd_tpu_torch.eval.lpips import make_lpips_fn
from mcvd_tpu_torch.eval.video_gen import run_video_gen
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.runners import meters
from mcvd_tpu_torch.runners.runner import Runner
from mcvd_tpu_torch.train import checkpoints, create_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# torch threads a test process of these files uses (and its CLI subprocesses,
# through OMP_NUM_THREADS): the suite runs six workers on the host's cores,
# and torch's default of one thread a core in each had them contend.
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ checkpoints

def tiny_train_config():
    config = flagship_config(tiny=True)
    config.model.dropout = 0.0
    config.optim.warmup = 2
    return config


def step_draws(config, sched, B, k):
    """Step k's explicit draws (noise levels and noise), from numpy."""
    rng = np.random.RandomState(100 + k)
    d, sz = config.data, config.data.image_size
    return {"labels": torch.from_numpy(rng.randint(0, len(sched.alphas), B)),
            "z": torch.from_numpy(rng.randn(B, d.channels * d.num_frames, sz, sz)
                                  .astype(np.float32)).contiguous(
                memory_format=torch.channels_last)}


def batch(config, B, k):
    d = config.data
    rng = np.random.RandomState(200 + k)
    return torch.from_numpy(rng.rand(B, d.num_frames_cond + d.num_frames, d.image_size,
                                     d.image_size, d.channels).astype(np.float32))


def run_steps(config, sched, model, state, k0, k1):
    step = make_train_step(model, sched, config)
    for k in range(k0, k1):
        state, _ = step(state, batch(config, 4, k), draws=step_draws(config, sched, 4, k))
    return state


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    """k = 2 steps, save, load into a fresh state of a model with other
    weights, one more step: the parameters, EMA and Adam moments equal
    those of 3 uninterrupted steps (rtol 1e-6; the same fp32 ops in the same
    order, so in fact the same bits). The loaded values land in the model's
    own parameters, not in a new dict."""
    config = tiny_train_config()
    sched = make_schedule(config)
    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cpu")
    whole = run_steps(config, sched, model, create_train_state(config, model, device="cpu"),
                      0, 3)
    want = {k: {n: t.detach().clone() for n, t in d.items()} for k, d in
            (("params", whole.params), ("ema", whole.ema_params),
             ("mu", whole.opt_state["mu"]), ("nu", whole.opt_state["nu"]))}

    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cpu")
    part = run_steps(config, sched, model, create_train_state(config, model, device="cpu"),
                     0, 2)
    checkpoints.save_checkpoint(str(tmp_path), part)
    checkpoints.save_checkpoint(str(tmp_path), part, name=f"checkpoint_{part.step}")

    fresh = get_model(config, generator=torch.Generator().manual_seed(9), device="cpu")
    state = create_train_state(config, fresh, device="cpu")
    ids = {n: id(p) for n, p in fresh.named_parameters()}
    state = checkpoints.load_checkpoint(str(tmp_path), target=state)
    assert state.step == 2 and state.opt_state["count"] == 2
    for n, p in fresh.named_parameters():
        assert id(state.params[n]) == ids[n]   # the model's own tensors...
        assert torch.equal(p, part.params[n])   # ...hold the loaded values
    state = run_steps(config, sched, fresh, state, 2, 3)
    assert state.step == 3
    got = {"params": state.params, "ema": state.ema_params, "mu": state.opt_state["mu"],
           "nu": state.opt_state["nu"]}
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(got[k][n].detach().numpy(), want[k][n].numpy(),
                                       rtol=1e-6, atol=0, err_msg=f"{k} {n}")

    # the naming policy: what the JAX package's latest_numbered_step parses
    checkpoints.save_checkpoint(str(tmp_path), part, name="checkpoint_10")
    names = sorted(os.listdir(tmp_path))
    assert names == ["checkpoint", "checkpoint_10", "checkpoint_2"], names
    assert checkpoints.latest_numbered_step(str(tmp_path)) == 10
    assert jax_latest_numbered_step(str(tmp_path)) == 10
    plain = checkpoints.load_checkpoint(str(tmp_path), name="checkpoint_2")
    assert plain.step == 2 and plain.params.keys() == part.params.keys()


def test_checkpoint_refuses_another_model(tmp_path):
    config = tiny_train_config()
    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cpu")
    checkpoints.save_checkpoint(str(tmp_path), create_train_state(config, model, device="cpu"))
    config.model.ngf = 8
    other = get_model(config, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        checkpoints.load_checkpoint(str(tmp_path),
                                    target=create_train_state(config, other, device="cpu"))
    with pytest.raises(FileNotFoundError):
        checkpoints.load_checkpoint(str(tmp_path), name="checkpoint_99")


# ------------------------------------------------------------ run_video_gen

def harness_config(kind):
    """pred: 5 cond frames, SMMNIST; interp: 2 future frames, future masked
    with p 0.5 (passes 1 and 2), 3 channels; gen: cond masked with p 0.5
    (passes 1 and 3)."""
    data = {"channels": 1, "image_size": 16, "num_frames": 2, "num_frames_cond": 2,
            "num_frames_future": 0, "rescaled": True, "logit_transform": False,
            "prob_mask_cond": 0.0, "prob_mask_future": 0.0, "prob_mask_sync": False,
            "dataset": "StochasticMovingMNIST"}
    if kind == "interp":
        data.update(num_frames_future=2, prob_mask_future=0.5, channels=3, dataset="BAIR")
    if kind == "gen":
        data.update(prob_mask_cond=0.5)
    d = {"data": data, "model": {"version": "DDPM", "gamma": False},
         "sampling": {"num_frames_pred": 5, "ssim": True, "fvd": True, "max_data_iter": 2,
                      "one_frame_at_a_time": False, "init_prev_t": -1}}
    return d


def stub_np(cond, F, C):
    """A deterministic 'block sampler': a fixed function of cond, in model
    space, (B, H, W, F*C), on a grid of 2^-10, where (x + 1) / 2 and the
    x * 0.5 + 0.5 that XLA may make of it round alike."""
    base = np.tanh(0.9 * cond.mean(axis=-1, keepdims=True) + 0.1)
    out = base + 0.05 * np.arange(F * C, dtype=np.float32) - 0.1
    return (np.round(out * 1024) / 1024).astype(np.float32)


def stub_embed(video):
    """A fixed 'I3D': per-video features from frame means, (B, 3) (the
    smallest FVD set here has 4 videos: a full-rank covariance)."""
    v = np.asarray(video, np.float64)
    m = v.mean(axis=(2, 3, 4))
    return np.stack([m.mean(1), m.std(1), (v ** 2).mean(axis=(1, 2, 3, 4))], -1)


def stub_lpips(real, pred):
    return list(np.abs(np.asarray(real, np.float64) - pred).mean(axis=(1, 2, 3, 4)))


@pytest.mark.parametrize("preds_per_test", [1, 2])
@pytest.mark.parametrize("kind", ["pred", "interp", "gen"])
def test_run_video_gen_matches_jax(kind, preds_per_test):
    """The port's harness and the JAX package's, each with the same stub
    block sampler, I3D and LPIPS stand-ins, on the same clips: the same
    metric dict (keys; values within 1e-6 relative: the metrics are the same
    float64 numpy code on the same fp32 frames)."""
    d = harness_config(kind)
    F, C = d["data"]["num_frames"], d["data"]["channels"]
    T = (d["data"]["num_frames_cond"] + d["data"]["num_frames_future"]
         + d["sampling"]["num_frames_pred"] + d["data"]["num_frames_cond"])
    rng = np.random.RandomState(3)
    clips = rng.rand(2 * 4, T, 16, 16, C).astype(np.float32)
    clips = np.repeat(clips[:4], preds_per_test, axis=0) if preds_per_test > 1 else clips
    batches = [clips[i:i + 4] for i in range(0, len(clips), 4)]

    def jax_block(params, key, init, cond, cond_mask):
        return jnp.asarray(stub_np(np.asarray(cond), F, C))

    def port_block(params, init, cond, cond_mask=None, **kw):
        return torch.from_numpy(stub_np(cond.numpy(), F, C))

    want = jax_run_video_gen(jax_dict2namespace(d), None, {}, None, iter(batches),
                             jax.random.PRNGKey(0), ckpt=7, preds_per_test=preds_per_test,
                             lpips_fn=stub_lpips, i3d_embedder=stub_embed,
                             block_sampler=jax_block)
    got = run_video_gen(dict2namespace(d), None, {"w": torch.zeros(1)}, None, iter(batches),
                        torch.Generator().manual_seed(0), ckpt=7,
                        preds_per_test=preds_per_test, lpips_fn=stub_lpips,
                        i3d_embedder=stub_embed, block_sampler=port_block)
    assert sorted(got) == sorted(want)
    assert {"mse", "psnr", "ssim", "lpips"} <= set(got)
    assert ("mse2" in got) == ("fvd2" in got) == (kind == "interp")
    assert ("fvd" in got) == (kind != "gen") and ("fvd3" in got) == (kind == "gen")
    for k in want:
        if math.isnan(want[k]):
            # pass 3's first block sees all-zero cond, so the stub makes the
            # same video for every clip: a zero covariance, whose FVD scipy
            # may give as nan, in both
            assert k.startswith("fvd3") and math.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("kind", ["pred", "gen"])
def test_run_video_gen_fvd_and_lpips_match_jax(tmp_path, kind):
    """The harness with the metric networks of both packages from the same
    files (a simple 3d embedder TorchScript with 4 features, and the AlexNet
    and lin heads) instead of stand-in callables: the same FVD (passes 1 or
    3) and LPIPS (rtol 1e-4: the networks sum in other orders), the rest as
    before."""
    d = harness_config(kind)
    d["data"]["image_size"] = 32
    F, C = d["data"]["num_frames"], d["data"]["channels"]
    T = d["data"]["num_frames_cond"] + d["sampling"]["num_frames_pred"] + \
        d["data"]["num_frames_cond"]
    clips = np.random.RandomState(20).rand(8, T, 32, 32, C).astype(np.float32)
    batches = [clips[:4], clips[4:]]
    i3d_path = str(tmp_path / "i3d.pt")
    standins.save_state_dict(standins.simple_state_dict(21, 3, feat_dim=4), i3d_path)
    alex = standins.save_state_dict(standins.alexnet_features_state_dict(22),
                                    str(tmp_path / "alexnet.pth"))
    lin = standins.save_state_dict(standins.lpips_lin_state_dict(23),
                                   str(tmp_path / "lin.pth"))

    def jax_block(params, key, init, cond, cond_mask):
        return jnp.asarray(stub_np(np.asarray(cond), F, C))

    def port_block(params, init, cond, cond_mask=None, **kw):
        return torch.from_numpy(stub_np(cond.numpy(), F, C))

    want = jax_run_video_gen(jax_dict2namespace(d), None, {}, None, iter(batches),
                             jax.random.PRNGKey(0), ckpt=1,
                             lpips_fn=jax_make_lpips_fn(lin, alex),
                             i3d_embedder=make_jax_i3d_embedder(i3d_path, batch_size=4),
                             block_sampler=jax_block)
    got = run_video_gen(dict2namespace(d), None, {"w": torch.zeros(1)}, None, iter(batches),
                        torch.Generator().manual_seed(0), ckpt=1,
                        lpips_fn=make_lpips_fn(lin, alex, device="cpu"),
                        i3d_embedder=make_i3d_embedder(i3d_path, device="cpu"),
                        block_sampler=port_block)
    fvd = "fvd" if kind == "pred" else "fvd3"
    assert sorted(got) == sorted(want) and fvd in got
    assert got["lpips"] > 0 and math.isfinite(got[fvd])
    for k in want:
        rtol = 1e-4 if k.startswith(("fvd", "lpips")) else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-12, err_msg=k)


# ------------------------------------------------------------ Runner.train

def runner_config(n_iters):
    """tests/test_runner_train.py's tiny config (64 px, ngf 8), attention at
    32 px, an in-training snapshot at step 4."""
    return dict2namespace({
        "data": {"channels": 1, "image_size": 64, "num_frames": 2, "num_frames_cond": 2,
                 "num_frames_future": 0, "logit_transform": False, "rescaled": True,
                 "prob_mask_cond": 0.0, "prob_mask_future": 0.0, "prob_mask_sync": False,
                 "dataset": "StochasticMovingMNIST", "step_length": 0.1,
                 "random_flip": False, "num_digits": 1, "num_workers": 0, "subset": 32,
                 "test_subset": 8},
        "model": {"arch": "unetmore", "version": "DDPM", "spade": False, "cond_emb": False,
                  "time_conditional": True, "dropout": 0.0, "sigma_dist": "linear",
                  "sigma_begin": 0.02, "sigma_end": 0.0001, "num_classes": 10, "ngf": 8,
                  "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [32],
                  "n_head_channels": 4, "conditional": True, "noise_in_cond": False,
                  "output_all_frames": False, "gamma": False, "ema": True, "ema_rate": 0.9},
        "training": {"L1": False, "batch_size": 8, "n_epochs": 1, "n_iters": n_iters,
                     "snapshot_freq": 4, "snapshot_sampling": True, "val_freq": 3,
                     "log_freq": 1, "checkpoint_freq": 2, "compute_dtype": "float32",
                     "wire_dtype": "float16", "steps_per_dispatch": 1},
        "sampling": {"ssim": True, "fvd": False, "subsample": 3, "num_frames_pred": 2,
                     "preds_per_test": 1, "clip_before": True, "batch_size": 8,
                     "one_frame_at_a_time": False, "init_prev_t": -1, "max_data_iter": 1},
        "optim": {"weight_decay": 0.0, "optimizer": "Adam", "lr": 1e-3, "warmup": 0,
                  "beta1": 0.9, "amsgrad": False, "eps": 1e-8, "grad_clip": 1.0},
    })


def runner_args(tmp, resume=False):
    return argparse.Namespace(data_path=os.path.join(tmp, "data"),
                              log_path=os.path.join(tmp, "logs"), seed=0,
                              resume_training=resume, device="cpu")


def test_runner_train_and_resume(tmp_path):
    """Runner.train on the CPU reaches n_iters, writes `checkpoint` and
    `checkpoint_4` with best_metrics.yml from the snapshot's video_gen, and
    resumes to a larger n_iters with the step and the meters continuing. Its
    meters and metric keys are the JAX package's."""
    args = runner_args(str(tmp_path))
    state = Runner(args, runner_config(4)).train()
    assert state.step == 4
    logs = args.log_path
    assert {"checkpoint", "checkpoint_4", "meters.pkl", "best_metrics.yml"} <= set(
        os.listdir(logs))
    best = yaml_subset.load_file(os.path.join(logs, "best_metrics.yml"))
    assert sorted(best) == ["lpips", "mse", "psnr", "ssim"]
    assert all(best[k]["step"] == 4 and math.isfinite(best[k]["value"]) for k in best)
    for p in state.params.values():
        assert bool(torch.isfinite(p).all())

    state = Runner(runner_args(str(tmp_path), resume=True), runner_config(7)).train()
    assert state.step == 7
    m = meters.load_meters(logs)
    assert sorted(m) == sorted(jax_meters.init_meters())
    assert m["losses_train"].steps == list(range(1, 8))
    assert m["losses_test"].steps == [3, 6]
    assert m["mse_meter"].steps == [4]
    loaded = checkpoints.load_checkpoint(logs)
    assert loaded.step == 7 and checkpoints.latest_numbered_step(logs) == 4

    # the snapshot's metric keys are those of the JAX harness on this config
    config = runner_config(7)
    sz, F = 64, config.data.num_frames
    clips = np.random.RandomState(0).rand(8, 4, sz, sz, 1).astype(np.float32)
    jax_vm = jax_run_video_gen(
        jax_dict2namespace(vars_of(config)), None, {}, None, iter([clips]),
        jax.random.PRNGKey(0),
        block_sampler=lambda p, k, init, cond, m: jnp.zeros((8, sz, sz, F)))
    with open(os.path.join(logs, "meters.pkl"), "rb") as f:
        assert set(pickle.load(f)["best"]) == {k for k in jax_vm if k in
                                               ("mse", "psnr", "ssim", "lpips")}


def vars_of(ns):
    return {k: vars_of(v) if isinstance(v, argparse.Namespace) else v
            for k, v in vars(ns).items()}


def test_runner_refuses_what_is_not_ported(tmp_path):
    """What still raises: sample's SMLD inpainting and interpolation
    branches on a DDPM-family config (they are the SMLD legacy path, as the
    JAX runner asserts; ported in PR 12); a metric weights file that is named but
    absent, or found but broken (a metric is never dropped in silence); and
    a runner on the card where there is none. An absent file leaves its
    metric out, and the log says why."""
    args = runner_args(str(tmp_path))
    config = runner_config(1)
    runner = Runner(args, config)
    for opt in ("inpainting", "interpolation"):
        setattr(config.sampling, opt, True)
        with pytest.raises(ValueError, match="SMLD legacy path"):
            runner.sample()
        setattr(config.sampling, opt, False)
    config.eval = dict2namespace({"i3d_weights": str(tmp_path / "absent.pt")})
    with pytest.raises(FileNotFoundError, match="not a file"):
        runner._metric_providers()
    broken = tmp_path / "broken.pt"
    broken.write_bytes(b"not a checkpoint")
    for key in ("i3d_weights", "lpips_weights"):
        config.eval = dict2namespace({key: str(broken),
                                      "lpips_alexnet_weights": str(broken)})
        with pytest.raises(pickle.UnpicklingError):
            runner._metric_providers()
    config.eval = dict2namespace({"inception_weights": str(broken)})
    config.fast_fid = eval_config().fast_fid
    with pytest.raises(pickle.UnpicklingError):
        runner.fast_fid()
    if not torch.cuda.is_available():   # the card is the default device
        args.device = "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Runner(args, config)


def test_runner_metric_providers_find_the_files(tmp_path, monkeypatch, caplog):
    """With no file anywhere both metrics are left out and the log names
    them; with the files in $MCVD_WEIGHTS_DIR both are built on the
    runner's device and compute."""
    monkeypatch.setenv("MCVD_WEIGHTS_DIR", str(tmp_path / "w"))
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr("tempfile.tempdir", None)
    (tmp_path / "tmp").mkdir()
    runner = Runner(runner_args(str(tmp_path)), runner_config(1))
    with caplog.at_level("INFO"):
        assert runner._metric_providers() == (None, None)
    left = [r.getMessage() for r in caplog.records if "metric left out" in r.getMessage()]
    assert len(left) == 2 and "FVD" in left[0] and "LPIPS" in left[1]
    standins.write_standins(str(tmp_path / "w"), seed=1)
    lpips_fn, embed = runner._metric_providers()
    rng = np.random.RandomState(24)
    assert embed(rng.rand(1, 10, 32, 32, 1).astype(np.float32)).shape == (1, 400)
    d = lpips_fn(*(rng.rand(2, 2, 32, 32, 1).astype(np.float32) for _ in range(2)))
    assert len(d) == 2 and all(math.isfinite(v) and v > 0 for v in d)


# ------------------------------------------------------------ the evaluation modes'
# config and checkpoints (test_torch_port_runner_{eval,fid}.py import them)

def eval_config():
    """runner_config with the test and fast_fid sections, checkpoints at 2
    and 4, no in-training video_gen."""
    config = runner_config(4)
    config.training.snapshot_freq = 2
    config.training.snapshot_sampling = False
    config.sampling.num_samples4fid = 10
    config.test = dict2namespace({"batch_size": 4})
    config.fast_fid = dict2namespace({"batch_size": 4, "num_samples": 16, "pr_nn_k": 3,
                                      "ensemble": False, "num_ensembles": 5,
                                      "begin_ckpt": 0, "end_ckpt": 100})
    return config


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny run to step 4 (checkpoint_2, checkpoint_4, the rolling
    checkpoint), its config beside it, and the stand-in metric files."""
    tmp = str(tmp_path_factory.mktemp("trained"))
    Runner(runner_args(tmp), eval_config()).train()
    yaml_subset.dump_file(vars_of(eval_config()), os.path.join(tmp, "logs", "config.yml"))
    standins.write_standins(os.path.join(tmp, "w"), seed=2)
    return tmp


def eval_runner(trained, tmp_path, config=None, **kw):
    args = runner_args(trained)
    args.image_folder = str(tmp_path / "images")
    for k, v in kw.items():
        setattr(args, k, v)
    return Runner(args, config or eval_config()), args


# ------------------------------------------------------------ artifacts

def test_video_grid_matches_jax_png_and_falls_back_to_npy(tmp_path, monkeypatch):
    """The cond | real | pred grid has the JAX package's PNG pixels, written
    by the port's own encoder: with PIL hidden from the port (as on the card
    machine) it still writes the PNG and the GIF, and no .npy. (The .npy
    fallback of the name is gone: the port no longer needs PIL.)"""
    from PIL import Image

    from mcvd_tpu.runners import plots as jax_plots
    from mcvd_tpu_torch.data import codecs
    from mcvd_tpu_torch.runners import plots

    rng = np.random.RandomState(4)
    pred, real = (rng.rand(3, 4, 8, 8, 1).astype(np.float32) for _ in range(2))
    cond = rng.rand(3, 2, 8, 8, 1).astype(np.float32)
    jax_plots.save_video_grid(str(tmp_path / "jax"), pred=pred, real=real, cond=cond)
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    path = plots.save_video_grid(str(tmp_path / "port"), pred=pred, real=real, cond=cond)
    assert path.endswith(".png") and (tmp_path / "port.gif").exists()
    assert np.array_equal(np.asarray(Image.open(path)), want)
    assert np.array_equal(codecs.decode_image((tmp_path / "port.png").read_bytes()), want)

    monkeypatch.setitem(sys.modules, "PIL", None)   # import PIL now fails
    path = plots.save_video_grid(str(tmp_path / "nopil"), pred=pred, real=real, cond=cond)
    assert path.endswith(".png") and not list(tmp_path.glob("*.npy"))
    assert np.array_equal(codecs.decode_image(open(path, "rb").read()), want)
