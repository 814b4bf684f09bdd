"""The port's checkpoints, metric harness, runner and command line, held to
the JAX package on the same inputs where it has a counterpart: checkpoint
resume against an uninterrupted run (and the JAX naming policy),
`run_video_gen` against the JAX harness with the same stub block sampler,
`Runner.train` and resume on the CPU (meters and metric keys against the
JAX package's), FVD and LPIPS in the harness against the JAX package's
networks, `Runner.sample`, `test` and `fast_fid` (plain and ensemble) on
checkpoints of a tiny run, `quick_sample`, and `python -m
mcvd_tpu_torch.main` with jax, flax, yaml and the JAX package made
unimportable."""

import argparse
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.eval import fid as jax_fid
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
from mcvd_tpu_torch.train import (checkpoints, create_train_state, make_eval_loss_step,
                                  make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    branches (ROADMAP item 12); a metric weights file that is named but
    absent, or found but broken (a metric is never dropped in silence); and
    a runner on the card where there is none. An absent file leaves its
    metric out, and the log says why."""
    args = runner_args(str(tmp_path))
    config = runner_config(1)
    runner = Runner(args, config)
    for opt in ("inpainting", "interpolation"):
        setattr(config.sampling, opt, True)
        with pytest.raises(NotImplementedError, match="item 12"):
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


# ------------------------------------------------------------ the evaluation modes

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


def test_runner_sample_and_fid_dump(trained, tmp_path):
    """sample: samples_4.npz with samples, real and cond of the first test
    clips, folded (B, H, W, F*C) in [0, 1], the same on a second run; with
    sampling.fid, ceil(10 / 8) = 2 shards of 8 videos."""
    runner, args = eval_runner(trained, tmp_path)
    gen = runner.sample(ckpt=4)
    npz = np.load(tmp_path / "images" / "samples_4.npz")
    assert all(npz[k].shape == (8, 64, 64, 2) for k in ("samples", "real", "cond"))
    assert np.array_equal(npz["samples"], gen) and 0 <= gen.min() and gen.max() <= 1
    assert np.array_equal(eval_runner(trained, tmp_path)[0].sample(ckpt=4), gen)
    config = eval_config()
    config.sampling.fid = True
    assert eval_runner(trained, tmp_path, config)[0].sample(ckpt=2) == 16
    shards = sorted(f for f in os.listdir(tmp_path / "images") if f.startswith("fid_"))
    assert shards == ["fid_samples_2_00000.npz", "fid_samples_2_00001.npz"]
    assert np.load(tmp_path / "images" / shards[0])["samples"].shape == (8, 64, 64, 2)


def test_runner_test_sweeps_checkpoints(trained, tmp_path):
    """test: the mean DSM loss of each checkpoint over the test split, batch
    i drawing from a generator seeded with i (so each value is the eval
    loss step's on those draws), into test_losses.yml; test.max_batches caps
    the batches, begin/end/freq thin the sweep by checkpoint number."""
    from mcvd_tpu_torch.data import DataLoader, get_dataset

    runner, args = eval_runner(trained, tmp_path)
    res = runner.test()
    assert sorted(res) == [2, 4] and all(math.isfinite(v) for v in res.values())
    assert yaml_subset.load_file(os.path.join(args.log_path, "test_losses.yml")) == res
    config = eval_config()
    _, test_ds = get_dataset(args.data_path, config, video_frames_pred=2)
    params, _ = runner._load_eval_params(4)
    eval_fn = make_eval_loss_step(runner.model, runner.sched, config)
    losses = [float(eval_fn(params, torch.from_numpy(X),
                            generator=torch.Generator().manual_seed(i)))
              for i, (X, _) in enumerate(DataLoader(test_ds, batch_size=4, shuffle=False,
                                                    drop_last=True))]
    assert len(losses) == 2 and res[4] == float(np.mean(losses))
    config.test.max_batches = 1
    one = eval_runner(trained, tmp_path, config)[0].test(begin_ckpt=3)
    assert one == {4: losses[0]}
    assert sorted(runner.test(begin_ckpt=0, freq=4)) == [4]


@pytest.mark.parametrize("no_pr", [False, True], ids=["pr", "no_pr"])
def test_runner_fast_fid_plain_and_ensemble(trained, tmp_path, no_pr):
    """fast_fid over checkpoints 2 and 4 with the TorchScript stand-in
    Inception: fids.yml, the per-checkpoint caches (16 frames, 64 features),
    the FID math equal to the JAX package's on those features, a rerun that
    reads the caches (the same numbers) and the real features from
    --feats_dir; then the ensemble (checkpoint 4 samples with 2, tagged
    4_ens2) and --no_pr (FID only)."""
    config = eval_config()
    config.eval = dict2namespace({"inception_weights": os.path.join(trained, "w",
                                                                    "inception.pt")})
    feats_dir = str(tmp_path / "feats")
    runner, args = eval_runner(trained, tmp_path, config, feats_dir=feats_dir, no_pr=no_pr)
    res = runner.fast_fid()
    metrics = ["fid"] if no_pr else ["fid", "precision", "recall"]
    assert sorted(res) == [2, 4] and all(sorted(v) == metrics for v in res.values())
    assert yaml_subset.load_file(os.path.join(args.log_path, "fids.yml")) == res
    images = tmp_path / "images"
    feat_r = np.load(os.path.join(feats_dir, "StochasticMovingMNIST_feats.npy"))
    for s in (2, 4):
        feat_g = np.load(images / f"feats_{s}.npy")
        assert feat_g.shape == (16, 64) and np.load(images / f"samples_{s}.npy").shape == \
            (16, 64, 64, 1)
        want = jax_fid.get_fid_pr(feat_r, feat_g, k=3)
        for m in metrics:
            np.testing.assert_allclose(res[s][m], want[m], rtol=1e-6)
    os.remove(images / "samples_2.npy")   # a rerun reads only the features
    assert eval_runner(trained, tmp_path, config, feats_dir=feats_dir,
                       no_pr=no_pr)[0].fast_fid() == res
    config.fast_fid.ensemble = True
    ens = eval_runner(trained, tmp_path, config, feats_dir=feats_dir, no_pr=no_pr)[0].fast_fid()
    assert sorted(ens) == [2, 4]
    assert {f for f in os.listdir(images) if "_ens" in f} == {
        "feats_2_ens1.npy", "samples_2_ens1.npy", "feats_4_ens2.npy", "samples_4_ens2.npy"}
    # a window of one checkpoint is that checkpoint alone
    np.testing.assert_allclose(ens[2]["fid"], res[2]["fid"], rtol=1e-6)
    assert ens[4]["fid"] != res[4]["fid"]


def test_quick_sample_writes_one_block(trained, tmp_path):
    """`python -m mcvd_tpu_torch.quick_sample` on the port's checkpoint (its
    EMA, config.yml beside it): one block of B clips, the JAX script's npz
    keys; the same samples as get_sampler on load_model's params."""
    from mcvd_tpu_torch import quick_sample
    from mcvd_tpu_torch.load_model_from_ckpt import load_model

    out = str(tmp_path / "q.npz")
    ckpt = os.path.join(trained, "logs", "checkpoint_4")
    assert quick_sample.main(["--ckpt_path", ckpt, "--data_path", os.path.join(trained, "data"),
                              "--out", out, "--batch_size", "3", "--subsample", "2",
                              "--device", "cpu"]) == 0
    npz = np.load(out, allow_pickle=True)
    assert sorted(npz.files) == ["cond", "real", "samples"]
    assert all(npz[k].shape == (3, 64, 64, 2) for k in npz.files)
    assert np.isfinite(npz["samples"]).all()
    _, params, _, _ = load_model(ckpt, device="cpu")
    state = checkpoints.load_checkpoint(os.path.join(trained, "logs"), name="checkpoint_4")
    assert all(torch.equal(params[k], v) for k, v in state.ema_params.items())


# ------------------------------------------------------------ the command line

BLOCKED = ("jax", "flax", "yaml", "mcvd_tpu")
CLI_MODS = ["model.ngf=8", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
            "model.attn_resolutions=[32]", "model.n_head_channels=8", "model.num_classes=100",
            "data.num_frames=2", "data.num_frames_cond=2", "data.num_digits=1",
            "data.subset=32", "data.test_subset=8", "training.batch_size=8",
            "training.n_iters=4", "training.checkpoint_freq=2", "training.snapshot_freq=4",
            "training.val_freq=2", "training.log_freq=1", "sampling.subsample=3",
            "sampling.num_frames_pred=2", "sampling.batch_size=8", "sampling.max_data_iter=1"]


def run_cli(tmp_path, *flags, mods=()):
    """`python -m mcvd_tpu_torch.main` in a process where jax, flax, yaml
    and the JAX package raise ImportError (modules of those names come first
    on the path)."""
    fake = tmp_path / "blocked"
    for name in BLOCKED:
        (fake / name).mkdir(parents=True, exist_ok=True)
        (fake / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable in this test')\n")
    env = dict(os.environ, PYTHONPATH=f"{fake}{os.pathsep}{REPO}")
    cmd = [sys.executable, "-m", "mcvd_tpu_torch.main", "--config",
           os.path.join(REPO, "configs", "smmnist_DDPM_big5.yml"), "--exp",
           str(tmp_path / "exp"), "--data_path", str(tmp_path / "data"), "--ni",
           "--device", "cpu", *flags, "--config_mod", *CLI_MODS, *mods]
    out = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stderr


def test_cli_trains_then_evaluates_without_jax_or_yaml(tmp_path):
    """--train, then --video_gen --ckpt 4, from the shipped yml with the
    model cut to a tiny size: exit 0, the checkpoints, config and metrics
    files, finite MSE and SSIM, and the launch counts line (zeros on the
    CPU)."""
    log = run_cli(tmp_path, "--train")
    assert "training done at step 4" in log and "kernel launches:" in log
    logs = tmp_path / "exp" / "logs"
    assert {"checkpoint", "checkpoint_4", "config.yml", "args.yml",
            "best_metrics.yml"} <= set(os.listdir(logs))
    assert yaml_subset.load_file(str(logs / "config.yml"))["model"]["ngf"] == 8
    log = run_cli(tmp_path, "--video_gen", "--ckpt", "4")
    vm = yaml_subset.load_file(str(tmp_path / "exp" / "video_samples" / "videos" /
                                   "vid_metrics.yml"))
    assert vm["ckpt"] == 4.0
    assert all(math.isfinite(vm[k]) for k in ("mse", "psnr", "ssim"))
    assert "video_gen: " in log


def test_cli_evaluation_modes_without_jax_or_yaml(tmp_path):
    """--train with checkpoints at 2 and 4, then --test, --sample and
    --fast_fid (the stand-in Inception) in processes without jax, flax or
    yaml: exit 0 and their files."""
    standins.write_standins(str(tmp_path / "w"), seed=3)
    run_cli(tmp_path, "--train", mods=["training.snapshot_freq=2"])
    logs, images = tmp_path / "exp" / "logs", tmp_path / "exp" / "image_samples" / "images"
    run_cli(tmp_path, "--test", mods=["test.batch_size=4"])
    assert sorted(yaml_subset.load_file(str(logs / "test_losses.yml"))) == [2, 4]
    run_cli(tmp_path, "--sample", "--ckpt", "4")
    assert np.load(images / "samples_4.npz")["samples"].shape == (8, 64, 64, 2)
    log = run_cli(tmp_path, "--fast_fid", "--ckpt", "2", "--fid_num_samples", "16",
                  "--fid_batch_size", "4",
                  mods=[f"eval.inception_weights={tmp_path / 'w' / 'inception.pt'}"])
    fids = yaml_subset.load_file(str(logs / "fids.yml"))
    assert sorted(fids) == [2, 4] and all(math.isfinite(v["fid"]) for v in fids.values())
    assert "FID: Inception from" in log


def test_cli_refuses_the_modes_not_ported(tmp_path):
    """The CLI runs every mode now; what it refuses ends the run with exit
    code 1 and the reason in the log: sample's inpainting (ROADMAP item 12)
    and a metric weights file that is found but does not load."""
    from mcvd_tpu_torch import main as cli

    broken = tmp_path / "broken.pt"
    broken.write_bytes(b"not a checkpoint")
    for flag, mod, why in (("--sample", "sampling.inpainting=true", "item 12"),
                           ("--fast_fid", f"eval.inception_weights={broken}",
                            "UnpicklingError")):
        exp = tmp_path / flag.strip("-")
        assert cli.main(["--config", os.path.join(REPO, "configs", "smmnist_DDPM_big5.yml"),
                         "--exp", str(exp), flag, "--device", "cpu", "--config_mod",
                         *CLI_MODS, mod]) == 1
        assert why in (exp / "logs" / "stdout.txt").read_text()


# ------------------------------------------------------------ artifacts

def test_video_grid_matches_jax_png_and_falls_back_to_npy(tmp_path, monkeypatch):
    """The cond | real | pred grid has the JAX package's PNG pixels; where
    PIL is missing (as it may be on the card machine) the same uint8 grid
    goes to a .npy file."""
    from PIL import Image

    from mcvd_tpu.runners import plots as jax_plots
    from mcvd_tpu_torch.runners import plots

    rng = np.random.RandomState(4)
    pred, real = (rng.rand(3, 4, 8, 8, 1).astype(np.float32) for _ in range(2))
    cond = rng.rand(3, 2, 8, 8, 1).astype(np.float32)
    jax_plots.save_video_grid(str(tmp_path / "jax"), pred=pred, real=real, cond=cond)
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    path = plots.save_video_grid(str(tmp_path / "port"), pred=pred, real=real, cond=cond)
    assert path.endswith(".png") and (tmp_path / "port.gif").exists()
    assert np.array_equal(np.asarray(Image.open(path)), want)

    real_find_spec = plots.importlib.util.find_spec
    monkeypatch.setattr(plots.importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL" else real_find_spec(name, *a))
    path = plots.save_video_grid(str(tmp_path / "nopil"), pred=pred, real=real, cond=cond)
    assert path.endswith(".npy") and np.array_equal(np.load(path), want)
