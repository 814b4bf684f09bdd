"""The port's evaluation modes on checkpoints of a tiny CPU run (the
`trained` fixture of `test_torch_port_runner.py`): `Runner.sample` and its
FID dump, `Runner.test` against the eval loss step, and `quick_sample` on a
port checkpoint."""

import math
import os

import numpy as np
import torch

from mcvd_tpu_torch.compat import yaml_subset
from mcvd_tpu_torch.train import checkpoints, make_eval_loss_step
from tests.test_torch_port_runner import (eval_config, eval_runner,  # noqa: F401
                                          torch_threads, trained)


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
