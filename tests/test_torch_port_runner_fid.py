"""The port's `Runner.fast_fid` (plain, from its caches, the ensemble, and
--no_pr) on checkpoints of a tiny CPU run (the `trained` fixture of
`test_torch_port_runner.py`), its FID and precision/recall against the JAX
package's math on the same features."""

import os

import numpy as np
import pytest

from mcvd_tpu.eval import fid as jax_fid
from mcvd_tpu_torch.compat import yaml_subset
from mcvd_tpu_torch.config import dict2namespace
from tests.test_torch_port_runner import (eval_config, eval_runner,  # noqa: F401
                                          torch_threads, trained)


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


def test_runner_fast_fid_ensemble_without_ema_keeps_each_checkpoint(trained, tmp_path,
                                                                   monkeypatch):
    """Under model.ema=false the ensemble's members are the checkpoints' own
    parameters, which each load writes into the model: two checkpoints of
    constant weights 1.0 and 2.0 give checkpoint 2 the member [1.0] and
    checkpoint 4 the members [1.0, 2.0], as the JAX runner samples (its
    params are immutable)."""
    from mcvd_tpu_torch.runners.runner import Runner
    from mcvd_tpu_torch.train import checkpoints
    from tests.test_torch_port_runner import runner_args

    config = eval_config()
    config.model.ema = False
    config.fast_fid.ensemble = True
    config.eval = dict2namespace({"inception_weights": os.path.join(trained, "w",
                                                                    "inception.pt")})
    args = runner_args(str(tmp_path / "exp"))
    args.data_path = runner_args(trained).data_path
    args.image_folder = str(tmp_path / "images")
    args.no_pr = True
    runner = Runner(args, config)
    state = runner._init_state()
    for step, value in ((2, 1.0), (4, 2.0)):
        for p in state.params.values():
            p.data.fill_(value)
        state.step = step
        checkpoints.save_checkpoint(args.log_path, state, name=f"checkpoint_{step}")
    members = []
    d = config.data

    def generate(block, params, X, generator):
        members.append([float(p[next(iter(p))].flatten()[0]) for p in params])
        rng = np.random.RandomState(len(members))
        gen = rng.rand(X.shape[0], d.image_size, d.image_size, d.channels * d.num_frames)
        return gen.astype(np.float32), None, None

    monkeypatch.setattr(runner, "_generate", generate)
    assert sorted(runner.fast_fid()) == [2, 4]
    assert {tuple(m) for m in members} == {(1.0,), (1.0, 2.0)}
    assert members[0] == [1.0] and members[-1] == [1.0, 2.0]
