"""The command line's evaluation modes (--test, --sample, --fast_fid) in
processes where jax, flax, yaml and the JAX package cannot be imported
(`run_cli` of `test_torch_port_runner_cli.py`)."""

import math

import numpy as np

from mcvd_tpu_torch.compat import yaml_subset
from mcvd_tpu_torch.eval import standins
from tests.test_torch_port_runner_cli import run_cli, torch_threads  # noqa: F401


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
