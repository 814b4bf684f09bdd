"""`python -m mcvd_tpu_torch.main` in processes where jax, flax, yaml and
the JAX package cannot be imported: --train then --video_gen, and what the
CLI refuses. The evaluation modes are in `test_torch_port_runner_cli_eval.py`
(each file runs on its own worker under `--dist loadfile`)."""

import math
import os
import subprocess
import sys

from mcvd_tpu_torch.compat import yaml_subset
from tests.test_torch_port_runner import TORCH_THREADS, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    env = dict(os.environ, PYTHONPATH=f"{fake}{os.pathsep}{REPO}",
               OMP_NUM_THREADS=str(TORCH_THREADS))
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


def test_cli_refuses_the_modes_not_ported(tmp_path):
    """The CLI runs every mode now; what it refuses ends the run with exit
    code 1 and the reason in the log: sample's inpainting on a DDPM-family
    config (the SMLD legacy path, ported in PR 12) and a metric weights file
    that is found but does not load."""
    from mcvd_tpu_torch import main as cli

    broken = tmp_path / "broken.pt"
    broken.write_bytes(b"not a checkpoint")
    for flag, mod, why in (("--sample", "sampling.inpainting=true", "SMLD legacy path"),
                           ("--fast_fid", f"eval.inception_weights={broken}",
                            "UnpicklingError")):
        exp = tmp_path / flag.strip("-")
        assert cli.main(["--config", os.path.join(REPO, "configs", "smmnist_DDPM_big5.yml"),
                         "--exp", str(exp), flag, "--device", "cpu", "--config_mod",
                         *CLI_MODS, mod]) == 1
        assert why in (exp / "logs" / "stdout.txt").read_text()
