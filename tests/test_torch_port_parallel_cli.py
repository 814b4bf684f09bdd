"""`python -m mcvd_tpu_torch.main` as two ranks of a gloo group on this host
(`MCVD_DIST=1`, `--device cpu`), in processes where jax, flax, yaml and the
JAX package cannot be imported: --train (4 steps, a checkpoint and a
snapshot with its in-training video_gen and vote at 2) then --test on the
tiny flagship, and --sample with inpainting on a tiny cifar10_ncsnv2, held
to the same run in one process. Rank 0 alone writes the files; both ranks
log the same losses and metrics and exit 0."""

import json
import os
import pickle
import re
import sys

import numpy as np
import torch

from mcvd_tpu_torch.config import load_config
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.train import checkpoints, create_train_state
from tests.torch_parallel_ranks import REPO, TORCH_THREADS, spawn_ranks

BLOCKED = ("jax", "flax", "yaml", "mcvd_tpu")
FLAGSHIP = os.path.join(REPO, "configs", "smmnist_DDPM_big5.yml")
MODS = ["model.ngf=8", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
        "model.attn_resolutions=[32]", "model.n_head_channels=8", "model.num_classes=10",
        "data.num_frames=2", "data.num_frames_cond=2", "data.num_digits=1",
        "data.subset=32", "data.test_subset=8", "training.batch_size=8",
        "training.n_iters=4", "training.checkpoint_freq=2", "training.snapshot_freq=2",
        "training.val_freq=2", "training.log_freq=1", "sampling.subsample=3",
        "sampling.num_frames_pred=2", "sampling.batch_size=8", "sampling.max_data_iter=1",
        "test.batch_size=4"]
SMLD = os.path.join(REPO, "configs", "cifar10_ncsnv2.yml")
SMLD_MODS = ["model.ngf=4", "model.num_classes=10", "sampling.batch_size=4",
             "sampling.n_steps_each=2", "sampling.inpainting=true"]


def run_ranks(tmp_path, config, exp, *flags, mods=()):
    """The CLI as 2 ranks; each rank's stderr (its log)."""
    fake = tmp_path / "blocked"
    for name in BLOCKED:
        (fake / name).mkdir(parents=True, exist_ok=True)
        (fake / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable in this test')\n")
    env = dict(os.environ, PYTHONPATH=f"{fake}{os.pathsep}{REPO}")
    cmd = [sys.executable, "-m", "mcvd_tpu_torch.main", "--config", config, "--exp", str(exp),
           "--data_path", str(exp / "data"), "--ni", "--device", "cpu", *flags,
           "--config_mod", *mods]
    outs = spawn_ranks(cmd, 2, env=env, cwd=str(tmp_path))
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r} of {flags}: exit {rc}\n{err[-4000:]}"
    return [err for _, _, err in outs]


def same_on_ranks(logs, pattern):
    found = [re.findall(pattern, log) for log in logs]
    assert found[0] and found[0] == found[1], found
    return found[0]


def test_two_rank_cli_trains_then_tests(tmp_path):
    exp = tmp_path / "exp"
    logs = run_ranks(tmp_path, FLAGSHIP, exp, "--train", mods=MODS)
    assert all("training done at step 4" in log for log in logs)
    assert "backend gloo, rank 0 of 2, device cpu" in logs[0]
    assert "backend gloo, rank 1 of 2, device cpu" in logs[1]
    steps = same_on_ranks(logs, r"step (\d+) \| loss (\S+) \| grad (\S+)")
    assert [s[0] for s in steps] == ["1", "2", "3", "4"]
    same_on_ranks(logs, r"step \d+ \| test loss (\S+)")
    snaps = same_on_ranks(logs, r"snapshot metrics @(\d+): (.*)")
    assert [s[0] for s in snaps] == ["2", "4"]
    written = [re.findall(r"checkpoint written: (\S+)", log) for log in logs]
    assert [os.path.basename(p) for p in written[0]] == [
        "checkpoint", "checkpoint_2", "checkpoint", "checkpoint_4", "checkpoint"]
    assert written[1] == []
    assert ["meters and plots written" in log for log in logs] == [True, False]
    log_dir = exp / "logs"
    assert {"checkpoint", "checkpoint_2", "checkpoint_4", "meters.pkl", "best_metrics.yml",
            "config.yml", "args.yml", "stdout.txt"} <= set(os.listdir(log_dir))
    assert not [f for f in os.listdir(log_dir) if ".tmp" in f]
    text = (log_dir / "stdout.txt").read_text()
    assert "rank 0 -" in text and "rank 1 -" not in text
    assert (exp / "code" / "mcvd_tpu_torch").is_dir()

    logs = run_ranks(tmp_path, FLAGSHIP, exp, "--test", mods=MODS)
    losses = same_on_ranks(logs, r"ckpt (\d+): test DSM loss (\S+) over (\d+) batches")
    # 8 test clips, a global batch of 4 (2 a rank): 2 batches a checkpoint
    assert [(c, n) for c, _, n in losses] == [("2", "2"), ("4", "2")]
    assert all(np.isfinite(float(v)) for _, v, _ in losses)
    from mcvd_tpu_torch.compat import yaml_subset

    yml = yaml_subset.load_file(str(log_dir / "test_losses.yml"))
    assert sorted(yml) == [2, 4]
    for c, v, _ in losses:   # the log rounds to 6 decimals
        assert abs(yml[int(c)] - float(v)) <= 5e-7, (c, v, yml)


def write_cifar(root):
    rng = np.random.default_rng(3)
    root.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(root / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (8, 3072), dtype=np.uint8),
                         b"labels": [int(v) for v in rng.integers(0, 10, 8)]}, f)


def test_two_rank_inpainting_is_the_one_process_chain(tmp_path):
    """--sample with sampling.inpainting on 2 ranks: each rank runs 2 of the
    batch's 4 Langevin chains, on the draws one process makes for the
    batch; rank 0 writes what one process writes, within fp32 rounding."""
    torch.set_num_threads(TORCH_THREADS)
    config = load_config(SMLD, SMLD_MODS)
    model = get_model(config, generator=torch.Generator().manual_seed(2), device="cpu")
    state = create_train_state(config, model, device="cpu")
    state.step = 3
    outs = {}
    for name in ("one", "two"):
        exp = tmp_path / name
        write_cifar(exp / "data")
        checkpoints.save_checkpoint(str(exp / "logs"), state, name="checkpoint_3")
    from mcvd_tpu_torch import main as cli

    assert cli.main(["--config", SMLD, "--exp", str(tmp_path / "one"), "--data_path",
                     str(tmp_path / "one" / "data"), "--ni", "--device", "cpu", "--sample",
                     "--ckpt", "3", "--config_mod", *SMLD_MODS]) == 0
    logs = run_ranks(tmp_path, SMLD, tmp_path / "two", "--sample", "--ckpt", "3",
                     mods=SMLD_MODS)
    assert ["wrote {'samples'" in log for log in logs] == [True, False]
    for name in ("one", "two"):
        with np.load(tmp_path / name / "image_samples" / "images" / "inpainting_3.npz") as z:
            outs[name] = {k: z[k] for k in z.files}
    assert outs["two"]["samples"].shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(outs["two"]["refer"], outs["one"]["refer"])
    np.testing.assert_allclose(outs["two"]["samples"], outs["one"]["samples"], rtol=0,
                               atol=1e-5)


def test_ddp_check_on_two_cpu_ranks(tmp_path):
    """`tools.ddp_check`, which `chip_smoke.py` runs on the card, on two gloo
    ranks of the CPU at a tiny size: every check holds (the step and the
    block against one process, the ranks' checksums, no launch on the
    CPU), and rank 0's line says so."""
    out = tmp_path / "ddp.json"
    mods = ["model.ngf=8", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
            "model.attn_resolutions=[8]", "model.n_head_channels=8", "data.image_size=16",
            "model.num_classes=20", "data.num_frames=2", "data.num_frames_cond=2"]
    outs = spawn_ranks([sys.executable, "-m", "mcvd_tpu_torch.tools.ddp_check", "--device",
                        "cpu", "--config", FLAGSHIP, "--batch", "4", "--block_steps", "2",
                        "--out", str(out), "--config_mod", *mods], 2)
    for r, (rc, o, err) in enumerate(outs):
        assert rc == 0, f"rank {r}: exit {rc}\n{o[-2000:]}\n{err[-3000:]}"
    line = json.loads(out.read_text())
    assert line["ok"] and line["failures"] == [] and line["world"] == 2
    assert line["backend"] == "gloo" and not line["jax_imported"]
    assert len(set(line["param_checksums"])) == 1 and line["rows_per_rank"] == 2
    assert all(v <= 1.0 for k, v in line["worst"].items() if k != "loss_rel")
    assert [r["rank"] for r in line["ranks"]] == [0, 1]
    assert all(not any(r["step_launches"].values()) for r in line["ranks"])
