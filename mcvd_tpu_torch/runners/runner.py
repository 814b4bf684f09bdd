"""Training and evaluation orchestration (counterpart of
`mcvd_tpu/runners/runner.py`; upstream NCSNRunner, runners/ncsn_runner.py).

Modes ported: `train` (the loop, validation loss, rolling and numbered
checkpoints, meters and plots, in-training video_gen at each snapshot) and
`video_gen` (the three-pass metric harness from a checkpoint). `sample`,
`test` and `fast_fid` wait for ROADMAP Queue 1 item 11.

One process on one device: the card unless `args.device` is "cpu". The
score network's GroupNorm and attention run through the port's kernels on
the card. The loop syncs with the device only where the host needs a value:
at the `log_freq` crossings (loss and grad norm), the `val_freq` crossings
(validation loss), checkpoints and snapshots; a batch is assembled on a
producer thread and copied to the card while the previous step runs
(`data.prefetch_to_device`).

Not carried over from the JAX runner, and why:
  * `ops.set_use_pallas(False)`: the port runs its kernels in training too;
  * `training.steps_per_dispatch` (`make_train_chunk`), `max_steps_per_run`,
    `wire_dtype` and `data.num_workers`: TPU host-link and dispatch
    workarounds; the keys are accepted and ignored (ROADMAP "Don't port");
  * the stall watchdog (`training.stall_timeout`) and the profiler hook
    (`training.profile_at_step`), both built around the TPU backend; the
    port's profiles come from `tools/profile_eval`;
  * multi-process training and `chunk_block`, the TPU per-call batch cap.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..compat import yaml_subset
from ..config import getattr_nested
from ..data import DataLoader, get_dataset, prefetch_to_device
from ..device import DEFAULT_DEVICE, resolve_device
from ..diffusion import make_schedule
from ..eval.video_gen import make_block_sampler, run_video_gen
from ..models import get_model
from ..train import checkpoints, create_train_state, make_eval_loss_step, make_train_step
from . import meters as meters_mod
from . import plots

logger = logging.getLogger(__name__)


def _crossed(freq, lo, hi):
    return freq > 0 and (lo // freq) != (hi // freq)


class _Repeated:
    """Each video of `ds` repeated r times (upstream my_collate,
    ncsn_runner.py:1392-1414)."""

    def __init__(self, ds, r):
        self.ds, self.r = ds, r

    def __len__(self):
        return len(self.ds) * self.r

    def __getitem__(self, i):
        return self.ds[i // self.r]

    def set_epoch(self, e):
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(e)


class Runner:
    def __init__(self, args, config):
        self.args = args
        self.config = config
        os.makedirs(args.log_path, exist_ok=True)
        self.device = resolve_device(getattr(args, "device", DEFAULT_DEVICE), "Runner")
        self.seed = getattr(args, "seed", 0)
        self.sched = make_schedule(config)
        self.model = get_model(config, generator=torch.Generator().manual_seed(self.seed),
                               device=self.device)
        self._block = None

    # ------------------------------------------------------------------ utils

    def _init_state(self):
        """A train state on the model's own parameters (the weights drawn at
        construction, or the last loaded)."""
        return create_train_state(self.config, self.model, device=self.device)

    def _ckpt_dir(self) -> str:
        return self.args.log_path

    def _agreed_ckpt_steps(self, ckpt_dir: str):
        """The numbered checkpoints' steps, sorted (one process: no peers to
        agree with)."""
        return checkpoints.numbered_steps(ckpt_dir)

    def _eval_batch_size(self, bs, n_avail, what: str) -> int:
        """An eval batch clamped to the split: drop_last with an oversize
        batch would yield no batch."""
        out = min(int(bs), int(n_avail))
        if out <= 0:
            raise ValueError(f"{what}: batch_size={bs} with only {n_avail} available samples")
        return out

    def _test_loader_repeated(self, test_ds, preds_per_test, batch_size):
        """Each video repeated preds_per_test times, in order."""
        batch_size = self._eval_batch_size(batch_size, len(test_ds) * preds_per_test,
                                           "video_gen loader")
        return DataLoader(_Repeated(test_ds, preds_per_test), batch_size=batch_size,
                          shuffle=False, drop_last=True)

    # ------------------------------------------------------------------ train

    def train(self):
        args, config = self.args, self.config
        train_ds, test_ds = get_dataset(args.data_path, config,
                                        video_frames_pred=config.data.num_frames)
        # the in-training video_gen takes longer clips (upstream rebuilds the
        # dataset with video_frames_pred=sampling.num_frames_pred, :1411)
        _, eval_test_ds = get_dataset(
            args.data_path, config,
            video_frames_pred=getattr(config.sampling, "num_frames_pred",
                                      config.data.num_frames))
        bs = config.training.batch_size
        loader = DataLoader(train_ds, batch_size=bs, shuffle=True, seed=self.seed,
                            drop_last=True, repeat=True)
        bs_val = self._eval_batch_size(bs, len(test_ds), "val loader")
        test_iter = iter(DataLoader(test_ds, batch_size=bs_val, shuffle=True,
                                    seed=self.seed + 1, drop_last=True, repeat=True))

        state = self._init_state()
        meters = None
        if getattr(args, "resume_training", False):
            state = checkpoints.load_checkpoint(self._ckpt_dir(), target=state)
            meters = meters_mod.load_meters(args.log_path)
            logger.info("resumed from step %d", state.step)
        meters = meters or meters_mod.init_meters()
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        step_fn = make_train_step(self.model, self.sched, config)
        eval_fn = make_eval_loss_step(self.model, self.sched, config)

        n_iters = config.training.n_iters
        snapshot_freq = getattr(config.training, "snapshot_freq", 50000)
        val_freq = getattr(config.training, "val_freq", 100)
        log_freq = getattr(config.training, "log_freq", 50)
        ckpt_freq = getattr(config.training, "checkpoint_freq", 1000)
        step = seg_start = state.step
        t_start = t_mark = time.time()   # t_mark: start of the steps the next log times
        mark_step = step
        data_iter = prefetch_to_device(iter(loader), self.device)
        try:
            while step < n_iters:
                X, _ = next(data_iter)
                state, metrics = step_fn(state, X, generator=gen)
                prev_step, step = step, step + 1
                busy = False   # whether the host ran more than the step after it

                if _crossed(log_freq, prev_step, step) or prev_step == 0:
                    loss = float(metrics["loss"])
                    gn = float(metrics["grad_norm"])
                    now = time.time()
                    ms_step = 1e3 * (now - t_mark) / (step - mark_step)
                    t_mark, mark_step = now, step
                    meters["losses_train"].update(loss, step)
                    meters["grad_norm"].update(gn, step)
                    warm = getattr(config.optim, "warmup", 0) or 1
                    meters["lr_meter"].update(config.optim.lr * min(step / warm, 1.0), step)
                    elapsed = now - t_start
                    meters["time_train"].update(elapsed / max(step - seg_start, 1) * 1e3, step)
                    meters["epochs"].update(step * bs / max(len(train_ds), 1), step)
                    logger.info("step %d | loss %.2f | grad %.3f | %.2f steps/s | "
                                "%.2f ms/step | elapsed %s | host mem %.2fGB", step, loss, gn,
                                (step - seg_start) / max(elapsed, 1e-9), ms_step,
                                datetime.timedelta(seconds=int(elapsed)), _host_mem_gb())
                if _crossed(val_freq, prev_step, step):
                    Xv, _ = next(test_iter)
                    val = float(eval_fn(state.ema_params, torch.from_numpy(Xv).to(self.device),
                                        generator=gen))
                    meters["losses_test"].update(val, step)
                    logger.info("step %d | test loss %.2f", step, val)
                    busy = True
                if _crossed(ckpt_freq, prev_step, step):
                    checkpoints.save_checkpoint(self._ckpt_dir(), state)
                    meters_mod.save_meters(meters, args.log_path)
                    plots.plot_graphs_process(meters, args.log_path)
                    busy = True
                if _crossed(snapshot_freq, prev_step, step):
                    snap_step = (step // snapshot_freq) * snapshot_freq
                    checkpoints.save_checkpoint(self._ckpt_dir(), state,
                                                name=f"checkpoint_{snap_step}")
                    if getattr(config.training, "snapshot_sampling", True):
                        self._snapshot_metrics(state, eval_test_ds, meters, step)
                    busy = True
                if busy:   # the next log times the steps alone
                    t_mark, mark_step = time.time(), step
        finally:
            data_iter.close()
        checkpoints.save_checkpoint(self._ckpt_dir(), state)
        meters_mod.save_meters(meters, args.log_path)
        logger.info("training done at step %d", step)
        return state

    def _snapshot_metrics(self, state, eval_test_ds, meters, step):
        """The in-training video_gen with the EMA weights, its metrics into
        the meters and best_metrics.yml. A failure is logged, not raised: the
        evaluation must not end the training (as the JAX runner)."""
        try:
            vm = self._video_gen_inner(state, eval_test_ds, train=True, ckpt=step)
            logger.info("snapshot metrics @%d: %s", step, vm)
            for task in ("", "2", "3"):
                for name in ("mse", "psnr", "ssim", "lpips", "fvd"):
                    if f"{name}{task}" in vm:
                        meters[f"{name}{task}_meter"].update(vm[f"{name}{task}"], step)
            best = meters_mod.update_best(meters, vm, step)
            logger.info("best so far: %s", best)
            yaml_subset.dump_file(best, os.path.join(self.args.log_path, "best_metrics.yml"))
        except Exception as e:  # the evaluation must not end the training
            logger.exception("in-training video_gen failed: %s", e)

    # -------------------------------------------------------------- video_gen

    def _load_eval_params(self, ckpt: Optional[int] = None):
        state = self._init_state()
        name = f"checkpoint_{ckpt}" if ckpt else "checkpoint"
        state = checkpoints.load_checkpoint(self._ckpt_dir(), name=name, target=state)
        params = state.ema_params if getattr(self.config.model, "ema", False) else state.params
        return params, state.step

    def _guarded_block_sampler(self):
        """The one block sampler of every evaluation, built once: it takes
        the weights per call, so each snapshot reuses it."""
        if self._block is None:
            self._block = make_block_sampler(self.config, self.model, self.sched)
        return self._block

    def _video_gen_inner(self, state, test_ds, train: bool, ckpt: int,
                         lpips_fn=None, i3d_embedder=None):
        config = self.config
        preds_per_test = 1 if train else getattr(config.sampling, "preds_per_test", 1)
        max_data_iter = 1 if train else getattr(config.sampling, "max_data_iter", 1)
        loader = self._test_loader_repeated(test_ds, preds_per_test,
                                            getattr(config.sampling, "batch_size", 16))
        params = state.ema_params if getattr(config.model, "ema", False) else state.params
        return run_video_gen(
            config, self.model, params, self.sched, iter(loader),
            torch.Generator(device=self.device).manual_seed(self.seed + ckpt),
            ckpt=ckpt, max_data_iter=max_data_iter, preds_per_test=preds_per_test,
            lpips_fn=lpips_fn, i3d_embedder=i3d_embedder,
            block_sampler=self._guarded_block_sampler())

    def video_gen(self, ckpt: Optional[int] = None):
        args, config = self.args, self.config
        _, test_ds = get_dataset(args.data_path, config,
                                 video_frames_pred=config.sampling.num_frames_pred,
                                 start_at=getattr(args, "start_at", 0))
        params, step = self._load_eval_params(ckpt)
        preds_per_test = getattr(config.sampling, "preds_per_test", 1)
        loader = self._test_loader_repeated(test_ds, preds_per_test,
                                            getattr(config.sampling, "batch_size", 16))
        lpips_fn, i3d_embedder = self._metric_providers()
        out_dir = getattr(args, "video_folder", args.log_path)
        os.makedirs(out_dir, exist_ok=True)
        C = config.data.channels

        def save_artifacts(real=None, pred=None, cond=None, tag=""):
            def unfold(a):
                if a is None:
                    return None
                B, H, W, TC = a.shape
                return a.reshape(B, H, W, TC // C, C).transpose(0, 3, 1, 2, 4)

            suffix = f"_{tag}" if tag else ""
            plots.save_video_grid(os.path.join(out_dir, f"videos_{ckpt or step}{suffix}"),
                                  pred=unfold(pred), real=unfold(real), cond=unfold(cond))

        t0 = time.perf_counter()
        vm = run_video_gen(
            config, self.model, params, self.sched, iter(loader),
            torch.Generator(device=self.device).manual_seed(self.seed), ckpt=ckpt or step,
            max_data_iter=getattr(config.sampling, "max_data_iter", 1),
            preds_per_test=preds_per_test, lpips_fn=lpips_fn, i3d_embedder=i3d_embedder,
            save_artifacts=save_artifacts, block_sampler=self._guarded_block_sampler())
        seconds = time.perf_counter() - t0
        yaml_subset.dump_file({k: float(v) if isinstance(v, (int, float, np.floating)) else v
                               for k, v in vm.items()},
                              os.path.join(out_dir, "vid_metrics.yml"))
        logger.info("video_gen metrics: %s", vm)
        logger.info("video_gen: %.3f s for the harness (%s)", seconds, self.device)
        return vm

    def _metric_providers(self):
        """LPIPS and FVD feature extractors: None, None. Their networks are
        not ported (ROADMAP Queue 1 item 14); a config that names their
        weights raises, so the metric does not go missing in silence."""
        for key in ("eval.i3d_weights", "eval.lpips_weights"):
            if getattr_nested(self.config, key):
                raise NotImplementedError(
                    f"{key} is set, but the port has no LPIPS or I3D network yet "
                    f"(ROADMAP Queue 1 item 14); unset it to run without the metric")
        return None, None

    # -------------------------------------------------- modes not ported yet

    def sample(self, ckpt: Optional[int] = None):
        raise NotImplementedError("sample: not ported yet (ROADMAP Queue 1 item 11)")

    def test(self, begin_ckpt=None, end_ckpt=None, freq=None):
        raise NotImplementedError("test: not ported yet (ROADMAP Queue 1 item 11)")

    def fast_fid(self):
        raise NotImplementedError("fast_fid: not ported yet (ROADMAP Queue 1 item 11)")


def _host_mem_gb() -> float:
    try:
        import psutil
    except ImportError:
        return 0.0
    return psutil.Process().memory_info().rss / 1e9
