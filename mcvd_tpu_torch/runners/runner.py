"""Training and evaluation orchestration (counterpart of
`mcvd_tpu/runners/runner.py`; upstream NCSNRunner, runners/ncsn_runner.py).

Modes: `train` (the loop, validation loss, rolling and numbered
checkpoints, meters and plots, in-training video_gen at each snapshot),
`video_gen` (the three-pass metric harness from a checkpoint, with FVD and
LPIPS where their weight files are found), `sample` (a conditional batch, or
the FID sample dump), `test` (the mean DSM loss over the test split per
checkpoint) and `fast_fid` (FID and kNN precision/recall per checkpoint,
plain or with an ensemble of checkpoints; SMLD's inpainting and
interpolation branches of `sample`). The metric networks run on the
runner's device.

One process on one device (the card unless `args.device` is "cpu"), or one
rank of a process group (`parallel.dist`, `MCVD_DIST=1`), as the JAX
runner's multi-process branches: `training.batch_size` is the global batch,
each rank reads a disjoint 1/P of the train and validation splits
(`DataLoader(num_processes, process_index)`) and the train step averages
the gradients over the ranks; rank 0 writes the checkpoints, meters, plots
and metric files while the others wait at a barrier; every evaluation runs
the same host harness on every rank over the full split, with the
sampler's chain cut into the ranks' rows (`parallel.wrap_chain`, batch
sizes a multiple of P), so every rank gets the same result; `test()`'s
ranks read shards of the test split for a common number of batches.
Filesystem decisions (the checkpoint listing, the caches) are rank 0's or
every rank's (`broadcast_from_primary`, `all_processes_true`). The score
network's GroupNorm and attention run through the port's kernels on the
card. The loop syncs with the device only where the host needs a value:
at the `log_freq` crossings (loss and grad norm), the `val_freq` crossings
(validation loss), checkpoints and snapshots; a batch is assembled on a
producer thread and copied to the card while the previous step runs
(`data.prefetch_to_device`).

Not carried over from the JAX runner, and why:
  * `ops.set_use_pallas(False)`: the port runs its kernels in training too;
  * `training.steps_per_dispatch` (`make_train_chunk`), `max_steps_per_run`
    and `wire_dtype`: TPU host-link and dispatch workarounds; the keys are
    accepted and ignored (ROADMAP "Don't port");
  * the stall watchdog (`training.stall_timeout`) and the profiler hook
    (`training.profile_at_step`), both built around the TPU backend; the
    port's profiles come from `tools/profile_eval`;
  * `chunk_block`, the TPU per-call batch cap; the `lockstep` barriers
    against XLA's compile skew; the 'tensor' mesh axis (`parallel.tensor`
    is accepted and ignored, ROADMAP item 15).
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..compat import yaml_subset
from ..config import getattr_nested
from ..data import (DataLoader, conditioning_fn, data_transform, get_dataset,
                    inverse_data_transform, prefetch_to_device)
from ..device import DEFAULT_DEVICE, resolve_device
from ..diffusion import make_schedule
from ..eval.video_gen import init_noise, make_block_sampler, run_video_gen
from ..models import get_model
from ..parallel import all_processes_true, barrier, broadcast_from_primary, clamp_batch
from ..parallel import dist as pdist
from ..parallel import wrap_chain
from ..train import (broadcast_state_, checkpoints, create_train_state, make_eval_loss_step,
                     make_train_step)
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
        self.is_main = pdist.is_main()
        self._blocks = {}

    # ------------------------------------------------------------------ utils

    def _init_state(self):
        """A train state on the model's own parameters (the weights drawn at
        construction, or the last loaded)."""
        return create_train_state(self.config, self.model, device=self.device)

    def _ckpt_dir(self) -> str:
        return self.args.log_path

    def _agreed_ckpt_steps(self, ckpt_dir: str):
        """The numbered checkpoints' steps, sorted: rank 0's listing on every
        rank, so all run the same number of collective evaluations."""
        return broadcast_from_primary(checkpoints.numbered_steps(ckpt_dir), "ckpt steps")

    def _eval_batch_size(self, bs, n_avail, what: str) -> int:
        """An eval batch clamped to the split (drop_last with an oversize
        batch would yield no batch) and to a multiple of the ranks."""
        return clamp_batch(bs, n_avail, what)

    def _save_checkpoint(self, state, name: str = "checkpoint"):
        """Rank 0 writes; every rank leaves when it is written."""
        if self.is_main:
            path = checkpoints.save_checkpoint(self._ckpt_dir(), state, name=name)
            logger.info("checkpoint written: %s", path)
        barrier(f"save {name}")

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
        bs = config.training.batch_size   # the global batch
        n_proc, proc = pdist.world(), pdist.rank()
        if bs % n_proc:
            raise ValueError(f"training.batch_size={bs} (global) must be a multiple of the "
                             f"{n_proc} ranks")
        # the items of a batch are read by this many threads (the HDF5
        # readers' decode releases the GIL), in the same order as by one
        num_workers = int(getattr(config.data, "num_workers", 0) or 0)
        # each rank reads a disjoint 1/n_proc of the split, bs/n_proc a batch
        loader = DataLoader(train_ds, batch_size=bs // n_proc, shuffle=True, seed=self.seed,
                            drop_last=True, repeat=True, num_processes=n_proc,
                            process_index=proc, num_workers=num_workers)
        bs_val = self._eval_batch_size(bs, (len(test_ds) // n_proc) * n_proc, "val loader")
        test_iter = iter(DataLoader(test_ds, batch_size=bs_val // n_proc, shuffle=True,
                                    seed=self.seed + 1, drop_last=True, repeat=True,
                                    num_processes=n_proc, process_index=proc,
                                    num_workers=num_workers))

        state = self._init_state()
        meters = None
        if getattr(args, "resume_training", False):
            state = checkpoints.load_checkpoint(self._ckpt_dir(), target=state)
            meters = meters_mod.load_meters(args.log_path)
            logger.info("resumed from step %d", state.step)
        meters = meters or meters_mod.init_meters()
        broadcast_state_(state)   # rank 0's weights and slots on every rank
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
        wait_s = 0.0   # the loop's wait on the loader over the steps the next log times
        try:
            while step < n_iters:
                t_wait = time.perf_counter()
                X, _ = next(data_iter)
                wait_s += time.perf_counter() - t_wait
                state, metrics = step_fn(state, X, generator=gen)
                prev_step, step = step, step + 1
                busy = False   # whether the host ran more than the step after it

                if _crossed(log_freq, prev_step, step) or prev_step == 0:
                    loss = float(metrics["loss"])
                    gn = float(metrics["grad_norm"])
                    now = time.time()
                    ms_step = 1e3 * (now - t_mark) / (step - mark_step)
                    ms_wait = 1e3 * wait_s / (step - mark_step)
                    t_mark, mark_step, wait_s = now, step, 0.0
                    meters["losses_train"].update(loss, step)
                    meters["grad_norm"].update(gn, step)
                    warm = getattr(config.optim, "warmup", 0) or 1
                    meters["lr_meter"].update(config.optim.lr * min(step / warm, 1.0), step)
                    elapsed = now - t_start
                    meters["time_train"].update(elapsed / max(step - seg_start, 1) * 1e3, step)
                    meters["epochs"].update(step * bs / max(len(train_ds), 1), step)
                    logger.info("step %d | loss %.2f | grad %.3f | %.2f steps/s | "
                                "%.2f ms/step | %.2f ms/step waiting on data | elapsed %s | "
                                "host mem %.2fGB", step, loss, gn,
                                (step - seg_start) / max(elapsed, 1e-9), ms_step, ms_wait,
                                datetime.timedelta(seconds=int(elapsed)), _host_mem_gb())
                if _crossed(val_freq, prev_step, step):
                    Xv, _ = next(test_iter)
                    val = float(eval_fn(state.ema_params, torch.from_numpy(Xv).to(self.device),
                                        generator=gen))
                    meters["losses_test"].update(val, step)
                    logger.info("step %d | test loss %.2f", step, val)
                    busy = True
                if _crossed(ckpt_freq, prev_step, step):
                    self._save_checkpoint(state)
                    if self.is_main:
                        meters_mod.save_meters(meters, args.log_path)
                        plots.plot_graphs_process(meters, args.log_path)
                        logger.info("meters and plots written: %s", args.log_path)
                    busy = True
                if _crossed(snapshot_freq, prev_step, step):
                    snap_step = (step // snapshot_freq) * snapshot_freq
                    self._save_checkpoint(state, name=f"checkpoint_{snap_step}")
                    if getattr(config.training, "snapshot_sampling", True):
                        self._snapshot_metrics(state, eval_test_ds, meters, step)
                    busy = True
                if busy:   # the next log times the steps alone
                    t_mark, mark_step, wait_s = time.time(), step, 0.0
        finally:
            data_iter.close()
        self._save_checkpoint(state)
        if self.is_main:
            meters_mod.save_meters(meters, args.log_path)
        logger.info("training done at step %d", step)
        return state

    def _snapshot_metrics(self, state, eval_test_ds, meters, step):
        """The in-training video_gen with the EMA weights, its metrics into
        the meters and (rank 0) best_metrics.yml. A failure is logged, not
        raised: the evaluation must not end the training (as the JAX runner).
        In a process group every rank joins the collective sampler, then the
        ranks vote: a failure on any rank raises on all of them, so they
        restart together from the checkpoint rather than pair the next
        collective with a rank that left the evaluation."""
        eval_ok = True
        try:
            vm = self._video_gen_inner(state, eval_test_ds, train=True, ckpt=step)
            logger.info("snapshot metrics @%d: %s", step, vm)
            for task in ("", "2", "3"):
                for name in ("mse", "psnr", "ssim", "lpips", "fvd"):
                    if f"{name}{task}" in vm:
                        meters[f"{name}{task}_meter"].update(vm[f"{name}{task}"], step)
            best = meters_mod.update_best(meters, vm, step)
            if self.is_main:
                logger.info("best so far: %s", best)
                yaml_subset.dump_file(best, os.path.join(self.args.log_path,
                                                         "best_metrics.yml"))
        except Exception as e:  # the evaluation must not end the training
            eval_ok = False
            logger.exception("in-training video_gen failed: %s", e)
        if pdist.world() > 1 and not all_processes_true(eval_ok):
            raise RuntimeError("in-training video_gen failed on at least one rank; every "
                               "rank stops, to restart together from the checkpoint")

    # -------------------------------------------------------------- video_gen

    def _load_eval_params(self, ckpt: Optional[int] = None):
        """(params, step) of checkpoint `ckpt` (the rolling one if None): the
        EMA where model.ema is set, else the model's own tensors, which the
        next load overwrites."""
        state = self._init_state()
        name = f"checkpoint_{ckpt}" if ckpt else "checkpoint"
        state = checkpoints.load_checkpoint(self._ckpt_dir(), name=name, target=state)
        params = state.ema_params if getattr(self.config.model, "ema", False) else state.params
        return params, state.step

    def _guarded_block_sampler(self, ensemble: bool = False):
        """The block sampler of every evaluation (one plain, one ensemble),
        each built once: it takes the weights per call, so each snapshot and
        checkpoint reuses it. With more than one rank, the collective one
        (`parallel.wrap_chain`): each rank samples its rows of the batch."""
        if ensemble not in self._blocks:
            block = make_block_sampler(self.config, self.model, self.sched, ensemble=ensemble)
            self._blocks[ensemble] = wrap_chain(block) if pdist.world() > 1 else block
        return self._blocks[ensemble]

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

        if not self.is_main:
            save_artifacts = None

        t0 = time.perf_counter()
        vm = run_video_gen(
            config, self.model, params, self.sched, iter(loader),
            torch.Generator(device=self.device).manual_seed(self.seed), ckpt=ckpt or step,
            max_data_iter=getattr(config.sampling, "max_data_iter", 1),
            preds_per_test=preds_per_test, lpips_fn=lpips_fn, i3d_embedder=i3d_embedder,
            save_artifacts=save_artifacts, block_sampler=self._guarded_block_sampler())
        seconds = time.perf_counter() - t0
        if self.is_main:
            yaml_subset.dump_file({k: float(v) if isinstance(v, (int, float, np.floating))
                                   else v for k, v in vm.items()},
                                  os.path.join(out_dir, "vid_metrics.yml"))
        logger.info("video_gen metrics: %s", vm)
        logger.info("video_gen: %.3f s for the harness (%s)", seconds, self.device)
        return vm

    def _metric_providers(self):
        """(lpips_fn, i3d_embedder) on the runner's device, each built where
        its weight files are found (`eval/weights.py`: the config's path, then
        the default directories) and None where one is absent; the log names
        each metric left out and why. A config path that is not a file, and
        a file that is found but does not load, raise: a metric is never
        dropped in silence, and never moved to the CPU."""
        from ..eval import weights as W
        from ..eval.i3d import make_i3d_embedder
        from ..eval.lpips import make_lpips_fn

        def find(key, filename):
            return W.find_weights(getattr_nested(self.config, key), filename)

        i3d_embedder = lpips_fn = None
        missing = []
        i3d_path = find("eval.i3d_weights", W.I3D)
        if i3d_path:
            i3d_embedder = make_i3d_embedder(i3d_path, device=self.device)
            logger.info("FVD: I3D from %s on %s", i3d_path, self.device)
        else:
            missing.append(f"FVD (no eval.i3d_weights, no {W.I3D} in {W.default_dirs()})")
        lpips_path = find("eval.lpips_weights", W.LPIPS_LIN)
        alex_path = find("eval.lpips_alexnet_weights", W.ALEXNET)
        if lpips_path and alex_path:
            lpips_fn = make_lpips_fn(lpips_path, alex_path, device=self.device)
            logger.info("LPIPS: lin heads %s, AlexNet %s on %s", lpips_path, alex_path,
                        self.device)
        else:
            why = [f"no eval.{k} and no {f} in {W.default_dirs()}" for k, f, p in
                   (("lpips_weights", W.LPIPS_LIN, lpips_path),
                    ("lpips_alexnet_weights", W.ALEXNET, alex_path)) if not p]
            missing.append(f"LPIPS ({'; '.join(why)})")
        for m in missing:
            logger.info("metric left out: %s", m)
        return lpips_fn, i3d_embedder

    # ------------------------------------------------------------------ sample

    def _test_split(self):
        _, test_ds = get_dataset(self.args.data_path, self.config,
                                 video_frames_pred=self.config.data.num_frames)
        return test_ds

    def _generate(self, block, params, X, generator):
        """One block sampled on the cond of raw clips X, fully conditioned:
        (gen, real, cond) in [0, 1] numpy, folded (B, H, W, F*C)."""
        config = self.config
        Xt = data_transform(config, torch.from_numpy(X).to(self.device))
        real, cond, cond_mask = conditioning_fn(
            config, Xt, num_frames_pred=config.data.num_frames, prob_mask_cond=0.0,
            prob_mask_future=0.0, conditional=config.data.num_frames_cond > 0,
            generator=generator)
        C, F, sz = config.data.channels, config.data.num_frames, config.data.image_size
        init = init_noise(config, self.sched, (X.shape[0], sz, sz, C * F),
                          generator=generator, device=self.device)
        cond = None if cond is None else cond.permute(0, 2, 3, 1)
        gen = block(params, init, cond, cond_mask, generator=generator)
        host = (lambda t: None if t is None else
                inverse_data_transform(config, t).float().cpu().numpy())
        return host(gen), host(real.permute(0, 2, 3, 1)), host(cond)

    def sample(self, ckpt: Optional[int] = None):
        """A conditional batch sampled from checkpoint `ckpt` into
        `samples_{ckpt}.npz` (keys samples, real, cond: folded (B, H, W,
        F*C) in [0, 1]; upstream `sample`, ncsn_runner.py:914-1301). With
        sampling.fid, the FID sample dump instead; with sampling.inpainting
        or sampling.interpolation (SMLD), the Langevin branches."""
        args, config = self.args, self.config
        if getattr(config.sampling, "inpainting", False):
            return self._sample_inpainting(ckpt)
        if getattr(config.sampling, "interpolation", False):
            return self._sample_interpolation(ckpt)
        if getattr(config.sampling, "fid", False):
            return self._sample_fid_loop(ckpt)
        params, step = self._load_eval_params(ckpt)
        test_ds = self._test_split()
        bs = self._eval_batch_size(getattr(config.sampling, "batch_size", 16), len(test_ds),
                                   "sample()")
        X, _ = next(iter(DataLoader(test_ds, batch_size=bs, shuffle=False, drop_last=True)))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        samples, real, cond = self._generate(self._guarded_block_sampler(), params, X, gen)
        out_dir = getattr(args, "image_folder", args.log_path)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"samples_{ckpt or step}.npz")
        if self.is_main:
            np.savez(path, samples=samples, real=real, cond=cond)
            logger.info("wrote samples %s to %s", samples.shape, path)
        return samples

    def _sample_fid_loop(self, ckpt: Optional[int] = None):
        """sampling.num_samples4fid videos for an offline FID, in batches
        conditioned on shuffled test clips, as `fid_samples_{ckpt}_{i:05d}.npz`
        shards (upstream ncsn_runner.py:1190-1301)."""
        args, config = self.args, self.config
        params, step = self._load_eval_params(ckpt)
        total = getattr(config.sampling, "num_samples4fid", 10000)
        test_ds = self._test_split()
        bs = self._eval_batch_size(getattr(config.sampling, "batch_size", 16), len(test_ds),
                                   "sample fid loop")
        n_rounds = max(1, -(-total // bs))   # never undershoot
        data_iter = iter(DataLoader(test_ds, batch_size=bs, shuffle=True, seed=self.seed,
                                    repeat=True, drop_last=True))
        block = self._guarded_block_sampler()
        out_dir = getattr(args, "image_folder", args.log_path)
        os.makedirs(out_dir, exist_ok=True)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        n_written = 0
        for i in range(n_rounds):
            X, _ = next(data_iter)
            samples, _, _ = self._generate(block, params, X, gen)
            if self.is_main:
                np.savez(os.path.join(out_dir, f"fid_samples_{ckpt or step}_{i:05d}.npz"),
                         samples=samples)
            n_written += len(samples)
        logger.info("wrote %d FID sample batches (%d videos) to %s", n_rounds, n_written,
                    out_dir)
        return n_written

    def _eps_closure(self, params, cond=None, cond_mask=None):
        """eps_fn(x, labels) of the network on `params` (a state dict) and
        `cond`, in eval mode, on the JAX layout (B, H, W, F*C)."""
        cond_c = None if cond is None else cond.permute(0, 3, 1, 2)
        self.model.eval()

        def eps_fn(x, labels):
            out = functional_call(self.model, params, (x.permute(0, 3, 1, 2), labels, cond_c,
                                                       cond_mask))
            return out.permute(0, 2, 3, 1)
        return eps_fn

    def _smld_batch(self, ckpt: Optional[int], what: str):
        """(checkpoint params, step, Xt, generator) of an SMLD branch: the
        first test batch of sampling.batch_size (default 8, clamped to the
        split), data-transformed on the runner's device."""
        if self.sched.version != "SMLD":
            raise ValueError(f"{what} sampling is the SMLD legacy path, not "
                             f"{self.sched.version}")
        params, step = self._load_eval_params(ckpt)
        test_ds = self._test_split()
        bs = self._eval_batch_size(getattr(self.config.sampling, "batch_size", 8),
                                   len(test_ds), f"sample {what}")
        X, _ = next(iter(DataLoader(test_ds, batch_size=bs, shuffle=False)))
        Xt = data_transform(self.config, torch.from_numpy(X).to(self.device))
        return params, step, Xt, torch.Generator(device=self.device).manual_seed(self.seed)

    def _save_smld(self, name: str, **arrays):
        out_dir = getattr(self.args, "image_folder", self.args.log_path)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, name)
        if self.is_main:
            np.savez(path, **arrays)
            logger.info("wrote %s to %s", {k: v.shape for k, v in arrays.items()}, path)

    def _sample_inpainting(self, ckpt: Optional[int] = None):
        """Left-half-known inpainting (upstream ncsn_runner.py:957-1021) of the
        first test batch's predicted frames, conditioned on its past frames
        as usual, into `inpainting_{ckpt}.npz` (samples, refer: folded (B, H,
        W, F*C) in [0, 1]). The chain starts at data_transform(U[0, 1)) of the
        refer's shape and takes sampling.n_steps_each (default 100) and
        step_lr (8e-6)."""
        from ..diffusion.langevin_extras import anneal_langevin_inpainting

        config = self.config
        params, step, Xt, gen = self._smld_batch(ckpt, "inpainting")
        refer, cond, cond_mask = conditioning_fn(
            config, Xt, num_frames_pred=config.data.num_frames,
            conditional=config.data.num_frames_cond > 0, generator=gen)
        refer = refer.permute(0, 2, 3, 1)
        cond = None if cond is None else cond.permute(0, 2, 3, 1)
        init = data_transform(config, torch.rand(refer.shape, generator=gen,
                                                 device=self.device))

        def chain(p, init_, refer_, cond_, cond_mask_, *, generator=None):
            return anneal_langevin_inpainting(
                init_, refer_, self._eps_closure(p, cond_, cond_mask_), self.sched,
                n_steps_each=getattr(config.sampling, "n_steps_each", 100),
                step_lr=getattr(config.sampling, "step_lr", 8e-6), generator=generator)

        if pdist.world() > 1:   # each rank runs its rows of the chain
            chain = wrap_chain(chain)
        with torch.inference_mode():
            out = chain(params, init, refer, cond, cond_mask, generator=gen)
        host = (lambda t: inverse_data_transform(config, t).float().cpu().numpy())
        samples = host(out)
        self._save_smld(f"inpainting_{ckpt or step}.npz", samples=samples, refer=host(refer))
        return samples

    def _sample_interpolation(self, ckpt: Optional[int] = None):
        """The slerp-noise interpolation grid (upstream ncsn_runner.py:1023-
        1094): sampling.n_interpolations (default 15) samples for each row of
        the first test batch, conditioned on its past frames (each row's cond
        repeated), into `interpolation_{ckpt}.npz` (samples: (B *
        n_interpolations, H, W, F*C) in [0, 1]); sampling.n_steps_each
        (default 200) and step_lr (8e-6)."""
        from ..diffusion.langevin_extras import anneal_langevin_interpolation

        config = self.config
        params, step, Xt, gen = self._smld_batch(ckpt, "interpolation")
        n_interp = getattr(config.sampling, "n_interpolations", 15)
        sz, C, F = config.data.image_size, config.data.channels, config.data.num_frames
        _, cond, cond_mask = conditioning_fn(
            config, Xt, num_frames_pred=F, conditional=config.data.num_frames_cond > 0,
            generator=gen)
        if cond is not None:   # each row repeated n_interp times by the sampler
            cond = cond.permute(0, 2, 3, 1).repeat_interleave(n_interp, dim=0)
            cond_mask = (None if cond_mask is None
                         else cond_mask.repeat_interleave(n_interp, dim=0))
        init = data_transform(config, torch.rand((Xt.shape[0], sz, sz, F * C),
                                                 generator=gen, device=self.device))

        def chain(p, init_, cond_, cond_mask_, *, generator=None):
            return anneal_langevin_interpolation(
                init_, self._eps_closure(p, cond_, cond_mask_), self.sched, n_interp,
                n_steps_each=getattr(config.sampling, "n_steps_each", 200),
                step_lr=getattr(config.sampling, "step_lr", 8e-6), generator=generator)

        if pdist.world() > 1:   # init's rows and their n_interp cond rows each
            chain = wrap_chain(chain)
        with torch.inference_mode():
            out = chain(params, init, cond, cond_mask, generator=gen)
        samples = inverse_data_transform(config, out).float().cpu().numpy()
        self._save_smld(f"interpolation_{ckpt or step}.npz", samples=samples)
        return samples

    # ------------------------------------------------------------------ test

    def _sweep(self, begin=None, end=None, freq=None):
        """The numbered checkpoints in [begin, end], thinned by checkpoint
        number to every `freq`-th from the first (upstream range(begin, end,
        freq), ncsn_runner.py:2370); [None] (the rolling checkpoint) if none."""
        steps = [s for s in self._agreed_ckpt_steps(self._ckpt_dir())
                 if (begin is None or s >= begin) and (end is None or s <= end)]
        if freq and len(steps) > 1:
            base = begin if begin is not None else steps[0]
            steps = [s for s in steps if (s - base) % freq == 0]
        return steps or [None]

    def test(self, begin_ckpt: Optional[int] = None, end_ckpt: Optional[int] = None,
             freq: Optional[int] = None):
        """The mean DSM loss over the test split (`test.max_batches` caps the
        batches) of each checkpoint of the sweep, into test_losses.yml
        (upstream ncsn_runner.py:2370-2430). Every checkpoint sees the same
        clips (a loader of its own, at epoch 0: the SMMNIST clips depend on
        the epoch), and batch i draws its noise levels and noise from a
        generator seeded with i, so the checkpoints differ only in their
        weights. With P ranks each reads its strided shard of the split, bs/P
        a batch, and the loss is the global batch's mean; every rank stops at
        the batch count the smallest shard gives (a rank with one batch more
        would wait alone in its collective)."""
        args, config = self.args, self.config
        test_ds = self._test_split()
        n_proc = pdist.world()
        bs = self._eval_batch_size(config.test.batch_size, (len(test_ds) // n_proc) * n_proc,
                                   "test()")
        n_batches = (len(test_ds) // n_proc) // (bs // n_proc)
        max_batches = getattr(config.test, "max_batches", None)
        if max_batches is not None:
            n_batches = min(n_batches, int(max_batches))
        eval_fn = make_eval_loss_step(self.model, self.sched, config)
        results = {}
        for s in self._sweep(begin_ckpt, end_ckpt, freq):
            params, loaded_step = self._load_eval_params(s)
            losses = []
            loader = DataLoader(test_ds, batch_size=bs // n_proc, shuffle=False, drop_last=True,
                                num_processes=n_proc, process_index=pdist.rank())
            for i, (X, _) in enumerate(loader):
                if i >= n_batches:
                    break
                gen = torch.Generator(device=self.device).manual_seed(i)
                losses.append(float(eval_fn(params, torch.from_numpy(X).to(self.device),
                                            generator=gen)))
            results[s or loaded_step] = float(np.mean(losses))
            logger.info("ckpt %s: test DSM loss %.6f over %d batches", s or loaded_step,
                        results[s or loaded_step], len(losses))
        if self.is_main:
            yaml_subset.dump_file(results, os.path.join(args.log_path, "test_losses.yml"))
        return results

    # ---------------------------------------------------------------- fast_fid

    def fast_fid(self):
        """FID (with kNN precision/recall unless --no_pr) of each checkpoint
        of the sweep, into fids.yml (upstream ncsn_runner.py:2432-2586):
        fast_fid.num_samples frames sampled on the cond of test clips,
        embedded by the Inception network on the runner's device, against
        the test split's frames (embedded, or read from --feats_dir).
        Samples and features are cached per checkpoint (`samples_{tag}.npy`,
        `feats_{tag}.npy`) and read back on a later run. With
        fast_fid.ensemble, each checkpoint samples with the score network's
        outputs averaged over a trailing window of up to
        fast_fid.num_ensembles checkpoints (upstream fast_ensemble_fid,
        ncsn_runner.py:2588-2700)."""
        from ..eval import weights as W
        from ..eval.fid import (activation_statistics, calculate_frechet_distance,
                                get_fid_pr, make_inception_embedder)

        args, config = self.args, self.config
        ff = config.fast_fid
        inc_path = W.find_weights(getattr_nested(config, "eval.inception_weights"),
                                  W.INCEPTION)
        if not inc_path:
            raise FileNotFoundError(
                f"fast_fid needs Inception feature weights: set eval.inception_weights or put "
                f"{W.INCEPTION} in one of {W.default_dirs()} (upstream downloads pt_inception)")
        embed = make_inception_embedder(inc_path, device=self.device)
        logger.info("FID: Inception from %s on %s", inc_path, self.device)

        test_ds = self._test_split()
        num_samples = getattr(ff, "num_samples", 1000)
        bs = self._eval_batch_size(min(getattr(ff, "batch_size", 100), num_samples),
                                   len(test_ds), "fast_fid")
        k = getattr(ff, "pr_nn_k", 3)
        no_pr = bool(getattr(args, "no_pr", False))
        C, F = config.data.channels, config.data.num_frames

        # real features: precomputed (--feats_dir, upstream fid_PR.py's
        # feats-path registry) or embedded from the test split and cached
        feat_r = None
        feats_dir = getattr(args, "feats_dir", None)
        real_cache = (os.path.join(feats_dir, f"{getattr(config.data, 'dataset', 'data')}"
                                              f"_feats.npy") if feats_dir else None)
        # every rank takes the cache only if every rank sees it
        if real_cache and all_processes_true(os.path.isfile(real_cache)):
            feat_r = np.load(real_cache)
            logger.info("loaded real features from %s", real_cache)
        if feat_r is None:
            reals, n = [], 0
            for X, _ in DataLoader(test_ds, batch_size=bs, shuffle=False):
                reals.append(X.reshape(-1, *X.shape[2:]))
                n += len(reals[-1])
                if n >= num_samples:
                    break
            feat_r = embed(np.concatenate(reals)[:num_samples])
            if real_cache and self.is_main:
                os.makedirs(feats_dir, exist_ok=True)
                np.save(real_cache, feat_r)

        cache_dir = getattr(args, "image_folder", args.log_path)
        os.makedirs(cache_dir, exist_ok=True)
        ensemble = bool(getattr(ff, "ensemble", False))
        num_ensembles = int(getattr(ff, "num_ensembles", 5))
        block = self._guarded_block_sampler(ensemble=ensemble)
        begin = getattr(args, "ckpt", None) or getattr(ff, "begin_ckpt", 0)
        end = getattr(args, "end_ckpt", None) or getattr(ff, "end_ckpt", 10 ** 12)
        eligible = self._sweep(begin, end, getattr(args, "freq", None))
        fids = {}
        for idx, s in enumerate(eligible):
            params, loaded = self._load_eval_params(s)
            tag = s or loaded
            if ensemble:
                # a trailing window of up to num_ensembles checkpoints ending
                # at s; copies, s's own first, as the next load may overwrite
                # what a load gave (the model's own tensors without model.ema)
                window = eligible[max(0, idx - (num_ensembles - 1)):idx + 1]
                own = _clone(params)
                params = [_clone(self._load_eval_params(w)[0]) for w in window[:-1]] + [own]
                tag = f"{tag}_ens{len(params)}"
            feats_cache = os.path.join(cache_dir, f"feats_{tag}.npy")
            if all_processes_true(os.path.isfile(feats_cache)):
                feat_g = np.load(feats_cache)
                logger.info("ckpt %s: features read from %s", tag, feats_cache)
            else:
                gen = torch.Generator(device=self.device).manual_seed(self.seed)
                loader = iter(DataLoader(test_ds, batch_size=bs, shuffle=False, repeat=True,
                                         drop_last=True))
                samples, n = [], 0
                while n < num_samples:
                    X, _ = next(loader)
                    g, _, _ = self._generate(block, params, X, gen)
                    B, H, W_, _ = g.shape   # frames as images (B*F, H, W, C)
                    samples.append(g.reshape(B, H, W_, F, C).transpose(0, 3, 1, 2, 4)
                                   .reshape(B * F, H, W_, C))
                    n += len(samples[-1])
                sample_imgs = np.concatenate(samples)[:num_samples]
                feat_g = embed(sample_imgs)
                if self.is_main:
                    np.save(os.path.join(cache_dir, f"samples_{tag}.npy"), sample_imgs)
                    np.save(feats_cache, feat_g)
            if no_pr:
                mu_r, sig_r = activation_statistics(feat_r)
                mu_g, sig_g = activation_statistics(feat_g)
                res = {"fid": calculate_frechet_distance(mu_r, sig_r, mu_g, sig_g)}
            else:
                res = get_fid_pr(feat_r, feat_g, k=k)
            fids[s or loaded] = res
            logger.info("ckpt %s%s: %s", s or loaded, " (ensemble)" if ensemble else "", res)
        out = {int(kk): {m: float(v) for m, v in vv.items()} for kk, vv in fids.items()}
        if self.is_main:
            yaml_subset.dump_file(out, os.path.join(args.log_path, "fids.yml"))
        return out


def _clone(params):
    return {k: v.detach().clone() for k, v in params.items()}


def _host_mem_gb() -> float:
    try:
        import psutil
    except ImportError:
        return 0.0
    return psutil.Process().memory_info().rss / 1e9
