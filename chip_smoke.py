#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA toolkit) and triton; builds the port's
kernels from `mcvd_tpu_torch/csrc` and `mcvd_tpu_torch/ops` at first use.
Imports torch, numpy and `mcvd_tpu_torch` only (no jax). Phases, one JSON
line each:

  1. env       torch/CUDA versions and the card's name and power limit;
  2. build     the nvcc build (with ptxas' registers and spills per kernel)
               and the first Triton compile, in seconds;
  3. kernels   each kernel against its plain PyTorch version, fp32 (TF32
               off) and bf16: the GroupNorm `gn_fused` at every shape and
               form of one flagship evaluation (read from the model by
               `tools.gn_calls`), with its plan (cluster, blocks, rows,
               threads, shared memory, clusters resident at once);
               attention at the main path's T and a ragged T, and at the
               head dims 96, 128 and 192 of the shipped configs with wider
               heads (`WIDE_ATTN_CASES`), every case on the wgmma route
               (`ops.attention.attention_route`: TMA-fed wgmma, bf16
               m64nNk16 and fp32 as 3xTF32 on m64nNk8; head dim 24, held
               by `small5`, takes it too), the route, the plan
               (`ops.attention.attention_plan`, held to the library's own)
               and the host us of enqueue of each case recorded (on tensors seen
               before, and on new ones whose tensor maps are encoded), the bf16
               route held per element to the bound of rounding p to bf16
               and, tighter, to a plain emulation of its own arithmetic
               (`ops.attention.bf16_tolerances`: the bound of the long rows,
               or the flips of the p near a bf16 midpoint where they exceed
               it; whether the long rows' bound alone held and the share of
               outputs where it was exceeded are recorded). Max abs error, median
               device ms of
               kernel and plain version, host us of enqueue per GroupNorm
               call, and the one PyTorch call that computes the same
               function where there is one (`F.group_norm` for the affine
               GroupNorm, `F.scaled_dot_product_attention`), timed for
               comparison only; the GroupNorm totals of one evaluation;
  4. profile_gn2  the GroupNorm microbenchmark's kernels (`gn_copy`,
               `gn_variant`) and `fused_leaky_relu` against their plain
               versions at the tool's shapes, `gn_variant` against the port's
               GroupNorm; then the tool's own run
               (`mcvd_tpu_torch.tools.profile_gn2.measure`) and the
               `fused_leaky_relu` op at a main-path activation, with their
               launch counts: device ms and host us per call of each line;
  5. slice     one flagship block (ngf=64, 10 steps + denoise, B=4, fp32)
               through the kernels and under `ops.reference_ops()`, same
               weights (passed to the sampler per call) and draws; the
               parameter count;
  6. headline  the bench protocol: B=16, 100-step DDPM + denoise, 16 frames
               of 64x64 predicted in 4 blocks of 5 on 5 cond frames, bf16
               score network; one warm-up, 2 timed requests, frames/s, and
               the launch counts of each request;
  7. train_kernels  the backward kernels against the plain backward passes,
               fp32 (TF32 off) and bf16 at B=16: `gn_fused_bwd` at every
               GroupNorm shape and form of one flagship evaluation (and
               frames_last=2), through autograd with the inputs' and
               parameters' gradients, at C=192 64x64 also with L2 flushed
               before each call (`cold_ms`); `attention_bwd` at every
               attention case of phase 3, bf16 also per element within
               `ops.attention.bf16_bwd_tolerances` of the plain backward
               and, tighter, of `attention_bwd_tc_emulation` on the
               kernel's own forward, and both dtypes bit-identical over two
               calls. Max abs error, device ms of the
               kernel alone (from the forward's saved statistics or
               logsumexp) and of the plain backward, the bound, and the
               one PyTorch call for comparison (autograd of `F.group_norm`
               for the affine form, SDPA's backward), launches per call;
  8. train_slice  one flagship training step (B=4, fp32, TF32 off, dropout 0,
               warmup 0) through the kernels and under `ops.reference_ops()`
               from the same weights and draws: loss, grad_norm, every
               gradient (through Adam's first moment), the updated
               parameters and the EMA, and exact launch counts (67 GroupNorm
               and 10 attention calls, forward and backward);
  9. wide_heads  bair_big (D=96, 64 px) and cityscapes_big (D=128, 128 px)
               at full width, random weights from a seed (zero-scale layers
               redrawn): one fp32 network evaluation (B=2) and one fp32
               training step (B=2) through the kernels against
               `ops.reference_ops()` at train_slice's tolerances, with
               exact launch counts (the model's GroupNorm and attention
               calls) and the JAX init's parameter count;
 10. small5    the legacy UNet (smmnist_DDPM_small5.yml), the 3D NCSN++
               (smmnist_DDPM_small5_3d.yml) and its pseudo-3D twin (`SMALL5`):
               every GroupNorm and attention call of one evaluation of the
               three, read from the models, through the kernels against the
               plain versions in both dtypes, forward and backward, by
               the helpers of phases 3 and 7 (attention at D=24 over 256, 16, 7
               and 2 tokens at B=4 and B=64 clips, on the wgmma route, packed
               at T <= 64 and tiled at 256, each case's plan recorded and held
               to the library's; bf16 GroupNorm at 84
               channels on 8-byte vectors, one call of each past the grid's
               65,535), timed with library and bound; each model at full
               width: an fp32 evaluation at B=64 and one fp32 step against
               `reference_ops()` (the tolerances of phase 9, gradients zero
               in exact arithmetic held to their rounding noise), the bf16
               evaluation, exact launch counts, the JAX init's parameter
               count, 3 timed steps; the CLI on the two ymls (--train to 3
               with its in-training video_gen, `SMALL5_CLI_MODS`); the
               committed JAX export imported by `compat.jax_ckpt`, bit-equal, and sampled
               by --video_gen;
 11. smld      the SMLD family (PR 12) at the shipped widths (`SMLD_MODELS`):
               one fp32 evaluation each of NCSNv2 at 32 px (cifar10_ncsnv2,
               B=16) and 64 px (church, B=4), NCSNv2Deeper at 128 px
               (bedroom, B=2), NCSNv2Deepest at 256 px (ffhq, B=2) and NCSNv1
               at 32 px (B=16), timed, with the JAX init's parameter counts,
               the 32- and 64-px ones held to the CPU on the same weights; the
               cifar10_ncsnv2 fp32 step at the yml's B=128, timed, and a B=4
               step held to the CPU's; one Langevin block (10 levels x 5 steps +
               denoise, B=16) through `make_block_sampler`, held to the same
               chain on the CPU; a synthetic FFHQ r256 shard through
               `get_dataset` into the 256-px model; `model.normalization=
               GroupNorm`: `gn_fused` and `gn_fused_bwd` at the model's shapes,
               an evaluation and a step against `reference_ops()` with exact
               launch counts; the CLI (--train, --sample with inpainting and
               with interpolation) on synthetic CIFAR-10 pickles;
 12. train_headline  the yml's training config at full width, B=64, fp32 and
               then bf16 compute: one warm-up step, 5 timed steps, ms per
               step, clips/s, peak memory and the launch counts per step;
 13. cli       the port's command line as a user runs it, in subprocesses,
               on configs/smmnist_DDPM_big5.yml at full width (ngf 64, B=64,
               fp32 as the yml says), changing only cadence and traffic
               (`CLI_MODS`): --train to step 6 (checkpoints at 3 and 6, the
               validation loss at 3 and 6, a snapshot with its in-training
               video_gen at 6), --resume_training to step 9, then
               --video_gen --ckpt 6 (one batch of 16 clips, 10 frames in 2
               blocks of CLI_SUBSAMPLE steps + denoise). Checks: the steps continue
               6 -> 9, checkpoint_6 loads bit-equal into a fresh state here,
               best_metrics.yml and vid_metrics.yml hold finite mse, psnr
               and ssim, and each run's kernel launch counts are exact
               (`CLI_LAUNCHES`). Emits the loop's ms per step (each step
               timed alone by the runner's log, the first of each process
               apart as warm-up) beside train_headline's fp32 step, and the
               video_gen harness's seconds;
 14. ddp       data parallelism on the one card: `tools.ddp_check`
               on 2 gloo ranks (the flagship's fp32 step at a global B=16,
               8 a rank, and its 10-step block split 8 + 8, held to one
               process on the same draws; the ranks' parameters the same
               bits; exact launch counts per rank; step, all-reduce and peak
               memory) and on 1 NCCL rank; the flagship's CLI on 2 gloo
               ranks (`DDP_CLI_RUNS`: --train to 3 with the snapshot and its
               vote at 2, then --test and --video_gen side by side, and the
               NCCL check beside them): exit 0,
               launch counts per rank, rank 0's files alone, the checkpoint
               bit-equal, the same finite numbers in both ranks' logs; the
               polyphase FIR (`ops/upfirdn.py`) against `upsample_2d` at the
               flagship's Upsample inputs, timed;
 15. data      the data readers on the card machine's host: synthetic shards
               (`DATA_SETS`: KTH, BAIR, Cityscapes, UCF101 at their shipped
               frame sizes, `synth_video`) written by the port's HDF5Maker,
               every frame read back bit-equal through the native LZF
               decoder and the first videos of each split through the plain
               one; LZF MB/s; each reader's clips/s through `DataLoader` at
               its config's B=64 with 0 and 4 worker threads, cache cold and
               warm (the worker counts giving the same batches); SMMNIST's
               batch path against its per-item path;
 16. cli_data  the command line on those shards at the configs' full width
               (`CLI_DATA_RUNS`): --train and --video_gen on bair_big.yml and
               kth64_big.yml, --train on ucf101.yml and cityscapes_big.yml;
               exact launch counts (the model's GroupNorm and attention
               calls), the checkpoint loaded bit-equal, finite losses and
               metrics; the loop's ms a step and its wait on the loader;
 17. images    the image paths without PIL: every golden of
               tests/golden/images.npz decoded by the port's codecs (JPEG,
               WebP, PNG, BMP) bit-equal to PIL's decode stored beside it, the
               datasets' resizes bit-equal to PIL's; each codec's decode MB/s
               and images/s; the CelebA, LSUN (64 and 128 px) and ImageFolder
               readers' items/s at B=128 with 0 and 4 loader threads on trees
               copied from the goldens; every GroupNorm and attention call of
               celeba.yml's NCSN++ at B=16 through the kernels against the
               plain versions (fp32, forward and backward, timed); the model
               at full width: an fp32 evaluation and an fp32 step against
               `reference_ops()`, exact launch counts; the sample grid's PNG
               and GIF read back; the CLI (`IMAGES_CLI_RUNS`): celeba.yml
               --train to 3 at B=16, church.yml --train to 2 on an LMDB of
               WebP values; the fid_pr tool on two .npz sets.

Then the per-kernel summary line of the seven kernels (with each kernel's
bound: the larger of its bytes over the HBM rate and its operations over the
peak rate for its type; for fp32 attention the smaller of that on the CUDA
cores and of three TF32 products per product, the route the kernels take),
the card line, and last {"ok": true, "device":
{...}}. Any failed check raises: the exit code is nonzero and the last line
is not printed.
"""

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from math import ceil

import numpy as np
import torch
import torch.nn.functional as F

FLAGSHIP_PARAM_COUNT = 27_941_765   # jax.eval_shape of the JAX flagship init
ATTN_SHAPES = [(1024, 2), (256, 3), (64, 4)]             # (T, heads), D=64, B=16
# (T, heads, head dim) of the attention in the shipped configs with wider
# heads, at 32, 16 and 8 px: bair_big and kth64_big (D=96, 2/3/4 heads),
# ucf101 (D=96, 4/6/8 heads), cityscapes_big (D=128, 2/3/4 heads),
# cityscapes_big_spade (D=192, 2/3/4 heads).
WIDE_ATTN_CASES = [(1024, 2, 96), (256, 3, 96), (64, 4, 96), (1024, 4, 96), (256, 6, 96),
                   (64, 8, 96), (1024, 2, 128), (256, 3, 128), (64, 4, 128),
                   (1024, 2, 192), (256, 3, 192), (64, 4, 192)]
# Every attention case: the main path's, a ragged T, and the wider heads.
ATTN_CASES = [(T, h, 64) for T, h in ATTN_SHAPES] + [(100, 2, 64)] + WIDE_ATTN_CASES
# The full-width configs with wider heads (`wide_heads` phase): name ->
# (head dim, parameter count of jax.eval_shape of the JAX init).
WIDE_CONFIGS = {"bair_big": (96, 62_844_975), "cityscapes_big": (128, 116_551_695),
                "bair_big_spade": (96, 101_760_303),
                "cityscapes_big_spade": (192, 432_180_623)}
# The SPADE flagship (`spade` phase): configs/smmnist_DDPM_big5_spade.yml at
# full width, and its parameter count (jax.eval_shape of the JAX init).
SPADE_CONFIG = "configs/smmnist_DDPM_big5_spade.yml"
SPADE_PARAM_COUNT = 53_953_989
GN_FORMS = {  # name: (affine, adagn, act); each call's eps comes with its shape
    "adagn_silu": (False, True, True),      # BigGAN resblocks' AdaGN (eps 1e-5)
    "affine": (True, False, False),          # attention blocks (eps 1e-6)
    "affine_silu": (True, False, True),      # output head (1e-5), DDPM resblocks (1e-6)
    "plain": (False, False, False),          # SPADE's norm (eps 1e-6)
}
# GroupNorm calls of one evaluation of each model the kernel phases read.
GN_CALLS = {"flagship": 67, "spade": 67, "ddpm_resblock": 55}
# Kernel vs plain, both computing in fp32. fp32: the sums run in another
# order (1e-4 over up to 4096*192 terms). bf16: both round the same fp32
# value once to bf16, so they differ by at most one rounding step where the
# two fp32 values straddle a boundary: two bf16 ulps relative.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 1.6e-2)}  # (atol, rtol)
# gn_variant vs its plain version: as TOL. With stats_bf16 each channel's
# fp32 sums, taken in another order, are rounded to bf16; where the two land
# on either side of a bf16 boundary a statistic moves by one bf16 step, which
# moves y by up to ~1e-2 at the tool's inputs.
STATS_BF16_TOL = (1e-2, 1.6e-2)
# fused_leaky_relu vs plain: both compute in fp32 and round once.
ACT_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (0.0, 2 ** -7)}
# Published H100 SXM peaks (NVIDIA's data sheet): dense FLOP/s of fp32 on
# the CUDA cores and of bf16 and TF32 on the tensor cores (the HBM3 rate is
# the tool's, `profile_gn2.HBM_BYTES_PER_S`).
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12}
# The attention kernels' instructions, by route (`ops.attention.attention_route`)
# and dtype.
ATTN_PATH = {("wgmma", "bfloat16"): "wgmma m64nNk16 bf16, TMA ring, warp-specialised",
             ("wgmma", "float32"): "wgmma m64nNk8 3xTF32, TMA ring, warp-specialised"}
# The attention wrappers' one route and its sources (the kernels line).
ATTN_ROUTES = {"wgmma": "mcvd_tpu_torch/csrc/attention_wgmma.cuh (attention_wgmma_bf16.cu, "
                        "attention_wgmma_f32.cu; head dim 24 attention_wgmma_d24.cu): head "
                        "dims 24-192, tiled, and packed for head dim 24 at T <= 64"}
# Host us of enqueue of an attention call: the median of 3 runs of this many
# calls.
ATTN_HOST_CALLS = 20
# The flagship block, fp32: 11 evaluations of the 27.9M-parameter network
# whose sums run in another order; the first steps divide eps by
# sqrt(alpha) ~ 0.0067 before the x0 clip.
SLICE_ATOL = 5e-3
# A 100-step DDIM block (eta 0: no noise along the chain) may end further
# apart than SLICE_ATOL; its witness is the plain chain run again from an
# init moved by WITNESS_REL of its largest value (about one evaluation's
# rounding, 1.4e-5 of its largest output on the card). The kernels' chain
# must end no further from the plain chain than WITNESS_FACTOR times that.
WITNESS_REL = 1e-5
WITNESS_FACTOR = 10.0
# The training phases: each kernel once per GroupNorm and attention call of
# one step, forward and backward.
TRAIN_LAUNCHES = {"gn_fused": 67, "gn_fused_bwd": 67, "attention_fwd": 10, "attention_bwd": 10}
# attention_bwd against the plain backward, per d(q), d(k), d(v): the max
# error over the largest entry. fp32: summation order. bf16: one rounding of
# each gradient (2^-8 of its size) and the row term D = rowsum(dO * O) taken
# from the forward's output, whose p the tensor cores rounded to bf16 (2^-8
# relative): together within 2^-6.
ATTN_BWD_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# The fp32 training step, kernels against plain (same weights and draws):
# loss and grad_norm rtol 1e-4; gradients (mu = 0.1 g after the first step)
# 1e-3 of each tensor's largest entry, floored at 1e-6 of the model's
# largest gradient (the rounding noise of an exactly-zero gradient such as
# the key bias's); parameters after the Adam step 0.1*lr where |mu| >= 1e-2
# of its tensor's largest (the update's error is ~lr * error(mu) / |mu|),
# else 2*lr, the update's own bound; EMA 1e-3 of that plus 1e-6.
TRAIN_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-3
# The CLI runs' sampler: 10 steps + denoise a block (cut from 100, then to
# 50, 25 and 10, to keep the script inside its time limit), BLOCK
# evaluations.
CLI_SUBSAMPLE = 10
BLOCK = CLI_SUBSAMPLE + 1
# The cli phase: the shipped yml as a user runs it, with only the cadence
# and the traffic cut to a few steps and one evaluation batch.
CLI_CONFIG = "configs/smmnist_DDPM_big5.yml"
CLI_MODS = ["training.checkpoint_freq=3", "training.snapshot_freq=3", "training.val_freq=3",
            "training.log_freq=1", f"sampling.subsample={CLI_SUBSAMPLE}",
            "sampling.batch_size=16", "sampling.max_data_iter=1", "sampling.num_frames_pred=10"]


def _cli_launches(steps, evals, n_gn=67, n_attn=10):
    """The flagship's 67 GroupNorm and 10 attention calls (or a model's
    n_gn and n_attn) a network evaluation, forward, and as many backward a
    training step."""
    return {"gn_fused": n_gn * (steps + evals), "gn_fused_bwd": n_gn * steps,
            "attention_fwd": n_attn * (steps + evals), "attention_bwd": n_attn * steps}


# The cli phase's runs, in order: (name, n_iters, flags, config mods beside
# CLI_MODS). The evaluation modes' traffic is cut too: 32 videos for the FID
# sample dump (2 shards of 16), 80 frames of one batch of 16 clips per
# checkpoint for fast_fid. "{w}" is the directory of the stand-in metric
# weights the phase writes, "{feats}" fast_fid's real-feature cache.
FID_FLAGS = ["--fast_fid", "--ckpt", "6", "--fid_num_samples", "80", "--fid_batch_size", "16",
             "--feats_dir", "{feats}"]
CLI_RUNS = [   # on CLI_CONFIG
    ("train", 6, ["--train"], []),
    ("resume", 9, ["--train", "--resume_training"], []),
    ("video_gen", 9, ["--video_gen", "--ckpt", "6"],
     ["eval.i3d_weights={w}/i3d_torchscript.pt", "eval.lpips_weights={w}/lpips_alex_lin.pth",
      "eval.lpips_alexnet_weights={w}/alexnet.pth"]),
    ("test", 9, ["--test"], []),
    ("sample", 9, ["--sample", "--ckpt", "9"], []),
    ("sample_fid", 9, ["--sample", "--ckpt", "9"],
     ["sampling.fid=true", "sampling.num_samples4fid=32"]),
    ("fast_fid", 9, FID_FLAGS, ["eval.inception_weights={w}/inception.pt"]),
    ("fast_fid_ensemble", 9, FID_FLAGS,
     ["eval.inception_weights={w}/inception.pt", "fast_fid.ensemble=true"]),
    ("fast_fid_cached", 9, FID_FLAGS, ["eval.inception_weights={w}/inception.pt"]),
]
# Each run's launches (a sampler block is BLOCK evaluations; a video_gen
# predicts 10 frames in 2 blocks): --train to 6 (6
# steps, 2 validation losses, in-training video_gens at 3 and 6),
# --resume_training to 9 (3 steps, 1 validation loss, the video_gen at 9),
# --video_gen (2 blocks), --test
# (checkpoints 3, 6, 9, 2 batches of 100 each), --sample (1 block), the FID
# dump (2 blocks), fast_fid (checkpoints 6 and 9, 1 block each; the ensemble
# samples 9 with 2 checkpoints: 2 evaluations a step), the cached rerun
# (none).
CLI_LAUNCHES = {"train": _cli_launches(6, 2 + 2 * 2 * BLOCK),
                "resume": _cli_launches(3, 1 + 2 * BLOCK),
                "video_gen": _cli_launches(0, 2 * BLOCK), "test": _cli_launches(0, 3 * 2),
                "sample": _cli_launches(0, BLOCK), "sample_fid": _cli_launches(0, 2 * BLOCK),
                "fast_fid": _cli_launches(0, 2 * BLOCK),
                "fast_fid_ensemble": _cli_launches(0, BLOCK + 2 * BLOCK),
                "fast_fid_cached": _cli_launches(0, 0),
                "spade_train": _cli_launches(3, 1 + 2 * BLOCK),
                "spade_video_gen_ddim": _cli_launches(0, 2 * BLOCK)}
# The SPADE runs, on SPADE_CONFIG in an experiment of their own: --train to 3
# (3 steps, the validation loss and the in-training video_gen at 3, 2 blocks),
# then --video_gen --ckpt 3 with DDIM (2 blocks). They run beside the
# flagship's evaluation modes, once the runs whose times are reported
# (--train, --resume_training and the video_gen harness) are done, to keep
# the script inside its time limit; their own wall seconds are then shared.
CLI_SPADE_AFTER = "video_gen"
CLI_SPADE_RUNS = [("spade_train", 3, ["--train"], []),
                  ("spade_video_gen_ddim", 3, ["--video_gen", "--ckpt", "3"],
                   ["model.version=DDIM"])]
# The ddp phase: ranks launched as processes of one group on the one card
# (gloo; NCCL refuses two ranks on one device), each with this time limit.
DDP_RANKS = 2
DDP_TIMEOUT_S = 420
# the flagship's 2-rank CLI: CLI_MODS with the snapshot (and its vote) at 2,
# --train to 3, then --test (checkpoint 2, its 2 batches of 100 split 50 + 50)
# and --video_gen --ckpt 2; each rank launches a block's evaluations on its
# half of the batch, so its counts are one process's.
DDP_CLI_MODS = CLI_MODS + ["training.snapshot_freq=2"]
DDP_CLI_RUNS = [("train", ["--train"]), ("test", ["--test"]),
                ("video_gen", ["--video_gen", "--ckpt", "2"])]   # the last two side by side
DDP_CLI_LAUNCHES = {"train": _cli_launches(3, 1 + 2 * BLOCK), "test": _cli_launches(0, 2),
                    "video_gen": _cli_launches(0, 2 * BLOCK)}
# the polyphase FIR (`ops/upfirdn.py`) against `models/resample.upsample_2d`
# at the flagship's Upsample inputs (bf16, B=16; each twice an evaluation)
UPFIRDN_SHAPES = [(16, 256, 8, 8), (16, 192, 16, 16), (16, 128, 32, 32)]
# The metric networks on the card against the same modules on the CPU, fp32
# with TF32 off: within this share of the largest output.
EVAL_NET_REL = 1e-4
# The data phase: synthetic shards in each reader's layout, written by the
# port's HDF5Maker at the shipped frame sizes (KTH grey, UCF101 64x85 as its
# converter stores 240x320 at 64 px): name: (config, frame shape, train
# videos, test videos). 64 train videos fill one batch of each config's
# B=64; UCF101's 20 test videos give its test split 2 (every 10th).
DATA_SETS = {"kth64_big": ("configs/kth64_big.yml", (64, 64), 64, 16),
             "bair_big": ("configs/bair_big.yml", (64, 64, 3), 64, 16),
             "cityscapes_big": ("configs/cityscapes_big.yml", (128, 128, 3), 64, 8),
             "ucf101": ("configs/ucf101.yml", (64, 85, 3), 64, 20)}
DATA_FRAMES = 30          # frames a video
DATA_PLAIN_VIDEOS = 4     # videos of each split read again through the plain LZF decoder
DATA_WORKERS = (0, 4)
DATA_WARM_BATCHES = 3
# The CLI on the new datasets, at full width: (config, runs, config mods beside
# CLI_DATA_MODS). Each --train validates once at its last step and writes
# checkpoint_N there (no in-training video_gen); --video_gen predicts one
# batch of 16 clips, 10 frames (2 blocks). The batch
# is the yml's 64 but for ucf101 (ngf 192: 32) and cityscapes_big (128 px,
# fp32 on cuDNN's FFT-tiled convolution, PERF.md section 5: 2, cut from 4 to
# keep the script inside its time limit).
CLI_DATA_MODS = ["training.snapshot_sampling=False", "training.log_freq=1",
                 f"sampling.subsample={CLI_SUBSAMPLE}", "sampling.batch_size=16",
                 "sampling.max_data_iter=1", "sampling.num_frames_pred=10"]
CLI_STANDIN_MODS = ["eval.i3d_weights={w}/i3d_torchscript.pt",
                    "eval.lpips_weights={w}/lpips_alex_lin.pth",
                    "eval.lpips_alexnet_weights={w}/alexnet.pth"]
CLI_DATA_RUNS = [
    ("bair_big", [("train", 3, ["--train"], []),
                  ("video_gen", 3, ["--video_gen", "--ckpt", "3"], CLI_STANDIN_MODS)]),
    ("kth64_big", [("train", 3, ["--train"], []),
                   ("video_gen", 3, ["--video_gen", "--ckpt", "3"], CLI_STANDIN_MODS)]),
    ("ucf101", [("train", 2, ["--train"], ["training.batch_size=32"])]),
    ("cityscapes_big", [("train", 2, ["--train"], ["training.batch_size=2"])]),
]

# The small5 phase: the two SMMNIST small configs at full width -- the
# legacy UNet (`arch: unet`, smmnist_DDPM_small5.yml) and the 3D NCSN++
# (smmnist_DDPM_small5_3d.yml) -- and the latter with the pseudo-3D convs:
# name -> (yml, config mods, GroupNorm and attention calls of one
# evaluation, the parameter count of jax.eval_shape of the JAX init).
SMALL5 = {"small5": ("configs/smmnist_DDPM_small5.yml", [], 51, 6, 2_246_626),
          "small5_3d": ("configs/smmnist_DDPM_small5_3d.yml", [], 57, 6, 1_619_601),
          "small5_pseudo3d": ("configs/smmnist_DDPM_small5_3d.yml",
                              ["model.arch=unetmorepseudo3d"], 57, 6, 1_248_733)}
# The 3D model's attention (one head of D=24 over 256 or 16 space tokens and
# over 7 or 2 frames) at these batches of clips: B*7 ... B*256 sequences.
SMALL5_ATTN_B = (4, 64)
# One call of each kernel with more sequences or examples than the grid's
# 65,535 (the time attention at fast_fid's batch of 1000 has 256,000).
PAST_GRID = 70_000
# The CLI on the two configs: --train to 3 (the validation loss at 3, and
# the in-training video_gen of one batch of 16 clips with 4 predicted frames
# in 2 blocks of CLI_SUBSAMPLE steps + denoise at 3; a --video_gen process
# of its own before, cut to keep the script inside its time limit).
# Cut from the ymls' subsample 1000 and 20 frames (10 blocks of 1,001
# evaluations).
SMALL5_CLI_MODS = ["training.checkpoint_freq=3", "training.snapshot_freq=3",
                   "training.val_freq=3", "training.snapshot_sampling=True",
                   "training.log_freq=1", f"sampling.subsample={CLI_SUBSAMPLE}",
                   "sampling.batch_size=16", "sampling.max_data_iter=1",
                   "sampling.num_frames_pred=4"]
# The committed export of a JAX run (tools/export_jax_checkpoint.py; the
# flagship yml at ngf 24, one level, 41,762 parameters), imported by
# compat.jax_ckpt and sampled by --video_gen --ckpt 1 on the card.
JAX_EXPORT = "tests/golden/jax_ckpt_tiny.npz"
JAX_EXPORT_MODS = [f"sampling.subsample={CLI_SUBSAMPLE}", "sampling.batch_size=16",
                   "sampling.max_data_iter=1", "sampling.num_frames_pred=4"]


# The smld phase: the SMLD family (arch ncsnv2 / ncsn, model.version SMLD) at
# the shipped widths; name -> (yml, config mods, the evaluation's batch, the
# parameter count of jax.eval_shape of the JAX init, held to the CPU). Only
# the batch is cut (the ymls' training batches are 128, 128, 128 and 32).
SMLD_MODELS = {"ncsnv2_32": ("configs/cifar10_ncsnv2.yml", [], 16, 29_694_083, True),
               "ncsnv2_64": ("configs/church.yml", [], 4, 29_694_083, True),
               "ncsnv2_deeper_128": ("configs/bedroom.yml", [], 2, 83_445_379, False),
               "ncsnv2_deepest_256": ("configs/ffhq.yml", [], 2, 94_132_611, False),
               "ncsn_v1_32": ("configs/cifar10_ncsnv2.yml", ["model.arch=ncsn"], 16,
                              39_750_659, True)}
SMLD_CONFIG = "configs/cifar10_ncsnv2.yml"
# A card evaluation against the CPU's on the same weights and input, fp32
# with TF32 off: within this share of the largest output (as EVAL_NET_REL).
SMLD_EVAL_REL = 1e-4
# The train step at the yml's B=128 (timed) and, for the check, at this
# batch on the card and on the CPU (loss rtol TRAIN_RTOL, the gradients
# through Adam's first moment TRAIN_GRAD_REL of each tensor's largest).
SMLD_STEP_CHECK_B = 4
# The Langevin block: the ladder cut to SMLD_LEVELS levels with the yml's
# n_steps_each 5 (SMLD_LEVELS * 5 + 1 evaluations), B=16 on the card, its
# first SMLD_CPU_B rows held to the same chain on the CPU with the same
# draws within SMLD_BLOCK_REL of the largest |x| (the witness of the
# samplers phase, WITNESS_FACTOR times the CPU chain's own spread from an
# init moved by WITNESS_REL, where that is larger).
SMLD_LEVELS = 10
SMLD_CPU_B = 2
SMLD_BLOCK_REL = 5e-3
# The CLI on synthetic CIFAR-10 pickles: --train to 3, then --sample with
# sampling.inpainting and with sampling.interpolation from checkpoint 3;
# the ladder cut to SMLD_LEVELS levels, the batch and the inner steps cut.
SMLD_CLI_MODS = [f"model.num_classes={SMLD_LEVELS}", "training.batch_size=16",
                 "training.checkpoint_freq=3", "training.snapshot_freq=3",
                 "training.val_freq=3", "training.snapshot_sampling=False",
                 "training.log_freq=1", "test.batch_size=16", "sampling.batch_size=4",
                 "sampling.n_steps_each=2", "sampling.n_interpolations=3", "sampling.fid=false"]
SMLD_CIFAR_IMAGES = (64, 32)   # images in each train pickle (5) and in the test pickle
SMLD_FFHQ_IMAGES = 10           # in the synthetic r256 shard: a 9 / 1 split


# Timing repetitions of the kernel phases' device times (the median of this
# many runs of 10 calls; cut from 5 to keep the script inside its time limit
# with the small5 phase).
KERNEL_TIMING_REPS = 3


def kernel_ms(fn):
    """`profile_gn2.device_ms` at KERNEL_TIMING_REPS."""
    from mcvd_tpu_torch.tools.profile_gn2 import device_ms

    return device_ms(fn, reps=KERNEL_TIMING_REPS)


def emit(phase, **payload):
    print(json.dumps({"phase": phase, **payload}), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def bound(nbytes, flops, peak):
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once."""
    from mcvd_tpu_torch.tools.profile_gn2 import HBM_BYTES_PER_S

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_bound(nb, flops, dtype_name):
    """`bound` of an attention kernel: bf16 on the tensor cores; fp32 the
    smaller of the CUDA cores' fp32 rate and 3xTF32 (three TF32 products for
    each fp32 product), the route the fp32 kernels take."""
    if dtype_name == "bfloat16":
        return bound(nb, flops, "bf16")
    return min(bound(nb, flops, "fp32"), bound(nb, 3 * flops, "tf32"))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_launches(launches, want, what):
    """The phase launched exactly `want` of its kernels and none of the rest."""
    full = {k: want.get(k, 0) for k in launches}
    check(launches == full, f"{what} launch counts {launches}, want {full}")


def max_err(got, want, dtype_name, tol=None):
    """(max abs error, within tolerance): |got - want| <= atol + rtol*|want|
    everywhere; atol may be a tensor of want's shape (a bound per element)."""
    atol, rtol = tol or TOL[dtype_name]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    ok = bool((diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def record(summary, kernel, dtype_name, err):
    """Keep the largest error of each kernel, overall and in fp32."""
    s = summary[kernel]
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if dtype_name == "float32":
        s["max_abs_err_fp32"] = max(s["max_abs_err_fp32"], err)


def repo_path(rel):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def ddpm_resblock_config():
    """The flagship with `model.resblock_type: ddpm` (DDPM resblocks, the
    fused FIR up/down convs): no shipped config uses it; the JAX package
    tests it."""
    from mcvd_tpu_torch.config import flagship_config

    config = flagship_config()
    config.model.resblock_type = "ddpm"
    return config


def gn_cases(B):
    """Every GroupNorm shape and form of one evaluation of the flagship, the
    SPADE flagship and the DDPM-resblock flagship, read from the models by
    `tools.gn_calls`, plus frames_last=2: (C, H, frames_last, form,
    num_groups, eps, {model: calls per evaluation})."""
    from collections import Counter, defaultdict

    from mcvd_tpu_torch.config import flagship_config, load_config
    from mcvd_tpu_torch.tools.gn_calls import form, group_norm_calls

    models = {"flagship": flagship_config(), "spade": load_config(repo_path(SPADE_CONFIG)),
              "ddpm_resblock": ddpm_resblock_config()}
    per, groups = defaultdict(Counter), {}
    for name, config in models.items():
        calls = group_norm_calls(config, batch=B)
        check(len(calls) == GN_CALLS[name],
              f"{name}: {len(calls)} GroupNorm calls per evaluation, want {GN_CALLS[name]}")
        for c in calls:
            key = (c["C"], c["H"], form(c), c["eps"])
            per[key][name] += 1
            groups[key] = c["num_groups"]
    cases = [(C, H, 1, f, groups[C, H, f, e], e, dict(per[C, H, f, e]))
             for C, H, f, e in sorted(per)]
    cases.append((64, 32, 2, "adagn_silu", 16, 1e-5, {}))   # frames_last=2: C*N = 128
    return cases


def phase_env():
    from mcvd_tpu_torch.tools.profile_gn2 import nvidia_smi

    card = nvidia_smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), card=card)
    return card


def ptxas_summary(log):
    """Registers, shared memory and spills of each compiled kernel, from
    nvcc's -Xptxas -v output."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = {"entry": line.split("'")[1]}
            out.append(cur)
        elif cur is not None and "spill" in line:
            cur["spill"] = line.strip()
        elif cur is not None and "Used" in line:
            cur["used"] = line.split(":", 1)[1].strip()
    return out


def phase_build():
    import threading

    from mcvd_tpu_torch.data import native
    from mcvd_tpu_torch.ops import _build
    from mcvd_tpu_torch.ops import fused_act as FA

    # the data path's host library (g++) builds beside the kernels (nvcc)
    host, host_s = [], []

    def build_host():
        t = time.perf_counter()
        try:
            native.load_library()
        except Exception as e:  # raised on the main thread below
            host.append(e)
        host_s.append(time.perf_counter() - t)

    th = threading.Thread(target=build_host)
    th.start()
    t0 = time.perf_counter()
    _build.load_library()
    nvcc_s = time.perf_counter() - t0
    th.join()
    if host:
        raise host[0]
    x = torch.randn(2, 8, 8, 64, device="cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        FA.fused_leaky_relu(x, None)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    emit("build", nvcc_s=nvcc_s, nvcc_compile_s=_build.BUILD_SECONDS[0],
         nvcc_source_s=_build.BUILD_SOURCE_SECONDS,
         triton_first_compile_s=triton_s, host_gxx_s=host_s[0],
         ptxas=ptxas_summary(_build.BUILD_LOG[0]))


def host_us(fn, n=100, reps=3):
    """Median host time of enqueueing one fn() call, in us (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def host_us_fresh(fn, t, n=ATTN_HOST_CALLS, reps=3):
    """Median host time of enqueueing one fn(x) call, in us (no sync
    inside), where each call's x has t's shape and strides at an address
    that no call has used (16 bytes past the last one's), so the attention
    kernels encode its tensor maps anew."""
    step = 16 // t.element_size()
    flat = torch.zeros(t.numel() + n * reps * step, dtype=t.dtype, device=t.device)
    xs = [flat[i * step:i * step + t.numel()].view(t.shape) for i in range(n * reps)]
    torch.cuda.synchronize()
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        for x in xs[r * n:(r + 1) * n]:
            fn(x)
        times.append((time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def _dn(dtype):
    return str(dtype).split(".")[-1]


def gn_inputs(g, B, C, H, W, N, fm, dtype, param_dtype):
    """A GroupNorm call's inputs: x (channels_last NCHW, B x C*N x H x W),
    the form's parameters (gamma and beta in `param_dtype`; AdaGN's scale
    and shift as ActNorm passes them, chunks of one (B, 2*C*N) tensor) and
    the leaves a gradient is taken of."""
    affine, adagn, _ = GN_FORMS[fm]
    CN = C * N
    x = (torch.randn(B, H, W, CN, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    x = x.permute(0, 3, 1, 2)
    prm = {"gamma": None, "beta": None, "scale": None, "shift": None}
    leaves = [x]
    if affine:
        prm["gamma"] = (1 + 0.1 * torch.randn(C, generator=g, device="cuda")).to(param_dtype)
        prm["beta"] = (0.1 * torch.randn(C, generator=g, device="cuda")).to(param_dtype)
        leaves = [x, prm["gamma"], prm["beta"]]
    if adagn:
        ss = (0.1 * torch.randn(B, 2 * CN, generator=g, device="cuda")).to(dtype)
        prm["scale"], prm["shift"] = ss.chunk(2, dim=1)
        leaves = [x, ss]
    return x, prm, leaves


def gn_library(fm, N):
    """Whether one PyTorch call (`F.group_norm`) computes the form: the
    plain one, and the affine one of one frame; none does AdaGN or the
    SiLU."""
    return fm == "plain" or (fm == "affine" and N == 1)


def gn_fwd_case(g, B, C, H, W, N, fm, G, eps, dtype, timed=True, compare=False):
    """One GroupNorm call (form `fm`, C channels a frame, N frames) through
    `gn_fused` against its plain version within TOL: its case, with the
    plan. With `timed` its device ms; with `compare` also its host us, the
    plain version's ms and host us, the bound and the one PyTorch call's
    ms (`gn_library`, else None)."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.ops import groupnorm as GN

    dn = _dn(dtype)
    x, prm, _ = gn_inputs(g, B, C, H, W, N, fm, dtype, torch.float32)
    kw = dict(eps=eps, frames_last=N, act=GN_FORMS[fm][2], **prm)
    p = GN.plan(C * N, H, W, dtype, G)
    what = f"group_norm {fm} eps={eps} B={B} C={C} H={H} W={W} N={N} {dn}"
    with torch.inference_mode():
        before = ops.LAUNCHES["gn_fused"]
        got = GN.group_norm(x, G, **kw)
        check(ops.LAUNCHES["gn_fused"] == before + 1, f"{what} launched no gn_fused")
        with ops.reference_ops():
            want = GN.group_norm(x, G, **kw)
        err, ok = max_err(got, want, dn)
        check(ok, f"{what}: max err {err}")
        case = dict(op="group_norm", form=fm, eps=eps, B=B, C=C, H=H, W=W, frames_last=N,
                    dtype=dn, max_abs_err=err, vec=p.vec, cluster=p.cluster,
                    blocks=p.cluster * B, rows_per_block=p.rows, threads=p.threads,
                    smem=p.smem)
        if B <= 65_535:   # the occupancy query takes one launch's batch
            case["max_active_clusters"] = GN.max_active_clusters(x, p, G)
        if timed or compare:
            case["ms"] = kernel_ms(lambda: GN.group_norm(x, G, **kw))
        if compare:
            case["host_us"] = host_us(lambda: GN.group_norm(x, G, **kw))
            with ops.reference_ops():
                case["plain_ms"] = kernel_ms(lambda: GN.group_norm(x, G, **kw))
                case["plain_host_us"] = host_us(lambda: GN.group_norm(x, G, **kw))
            case["bound_ms"], case["bound_by"] = bound(2 * nbytes(x), 8 * x.numel(), "fp32")
            case["library_ms"] = None
            if gn_library(fm, N):
                w, b = (None, None) if fm == "plain" else (prm["gamma"].to(dtype),
                                                           prm["beta"].to(dtype))
                case["library_ms"] = kernel_ms(lambda: F.group_norm(x, G, w, b, eps))
    return case


def gn_bwd_case(g, B, C, H, W, N, fm, G, eps, dtype, timed=True, compare=False, cold=False):
    """One GroupNorm call's backward through `gn_fused_bwd` (after `gn_fused`)
    against the plain backward within `grad_err`, through autograd and on
    both routes (cluster, split) alone from the forward's statistics, each
    the same bits over two calls: its case. With `timed` its device ms;
    with `cold` also with L2 flushed before each call; with `compare` the
    plain backward's ms, the bound and autograd of the one PyTorch call's
    (`gn_library`, else None)."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.ops import groupnorm as GN
    from mcvd_tpu_torch.tools.profile_gn_bwd import cold_ms

    dn = _dn(dtype)
    affine, adagn, act = GN_FORMS[fm]
    CN = C * N
    # the parameters in the compute dtype, as the bf16 step casts them
    x, prm, leaves = gn_inputs(g, B, C, H, W, N, fm, dtype, dtype)
    dy = torch.randn(B, H, W, CN, generator=g, device="cuda").to(dtype).permute(0, 3, 1, 2)
    for t in leaves:
        t.requires_grad_()
    if adagn:   # the chunks again, now of the leaf
        prm["scale"], prm["shift"] = leaves[1].chunk(2, dim=1)
    kw = dict(eps=eps, frames_last=N, act=act, **prm)
    what = f"gn_fused_bwd {fm} eps={eps} B={B} C={C} H={H} W={W} N={N} {dn}"
    before = dict(ops.LAUNCHES)
    got = torch.autograd.grad(GN.group_norm(x, G, **kw), leaves, dy)
    check(ops.LAUNCHES["gn_fused"] == before["gn_fused"] + 1 and
          ops.LAUNCHES["gn_fused_bwd"] == before["gn_fused_bwd"] + 1,
          f"{what}: group_norm's backward did not run gn_fused then gn_fused_bwd")
    with ops.reference_ops():
        want = torch.autograd.grad(GN.group_norm(x, G, **kw), leaves, dy)
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        e, ok = grad_err(a, b, dn)
        check(ok, f"{what} input {i}: max err {e}")
        err = max(err, e)
    xd = x.detach()
    pd = {k: None if v is None else v.detach() for k, v in prm.items()}
    _, stats = GN.group_norm_fwd(xd, G, eps, pd["gamma"], pd["beta"], pd["scale"],
                                 pd["shift"], N, act, want_stats=True)
    args = (xd, dy, stats, G, pd["gamma"], pd["beta"], pd["scale"], pd["shift"], N, act)
    picked = GN.bwd_plan(B, CN, H, W, dtype, G, N, affine)
    for p in {picked, *GN.bwd_plans(B, CN, H, W, dtype, G, N)}:
        route = "split" if p.split else "cluster"
        once = GN.group_norm_bwd(*args, p=p)
        check(all(torch.equal(a, b) for a, b in zip(once, GN.group_norm_bwd(*args, p=p))
                  if a is not None), f"{what} {route}: two calls differ")
        mine = [once[0]] + ([torch.cat(once[3:], dim=1)] if adagn else list(once[1:3]))
        for i, (a, b) in enumerate(zip(mine, want)):
            e, ok = grad_err(a, b, dn)
            check(ok, f"{what} {route} input {i}: max err {e}")
            err = max(err, e)
    case = dict(op="group_norm_bwd", form=fm, eps=eps, B=B, C=C, H=H, W=W, frames_last=N,
                dtype=dn, max_abs_err=err, vec=picked.vec,
                route="split" if picked.split else "cluster",
                launches_per_call=2 if picked.split or affine else 1)
    if timed or compare:
        case["ms"] = kernel_ms(lambda: GN.group_norm_bwd(*args))
    if cold:
        case["cold_ms"] = cold_ms(lambda: GN.group_norm_bwd(*args))
    if compare:
        case["plain_ms"] = kernel_ms(lambda: GN.group_norm_bwd_reference(
            xd, dy, G, eps=eps, frames_last=N, act=act, **pd))
        case["bound_ms"], case["bound_by"] = bound(3 * nbytes(x), 12 * x.numel(), "fp32")
        case["library_ms"] = None
        if gn_library(fm, N):   # autograd of F.group_norm
            xl = xd.clone().requires_grad_()
            lib_leaves = [xl]
            if fm == "affine":
                wl, bl = (pd[k].clone().requires_grad_() for k in ("gamma", "beta"))
                lib_leaves += [wl, bl]
                yl = F.group_norm(xl, G, wl, bl, eps)
            else:
                yl = F.group_norm(xl, G, eps=eps)
            case["library_ms"] = kernel_ms(lambda: torch.autograd.grad(
                yl, lib_leaves, dy, retain_graph=True))
    return case


def attn_fwd_case(g, B, T, h, d, dtype, timed=True):
    """One attention call (packed (B, T, 3C) qkv, C = h*d) through
    `attention_fwd` against its plain version: fp32 within TOL, bf16 per
    element within `bf16_tolerances`' "plain" bound and, tighter, of its
    emulation (`attention_tc_emulation`) within "emulation" (with whether
    the old "emulation_no_flip" bound also held): its case. With `timed`
    its device ms beside the plain version's, SDPA's and the bound, the
    host us of enqueue a call on the same qkv (`host_us`) and on a new qkv
    each call (`host_us_new_maps`: the wgmma route encodes its tensor maps),
    and the share of idle query rows of the 64-row tiles. The case records
    its route (`attention_route`) and plan (`attn_plan`)."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.ops import attention as A

    dn = _dn(dtype)
    C, scale = h * d, d ** -0.5
    what = f"attention B={B} T={T} h={h} D={d} {dn}"
    qkv = torch.randn(B, T, 3 * C, generator=g, device="cuda").to(dtype)
    with torch.inference_mode():
        before = ops.LAUNCHES["attention_fwd"]
        got = A.attention_packed(qkv, h, scale)
        check(ops.LAUNCHES["attention_fwd"] == before + 1, f"{what} launched no attention_fwd")
        with ops.reference_ops():
            want = A.attention_packed(qkv, h, scale)
        tols = A.bf16_tolerances(qkv, h, scale) if dn == "bfloat16" else {"plain": TOL[dn]}
        tol = tols["plain"]
        err, ok = max_err(got, want, dn, tol)
        check(ok, f"{what}: max err {err}")
        q, k, v = (packed_heads(t, B, T, h, d).contiguous() for t in qkv.split(C, dim=-1))
        route = A.attention_route(dtype, d)
        case = dict(op="attention", B=B, T=T, heads=h, head_dim=d, dtype=dn, route=route,
                    path=ATTN_PATH[route, dn], plan=attn_plan(dtype, B, T, h, d),
                    max_abs_err=err, max_atol=float(torch.as_tensor(tol[0]).max()),
                    rtol=tol[1])
        if dn == "bfloat16":   # the kernel's own arithmetic in plain torch
            emu = A.attention_tc_emulation(q, k, v, scale)
            emu = emu.reshape(B, h, T, d).transpose(1, 2).reshape(B, T, C)
            e_err, e_ok = max_err(got, emu, dn, tols["emulation"])
            check(e_ok, f"{what} vs its emulation: max err {e_err}")
            case.update(emulation_err=e_err,
                        emulation_max_atol=float(tols["emulation"][0].max()),
                        emulation_rtol=tols["emulation"][1],
                        no_flip_ok=max_err(got, emu, dn, tols["emulation_no_flip"])[1],
                        flip_share=float((tols["emulation"][0] >
                                          tols["emulation_no_flip"][0]).float().mean()))
        if timed:
            case["ms"] = kernel_ms(lambda: A.attention_packed(qkv, h, scale))
            case["host_us"] = host_us(lambda: A.attention_packed(qkv, h, scale),
                                      n=ATTN_HOST_CALLS)
            case["host_us_new_maps"] = host_us_fresh(
                lambda x: A.attention_packed(x, h, scale), qkv)
            case["plain_ms"] = kernel_ms(lambda: A.attention_packed_reference(qkv, h, scale))
            q4, k4, v4 = (t.view(B, h, T, d) for t in (q, k, v))   # the one PyTorch call
            case["library_ms"] = kernel_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
            flops = 4 * B * h * T * T * d
            case["bound_ms"], case["bound_by"] = attn_bound(nbytes(qkv) * 4 // 3, flops, dn)
            case["tflops"] = flops / case["ms"] / 1e9
            case["idle_rows_share"] = 1 - B * h * T / (64 * case["plan"]["tiles"])
    return case


def attn_bwd_case(g, B, T, h, d, dtype, timed=True):
    """One attention call's backward through `attention_bwd` (after
    `attention_fwd`) against the plain VJP: each gradient within
    ATTN_BWD_REL of its largest; the kernel alone, from the forward's output
    and logsumexp, the same bits over two calls and in bf16 per element
    within `bf16_bwd_tolerances`' "plain" bound and of its emulation
    (`attention_bwd_tc_emulation`) within "emulation" (with whether the old
    "emulation_no_flip" bound also held): its case, with its route. With
    `timed` its device ms beside the plain VJP's, SDPA's autograd and the
    bound, and the host us of enqueue a call on the same tensors and with a
    new qkv each call (`host_us_new_maps`: the maps of q, k and v encoded
    anew)."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.ops import attention as A

    dn = _dn(dtype)
    C, scale = h * d, d ** -0.5
    what = f"attention_bwd B={B} T={T} h={h} D={d} {dn}"
    qkv = torch.randn(B, T, 3 * C, generator=g, device="cuda").to(dtype).requires_grad_()
    dy = torch.randn(B, T, C, generator=g, device="cuda").to(dtype)
    before = dict(ops.LAUNCHES)
    got, = torch.autograd.grad(A.attention_packed(qkv, h, scale), [qkv], dy)
    check(ops.LAUNCHES["attention_fwd"] == before["attention_fwd"] + 1 and
          ops.LAUNCHES["attention_bwd"] == before["attention_bwd"] + 1,
          f"{what}: attention_packed's backward did not run attention_bwd")
    with ops.reference_ops():
        want, = torch.autograd.grad(A.attention_packed(qkv, h, scale), [qkv], dy)
    rel = ATTN_BWD_REL[dn]
    err = 0.0
    for i, part in enumerate("qkv"):
        a, b = (t[..., i * C:(i + 1) * C].float() for t in (got, want))
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite gradient")
        e = float((a - b).abs().max())
        check(e <= rel * float(b.abs().max()), f"{what} d{part}: max err {e}")
        err = max(err, e)
    route = A.attention_route(dtype, d)
    plan = attn_plan(dtype, B, T, h, d)
    packed = plan["form"] == "packed"
    case = dict(op="attention_bwd", B=B, T=T, heads=h, head_dim=d, dtype=dn, route=route,
                path=ATTN_PATH[route, dn] + (" (one launch)" if packed else
                                             " (dq, then dk and dv)"),
                plan=plan, max_abs_err=err, rel_tol=rel, launches_per_call=1 if packed else 2)
    qd = qkv.detach()
    o, lse = A.attention_packed_fwd(qd, h, scale, True)
    once = A.attention_packed_bwd(qd, o, lse, dy, h, scale)
    check(torch.equal(once, A.attention_packed_bwd(qd, o, lse, dy, h, scale)),
          f"{what}: two calls differ")
    case["deterministic"] = True
    if dn == "bfloat16":
        lse_h = lse.reshape(B * h, T)
        tols = A.bf16_bwd_tolerances(qd, dy, h, scale, o=o, lse=lse_h)
        p_err, p_ok = max_err(once, want, dn, tols["plain"])
        check(p_ok, f"{what} per element: max err {p_err}")
        heads = [packed_heads(t, B, T, h, d) for t in (*qd.split(C, dim=-1), dy, o)]
        emu = A.attention_bwd_tc_emulation(*heads[:4], scale, o=heads[4], lse=lse_h)
        emu = torch.cat([t.reshape(B, h, T, d).transpose(1, 2).reshape(B, T, C)
                         for t in emu], dim=-1)
        e_err, e_ok = max_err(once, emu, dn, tols["emulation"])
        check(e_ok, f"{what} vs its emulation: max err {e_err}")
        case.update(per_element_err=p_err, max_atol=float(tols["plain"][0].max()),
                    emulation_err=e_err,
                    emulation_max_atol=float(tols["emulation"][0].max()),
                    no_flip_ok=max_err(once, emu, dn, tols["emulation_no_flip"])[1],
                    flip_share=float((tols["emulation"][0] >
                                      tols["emulation_no_flip"][0]).float().mean()))
    if timed:
        case["ms"] = kernel_ms(lambda: A.attention_packed_bwd(qd, o, lse, dy, h, scale))
        case["host_us"] = host_us(lambda: A.attention_packed_bwd(qd, o, lse, dy, h, scale),
                                  n=ATTN_HOST_CALLS)
        case["host_us_new_maps"] = host_us_fresh(
            lambda x: A.attention_packed_bwd(x, o, lse, dy, h, scale), qd)
        case["plain_ms"] = kernel_ms(lambda: A.attention_packed_bwd_reference(qd, dy, h, scale))
        q4, k4, v4 = (t.reshape(B, T, h, d).transpose(1, 2).contiguous().requires_grad_()
                      for t in qd.split(C, dim=-1))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        dy4 = dy.reshape(B, T, h, d).transpose(1, 2)
        case["library_ms"] = kernel_ms(lambda: torch.autograd.grad(
            o4, [q4, k4, v4], dy4, retain_graph=True))
        flops = 10 * B * h * T * T * d   # 5 products of 2*T*T*d per (b, head)
        case["bound_ms"], case["bound_by"] = attn_bound(
            2 * nbytes(qd) + 2 * nbytes(o) + nbytes(lse), flops, dn)
        case["tflops"] = flops / case["ms"] / 1e9
        case["idle_rows_share"] = 1 - B * h * T / (64 * plan["tiles"])
    return case


def attn_plan(dtype, B, T, h, d):
    """The plan of an attention call (`ops.attention.attention_plan`: tiled or
    packed, sequences a tile, tiles), held to the one the built library takes
    (`kernel_plan`)."""
    from mcvd_tpu_torch.ops import attention as A

    plan = A.attention_plan(dtype, d, T, B, h)
    kplan = A.kernel_plan(d, T, B, h)
    check(plan == kplan, f"attention B={B} T={T} h={h} D={d}: plan {plan}, the library's {kplan}")
    return plan._asdict()


def packed_heads(t, B, T, h, d):
    """(B, T, h*d) -> (B*h, T, d)."""
    return t.reshape(B, T, h, d).transpose(1, 2).reshape(B * h, T, d)


def phase_kernels(card):
    from mcvd_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    B = 16
    cases = []
    summary = {k: {"max_abs_err": 0.0, "max_abs_err_fp32": 0.0} for k in ops.LAUNCHES}

    # every GroupNorm shape and form of one evaluation of the three models,
    # read from the models; plus frames_last=2
    gn_eval = {m: {"ms": 0.0, "plain_ms": 0.0, "host_us": 0.0, "plain_host_us": 0.0}
               for m in GN_CALLS}
    for dtype in (torch.float32, torch.bfloat16):
        dn = _dn(dtype)
        for C, H, N, fm, G, eps, per_eval in gn_cases(B):
            full = dn == "bfloat16" or (C, H) == (192, 64)
            case = gn_fwd_case(g, B, C, H, H, N, fm, G, eps, dtype, compare=full)
            case["calls_per_eval"] = per_eval
            record(summary, "gn_fused", dn, case["max_abs_err"])
            if dn == "bfloat16":
                for m, n in per_eval.items():
                    for k in gn_eval[m]:
                        gn_eval[m][k] += n * case[k]
            cases.append(case)
    for dtype in (torch.float32, torch.bfloat16):
        for T, h, d in ATTN_CASES:   # every case but the ragged T is timed
            case = attn_fwd_case(g, B, T, h, d, dtype, timed=T != 100)
            check(case["route"] == "wgmma", f"attention T={T} D={d}: route {case['route']}")
            record(summary, "attention_fwd", case["dtype"], case["max_abs_err"])
            cases.append(case)
    torch.cuda.synchronize()
    emit("kernels", card=card, cases=cases, gn_per_eval_bf16_by_model=gn_eval)
    return cases, summary


def phase_profile_gn2(card, summary):
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.tools.profile_gn2 import device_ms
    from mcvd_tpu_torch.ops import fused_act as FA
    from mcvd_tpu_torch.ops import groupnorm as GN
    from mcvd_tpu_torch.tools import profile_gn2 as P

    dev = "cuda"
    G = 32
    x64, x128, prm = P.inputs(dev, seed=1)
    v64, v128 = x64.permute(0, 3, 1, 2), x128.permute(0, 3, 1, 2)
    g = torch.Generator(device=dev).manual_seed(4)
    act_x = torch.randn(16, 64, 64, 64, generator=g, device=dev).permute(0, 3, 1, 2)
    act_b = torch.randn(64, generator=g, device=dev)
    cases, timing = [], {}

    def vs_plain(fn):
        got = fn()
        with ops.reference_ops():
            want = fn()
        return got, want

    with torch.inference_mode():
        # 1. each kernel against its plain version at the tool's shapes
        for x in (x64, x128):
            got, want = vs_plain(lambda: P.make_copy(x.shape)(x))
            check(torch.equal(got, want) and torch.equal(got, x),
                  f"gn_copy {tuple(x.shape)} is not exact")
            record(summary, "gn_copy", "bfloat16", 0.0)
            cases.append(dict(op="gn_copy", shape=list(x.shape), dtype="bfloat16",
                              max_abs_err=0.0))
        variants = [("baseline", v64, 64, {}), ("parallel", v64, 64, dict(parallel=True)),
                    ("hsplit4", v64, 64, dict(hsplit=4, parallel=True)),
                    ("stats_bf16", v64, 64, dict(stats_bf16=True, parallel=True)),
                    ("lane_full", v128, 128, {})]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for label, v, c, kw in variants:
                xv = v.to(dtype)
                got, want = vs_plain(lambda: P.gn_variant(xv, G, *prm[c], **kw))
                err, ok = max_err(got, want, dn, STATS_BF16_TOL if "stats_bf16" in kw else None)
                check(ok, f"gn_variant {label} {dn}: max err {err}")
                record(summary, "gn_variant", dn, err)
                case = dict(op="gn_variant", variant=label, shape=list(v.shape), dtype=dn,
                            max_abs_err=err)
                if "hsplit" not in kw:
                    # 2. the one-launch variant is the port's GroupNorm
                    gamma, beta, scale, shift = prm[c]
                    ref = GN.group_norm(xv, G, eps=P.EPS, gamma=gamma, beta=beta,
                                        scale=scale, shift=shift, act=True)
                    gerr, gok = max_err(got, ref, dn,
                                        STATS_BF16_TOL if "stats_bf16" in kw else None)
                    check(gok, f"gn_variant {label} {dn} vs group_norm: max err {gerr}")
                    case["vs_group_norm_err"] = gerr
                cases.append(case)
            xa = act_x.to(dtype)
            for b in (act_b, None):
                got, want = vs_plain(lambda: FA.fused_leaky_relu(xa, b, dim=1))
                err, ok = max_err(got, want, dn, ACT_TOL[dn])
                check(ok, f"fused_leaky_relu {dn} bias={b is not None}: max err {err}")
                record(summary, "fused_leaky_relu", dn, err)
                cases.append(dict(op="fused_leaky_relu", shape=list(xa.shape), dtype=dn,
                                  bias=b is not None, max_abs_err=err))

        # the kernels' times at the tool's bf16 shapes, beside plain and library
        xa = act_x.to(torch.bfloat16)
        timing["gn_copy"] = dict(
            ms=device_ms(lambda: P.gn_copy(x64)),
            plain_ms=device_ms(lambda: P.copy_reference(x64)),
            library_ms=device_ms(lambda: torch.mul(x64, 1.0000001)),
            bound=bound(2 * nbytes(x64), x64.numel(), "fp32"))
        timing["gn_variant"] = dict(
            ms=device_ms(lambda: P.gn_variant(v64, G, *prm[64])),
            plain_ms=device_ms(lambda: P.gn_variant_reference(v64, G, *prm[64])),
            library_ms=None,   # no one PyTorch call does GroupNorm + AdaGN + SiLU
            bound=bound(2 * nbytes(v64) + nbytes(*prm[64]), 13 * v64.numel(), "fp32"))
        timing["fused_leaky_relu"] = dict(
            ms=device_ms(lambda: FA.fused_leaky_relu(xa, act_b, dim=1)),
            plain_ms=device_ms(lambda: FA.fused_leaky_relu_reference(xa, act_b, dim=1)),
            library_ms=None,   # no one PyTorch call does bias + LeakyReLU + scale
            bound=bound(2 * nbytes(xa) + nbytes(act_b), 3 * xa.numel(), "fp32"))

    # 3. the slice's own paths: the tool's run, then the op at a main-path
    # activation (B=16, C=64, 64x64, bf16, channels_last)
    torch.cuda.synchronize()
    ops.reset_launches()
    lines = P.measure(dev)
    with torch.inference_mode():
        y = FA.fused_leaky_relu(xa, act_b, dim=1)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(bool(torch.isfinite(y.float()).all()), "fused_leaky_relu output not finite")
    for k in ("gn_copy", "gn_variant", "fused_leaky_relu", "gn_fused"):
        check(launches[k] > 0, f"profile_gn2 launched no {k}: {launches}")
    check(launches["attention_fwd"] == 0, f"profile_gn2 launched attention: {launches}")
    for line in lines:
        check(line["ms"] > 0 and line["host_us"] > 0, f"profile_gn2 line {line}")
    emit("profile_gn2", card=card, device=torch.cuda.get_device_name(0),
         hbm_spec_gb_per_s=P.HBM_BYTES_PER_S / 1e9, cases=cases, lines=lines,
         launches=launches)
    return timing, launches


def model_calls(config, B):
    """(GroupNorm calls, attention calls) of one evaluation of `config`'s
    model, read from the model (`tools.gn_calls`)."""
    from mcvd_tpu_torch.tools import gn_calls

    return tuple(len(c) for c in gn_calls.model_calls(config, B))


def block_vs_plain(config, seed, B, evals, what, per_eval=False, witness=False):
    """One fp32 sampler block of `config` (its `model.version`, subsample and
    gamma) on `_slice_model` weights, through the kernels and under
    `ops.reference_ops()`, with the same weights (passed to the sampler per
    call) and draws, and the launch counts of `evals` network evaluations
    exactly. The two outputs agree within SLICE_ATOL. With `per_eval` the
    sampler is run once more with each evaluation of the kernels' chain held
    to the plain network on the same input (within TRAIN_GRAD_REL of its
    largest output). With `witness` the end is held to the plain chain's
    own sensitivity instead of SLICE_ATOL: the plain block again from init
    moved by WITNESS_REL of its largest value must end at least 1 /
    WITNESS_FACTOR as far from the plain block as the kernels' block does
    (PERF.md §6). Returns the payload."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.diffusion import make_schedule, samplers, subsample_schedule
    from mcvd_tpu_torch.eval import make_block_sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _slice_model(config, seed)
    n_params = sum(p.numel() for p in model.parameters())
    sched = make_schedule(config)
    block = make_block_sampler(config, model, sched)
    d = config.data
    sz, cf = d.image_size, d.channels * d.num_frames
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    cond = torch.rand(B, sz, sz, d.channels * d.num_frames_cond, generator=g,
                      device="cuda") * 2 - 1
    init = torch.randn(B, sz, sz, cf, generator=g, device="cuda")
    steps, _, _, _, k_cum, _ = subsample_schedule(sched, config.sampling.subsample)
    if getattr(config.model, "gamma", False):   # Gamma(k_i, 1) per step
        conc = torch.as_tensor(k_cum, device="cuda").view(-1, 1, 1, 1, 1)
        step_noise = torch._standard_gamma(conc.expand(len(steps), B, sz, sz, cf)
                                           .contiguous(), generator=g)
    else:
        step_noise = torch.randn(len(steps), B, sz, sz, cf, generator=g, device="cuda")
    with torch.inference_mode():
        eps = model(init.permute(0, 3, 1, 2), torch.zeros(B, dtype=torch.long, device="cuda"),
                    cond.permute(0, 3, 1, 2))
    eps_std = float(eps.float().std())
    check(eps_std > 0.05, f"{what}: eps std {eps_std}: the network output is degenerate")
    params = dict(model.named_parameters())
    n_gn, n_attn = model_calls(config, B)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got = block(params, init, cond, step_noise=step_noise)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check_launches(launches, {"gn_fused": n_gn * evals, "attention_fwd": n_attn * evals},
                   f"{what} ({evals} evaluations)")
    with ops.reference_ops():
        want = block(params, init, cond, step_noise=step_noise)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and got.shape == (B, sz, sz, cf),
          f"{what} output {tuple(got.shape)} not finite")
    out = dict(B=B, version=config.model.version, steps=len(steps),
               gamma=bool(getattr(config.model, "gamma", False)), evals=evals,
               dtype="float32", params=n_params, eps_std=eps_std, max_abs_diff=diff,
               out_range=[float(got.min()), float(got.max())], wall_s=wall_s,
               launches=launches)
    if witness:
        delta = torch.randn(init.shape, generator=g, device="cuda")
        delta *= WITNESS_REL * float(init.abs().max()) / float(delta.abs().max())
        with ops.reference_ops():
            moved = block(params, init + delta, cond, step_noise=step_noise)
        far = float((moved - want).abs().max())
        check(diff <= WITNESS_FACTOR * far,
              f"{what} kernels vs plain max abs diff {diff} > {WITNESS_FACTOR} x the plain "
              f"chain's own spread {far} from an init moved by {WITNESS_REL} of its largest")
        out.update(witness_rel=WITNESS_REL, witness_max_abs_diff=far,
                   witness_factor=WITNESS_FACTOR)
    else:
        check(diff <= SLICE_ATOL, f"{what} kernels vs plain max abs diff {diff} > {SLICE_ATOL}")
        out.update(atol=SLICE_ATOL)
    if not per_eval:
        return out
    cond_c = cond.permute(0, 3, 1, 2)
    errs = []

    def eps_fn(x, labels):   # the kernels' evaluation, held to the plain one
        x_c = x.permute(0, 3, 1, 2)
        e = model(x_c, labels, cond_c)
        with ops.reference_ops():
            e_ref = model(x_c, labels, cond_c)
        errs.append(float((e - e_ref).abs().max()) / float(e_ref.abs().max()))
        return e.permute(0, 2, 3, 1)

    sampling = config.sampling
    model.eval()
    with torch.inference_mode():
        chain = samplers.get_sampler(config.model.version)(
            init, eps_fn, sched, subsample_steps=sampling.subsample,
            denoise=getattr(sampling, "denoise", True),
            clip_before=getattr(sampling, "clip_before", True),
            gamma=bool(getattr(config.model, "gamma", False)), step_noise=step_noise)[-1]
    check(len(errs) == evals, f"{what}: {len(errs)} evaluations, want {evals}")
    check(max(errs) <= TRAIN_GRAD_REL, f"{what}: an evaluation of the chain is off its plain "
                                       f"version by {max(errs)} of its largest output")
    return dict(out, per_eval_rel_err=max(errs), per_eval_rel_tol=TRAIN_GRAD_REL,
                rerun_max_abs_diff=float((chain - got).abs().max()))


def phase_slice(card):
    from mcvd_tpu_torch.config import flagship_config

    config = flagship_config()
    config.sampling.subsample = 10
    out = block_vs_plain(config, 0, 4, 11, "slice")
    check(out["params"] == FLAGSHIP_PARAM_COUNT,
          f"{out['params']} params, JAX has {FLAGSHIP_PARAM_COUNT}")
    emit("slice", card=card, denoise=True, **out)


def headline(config, n_timed):
    """The bench protocol on `config`'s model (random weights from a seed):
    B=16, 100-step DDPM + denoise, 16 frames of 64x64 predicted in 4 blocks
    on the cond frames, bf16 score network; one warm-up and `n_timed` timed
    requests with exact launch counts. Returns the payload."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.eval import autoregressive_predict, make_block_sampler
    from mcvd_tpu_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.sampling.compute_dtype = "bfloat16"
    B, n_pred = 16, 16
    config.sampling.subsample = 100
    config.sampling.num_frames_pred = n_pred
    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
    sched = make_schedule(config)
    block = make_block_sampler(config, model, sched)
    params = dict(model.named_parameters())
    d = config.data
    sz, F = d.image_size, d.num_frames
    n_blocks = ceil(n_pred / F)
    evals = n_blocks * (config.sampling.subsample + 1)
    n_gn, n_attn = model_calls(config, B)
    g = torch.Generator(device="cuda").manual_seed(3)
    cond = torch.randn(B, sz, sz, d.channels * d.num_frames_cond, generator=g, device="cuda")

    def request():
        ops.reset_launches()
        t0 = time.perf_counter()
        out = autoregressive_predict(config, block, params, cond, None, n_pred, 0, sched,
                                     generator=g)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(ops.LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    _, warm_s, _ = request()
    want = {"gn_fused": n_gn * evals, "attention_fwd": n_attn * evals}
    times, launches = [], None
    for _ in range(n_timed):
        out, dt, launches = request()
        check_launches(launches, want, "request")
        check(out.shape == (B, sz, sz, n_pred * d.channels) and bool(torch.isfinite(out).all()),
              f"headline output {tuple(out.shape)} not finite")
        times.append(dt)
    fps = B * n_pred / statistics.mean(times)
    return dict(B=B, steps=config.sampling.subsample, denoise=True, frames_pred=n_pred,
                blocks=n_blocks, evals_per_request=evals, dtype="bfloat16", warmup_s=warm_s,
                request_s=times, frames_per_s=fps,
                ms_per_eval=1000 * statistics.mean(times) / evals,
                launches_per_eval={k: v / evals for k, v in launches.items() if v},
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)


def phase_headline(card):
    from mcvd_tpu_torch.config import flagship_config

    out = headline(flagship_config(), n_timed=2)
    emit("headline", card=card, **out)
    return out["launches"]


def phase_spade(card):
    """configs/smmnist_DDPM_big5_spade.yml at full width (random weights from
    a seed): one fp32 sampler block with kernels on and off, the bf16
    headline protocol (one timed request after the warm-up), and one B=64
    fp32 training step with kernels on and off, then 3 timed fp32 steps at
    B=64. Launch counts exact (67 GroupNorm
    and 10 attention calls an evaluation, read from the model)."""
    from mcvd_tpu_torch.config import load_config

    def config():
        return load_config(repo_path(SPADE_CONFIG))

    n_gn, n_attn = model_calls(config(), 16)
    check((n_gn, n_attn) == (GN_CALLS["spade"], 10), f"spade: {n_gn} GroupNorm and "
                                                      f"{n_attn} attention calls an evaluation")
    c = config()
    c.sampling.subsample = 10
    block = block_vs_plain(c, 30, 4, 11, "spade block")
    check(block["params"] == SPADE_PARAM_COUNT,
          f"spade: {block['params']} params, JAX has {SPADE_PARAM_COUNT}")
    torch.cuda.empty_cache()
    request = headline(config(), n_timed=1)
    torch.cuda.empty_cache()
    step_launches = {"gn_fused": n_gn, "gn_fused_bwd": n_gn, "attention_fwd": n_attn,
                     "attention_bwd": n_attn}
    step = train_step_vs_plain(config(), 31, 64, step_launches, "spade")
    torch.cuda.empty_cache()
    timed_steps = train_steps(config(), "float32", 3, step_launches)
    emit("spade", card=card, config=SPADE_CONFIG, params=block["params"], block=block,
         headline=request, train_step=step, train_steps_fp32=timed_steps)
    torch.cuda.empty_cache()


def phase_samplers(card):
    """The flagship fp32 block (B=4, subsample 50, cut from 100 to keep the
    script inside its time limit) under DDIM (51 evaluations),
    F-PNDM (59) and DDPM with gamma noise (51, Gamma draws fed to both
    runs): kernels on and off, each evaluation of the chain held to the
    plain network (`block_vs_plain` with per_eval), launch counts exact; the
    ends within SLICE_ATOL, DDIM's within its plain chain's own spread (the
    witness)."""
    from mcvd_tpu_torch.config import flagship_config

    out = {}
    for name, version, gamma, evals in (("ddim", "DDIM", False, 51),
                                        ("fpndm", "FPNDM", False, 59),
                                        ("ddpm_gamma", "DDPM", True, 51)):
        config = flagship_config()
        config.model.version = version
        config.model.gamma = gamma
        config.sampling.subsample = 50
        out[name] = block_vs_plain(config, 40, 4, evals, f"samplers {name}", per_eval=True,
                                   witness=version == "DDIM")
    emit("samplers", card=card, **out)


def grad_err(got, want, dtype_name):
    """(max abs error, within tolerance) of a gradient against the plain
    backward's: fp32 1e-4 of the larger of 1 and its largest entry (the sums
    run in another order, over up to B*H*W terms); bf16 that plus two bf16
    steps per element (both round one fp32 value)."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "non-finite gradient")
    diff = (got - want).abs()
    atol = 1e-4 * max(1.0, float(want.abs().max()))
    rtol = 0.0 if dtype_name == "float32" else 1.6e-2
    return float(diff.max()), bool((diff <= atol + rtol * want.abs()).all())


def phase_train_kernels(card, summary):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    B = 16
    cases = []
    # device ms of one step's GroupNorm backwards, by model and dtype
    gn_step = {m: {"float32": 0.0, "bfloat16": 0.0} for m in GN_CALLS}
    for dtype in (torch.float32, torch.bfloat16):
        dn = _dn(dtype)
        for C, H, N, fm, G, eps, per_step in gn_cases(B):
            big = (C, H) == (192, 64)
            case = gn_bwd_case(g, B, C, H, H, N, fm, G, eps, dtype,
                               compare=dn == "bfloat16" or big, cold=big)
            case["calls_per_step"] = per_step
            record(summary, "gn_fused_bwd", dn, case["max_abs_err"])
            for m, n in per_step.items():
                gn_step[m][dn] += n * case["ms"]
            cases.append(case)
    for dtype in (torch.float32, torch.bfloat16):
        for T, h, d in ATTN_CASES:   # every case but the ragged T is timed
            case = attn_bwd_case(g, B, T, h, d, dtype, timed=T != 100)
            check(case["route"] == "wgmma", f"attention_bwd T={T} D={d}: route {case['route']}")
            record(summary, "attention_bwd", case["dtype"], case["max_abs_err"])
            cases.append(case)
    torch.cuda.synchronize()
    emit("train_kernels", card=card, cases=cases, gn_bwd_ms_per_step_at_B16_by_model=gn_step)
    return cases


def _slice_model(config, seed):
    """The flagship with its zero-scale layers redrawn at scale 1 (else the
    network's output and most gradients are ~0 and hide the kernels)."""
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.models.layers import init_weights

    model = get_model(config, generator=torch.Generator().manual_seed(seed), device="cuda")
    for m in model.modules():
        if getattr(m, "init_scale", None) == 0.0:
            m.init_scale = 1.0
    init_weights(model, torch.Generator().manual_seed(seed + 1))
    return model


def train_step_vs_plain(config, seed, B, want_launches, what, model=None, exact_zero=()):
    """One fp32 training step of `config`'s model (zero-scale layers redrawn,
    dropout 0, warmup 0) through the kernels and under `ops.reference_ops()`
    from the same weights and draws: loss, grad_norm, every gradient
    (through Adam's first moment), the updated parameters and the EMA held
    to the train tolerances, and the kernels' exact launch counts. `model` is
    `_slice_model(config, seed)` built by the caller with dropout 0, else it
    is built here. The parameters named in `exact_zero` have a gradient that
    is zero in exact arithmetic (`exact_zero_grads`): both sides' moments
    are held to its rounding noise, the floor, and the parameter to Adam's
    own bound, 2*lr (the noise's sign sets the update's). Returns the
    phase's payload."""
    import contextlib

    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.model.dropout = 0.0
    config.optim.warmup = 0   # with warmup the first update is exactly zero
    lr = config.optim.lr
    model = model if model is not None else _slice_model(config, seed)
    n_params = sum(p.numel() for p in model.parameters())
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    sched = make_schedule(config)
    d = config.data
    sz = d.image_size
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    X = torch.rand(B, d.num_frames_cond + d.num_frames, sz, sz, d.channels, generator=g,
                   device="cuda")
    levels = len(sched.sigmas if sched.alphas is None else sched.alphas)
    draws = {"labels": torch.randint(0, levels, (B,), generator=g, device="cuda"),
             "z": torch.randn(B, sz, sz, d.channels * d.num_frames, generator=g,
                              device="cuda").permute(0, 3, 1, 2)}

    def run(reference):
        model.load_state_dict(weights)
        state = create_train_state(config, model, device="cuda")
        step = make_train_step(model, sched, config)
        torch.cuda.synchronize()
        ops.reset_launches()
        with ops.reference_ops() if reference else contextlib.nullcontext():
            state, m = step(state, X, draws=draws)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        snap = {k: {n: t.detach().clone() for n, t in d.items()} for k, d in
                (("params", state.params), ("ema", state.ema_params),
                 ("mu", state.opt_state["mu"]), ("nu", state.opt_state["nu"]))}
        return snap, {k: float(v) for k, v in m.items()}, launches

    got, mk, launches = run(False)
    check_launches(launches, want_launches, f"{what} step")
    want, mr, ref_launches = run(True)
    check_launches(ref_launches, {}, f"{what} step under reference_ops")
    for k in ("loss", "grad_norm"):
        check(abs(mk[k] - mr[k]) <= TRAIN_RTOL * abs(mr[k]),
              f"{what} {k}: kernels {mk[k]}, plain {mr[k]}")
    # gradients: mu after the first step is 0.1 * the clipped gradient
    gmax = max(float(t.abs().max()) for t in want["mu"].values()) / 0.1
    worst = {"grad": 0.0, "nu": 0.0, "param_over_tol": 0.0, "ema": 0.0}
    for n in want["params"]:
        for slot, rel, floor in (("mu", TRAIN_GRAD_REL, 0.1 * 1e-6 * gmax),
                                 ("nu", 2 * TRAIN_GRAD_REL, 1e-3 * (1e-6 * gmax) ** 2)):
            a, b = got[slot][n], want[slot][n]
            if n in exact_zero:
                big = max(float(a.abs().max()), float(b.abs().max()))
                check(big <= floor, f"{what} {slot} {n}: {big}, not rounding noise")
                continue
            e = float((a - b).abs().max()) / max(float(b.abs().max()), floor)
            check(e <= rel, f"{what} {slot} {n}: error {e} of its largest entry")
            worst["grad" if slot == "mu" else "nu"] = max(worst["grad" if slot == "mu"
                                                                else "nu"], e)
        mu = want["mu"][n]
        atol = torch.where(mu.abs() < 1e-2 * float(mu.abs().max()), 2 * lr, 0.1 * lr)
        if n in exact_zero:
            atol = torch.full_like(mu, 2 * lr)
        e = float(((got["params"][n] - want["params"][n]).abs() / atol).max())
        check(e <= 1.0, f"{what} param {n}: {e} of its tolerance")
        ema_e = float(((got["ema"][n] - want["ema"][n]).abs() / (1e-3 * atol + 1e-6)).max())
        check(ema_e <= 1.0, f"{what} ema {n}: {ema_e} of its tolerance")
        worst["param_over_tol"] = max(worst["param_over_tol"], e)
        worst["ema"] = max(worst["ema"], ema_e)
    return dict(B=B, dtype="float32", params=n_params, lr=lr, kernels=mk, plain=mr,
                loss_rtol=TRAIN_RTOL, grad_rel=TRAIN_GRAD_REL, worst=worst, launches=launches)


def phase_train_slice(card):
    from mcvd_tpu_torch.config import flagship_config

    out = train_step_vs_plain(flagship_config(), 10, 4, TRAIN_LAUNCHES, "train_slice")
    check(out["params"] == FLAGSHIP_PARAM_COUNT,
          f"{out['params']} params, JAX has {FLAGSHIP_PARAM_COUNT}")
    emit("train_slice", card=card, **out)


def phase_wide_heads(card):
    """The shipped configs with wider heads at full width (`WIDE_CONFIGS`,
    read with the port's load_config): bair_big (D=96, 64 px),
    cityscapes_big (D=128, 128 px), bair_big_spade (D=96) and
    cityscapes_big_spade (D=192, 128 px), random weights from a seed: one
    fp32 network evaluation and one fp32 training step (B=2 at 64 px, 1 at
    128 px, cut from 4 to keep the script inside its time limit: cuDNN's
    fp32 FFT-tiled convolutions at 128 px scale with the batch) through the
    kernels against `reference_ops()`, with exact launch counts (the model's
    GroupNorm and attention calls)."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.models.blocks import AttnBlock

    launches = {}
    for name, (head_dim, n_jax) in WIDE_CONFIGS.items():
        config = load_config(repo_path(f"configs/{name}.yml"))
        config.model.dropout = 0.0   # as train_step_vs_plain, which reuses the model
        B = 2 if config.data.image_size == 64 else 1
        n_gn, n_attn = model_calls(config, B)
        model = _slice_model(config, 20)
        attn = [m for m in model.modules() if isinstance(m, AttnBlock)]
        check(len(attn) == n_attn, f"{name}: {len(attn)} attention blocks, want {n_attn}")
        dims = {m.NIN_0.W.shape[0] // m.n_heads for m in attn}
        heads = sorted({m.n_heads for m in attn})
        check(dims == {head_dim}, f"{name}: attention head dims {dims}, want {head_dim}")
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == n_jax, f"{name}: {n_params} params, JAX has {n_jax}")
        d = config.data
        sz = d.image_size
        g = torch.Generator(device="cuda").manual_seed(21)
        x = torch.randn(B, sz, sz, d.channels * d.num_frames, generator=g, device="cuda")
        cond = torch.rand(B, sz, sz, d.channels * d.num_frames_cond, generator=g,
                          device="cuda") * 2 - 1
        t = torch.randint(0, config.model.num_classes, (B,), generator=g, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model.eval()
        with torch.inference_mode():
            ops.reset_launches()
            got = model(x.permute(0, 3, 1, 2), t, cond.permute(0, 3, 1, 2))
            torch.cuda.synchronize()
            eval_launches = dict(ops.LAUNCHES)
            check_launches(eval_launches, {"gn_fused": n_gn, "attention_fwd": n_attn},
                           f"{name} evaluation")
            with ops.reference_ops():
                want = model(x.permute(0, 3, 1, 2), t, cond.permute(0, 3, 1, 2))
            # the evaluation's wall, synchronised, after the two above: one
            # run (cut from three: cityscapes_big_spade's fp32 evaluation
            # takes ~8 s, section 5 of PERF.md)
            t0 = time.perf_counter()
            model(x.permute(0, 3, 1, 2), t, cond.permute(0, 3, 1, 2))
            torch.cuda.synchronize()
            eval_ms = [1e3 * (time.perf_counter() - t0)]
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} evaluation output {tuple(got.shape)} not finite")
        big = float(want.abs().max())
        diff = float((got - want).abs().max())
        check(diff <= TRAIN_GRAD_REL * big,
              f"{name} evaluation: kernels vs plain max abs diff {diff}, largest {big}")
        want_launches = {"gn_fused": n_gn, "gn_fused_bwd": n_gn, "attention_fwd": n_attn,
                         "attention_bwd": n_attn}
        step = train_step_vs_plain(config, 20, B, want_launches, name, model=model)
        del model, attn
        launches[name] = step["launches"]
        emit("wide_heads", card=card, config=name, head_dim=head_dim, image_size=sz,
             heads=heads, params=n_params,
             spade=bool(getattr(config.model, "spade", False)),
             eval=dict(B=B, dtype="float32", max_abs_diff=diff, largest=big,
                       rel_tol=TRAIN_GRAD_REL, launches=eval_launches,
                       ms=statistics.median(eval_ms), ms_all=eval_ms),
             train_step=step)
        torch.cuda.empty_cache()
    return launches


def exact_zero_grads(model):
    """The parameters whose gradient is zero in exact arithmetic: each
    attention's key bias (softmax takes out a constant added to a query's
    scores: NCSN++'s NIN_1.b, the legacy UNet's K.bias), and in the legacy
    UNet the biases that add a constant to each channel (of each example) at
    the input of a GroupNorm of one channel a group (32 groups over 32
    channels), which takes it out: in the 32-channel resblocks conv0's bias
    and the time embedding's projection `dense` (before normalize1), and in
    the last resblock, whose output only the head's `normalize` reads,
    conv1's and the shortcut `nin`'s biases."""
    from mcvd_tpu_torch.models.blocks import AttnBlock
    from mcvd_tpu_torch.models.unet import UNet, AttnBlock as LegacyAttnBlock
    from mcvd_tpu_torch.models.unet import ResnetBlock

    def one_a_group(gn):
        return gn.num_groups == gn.channels

    out = []
    for name, m in model.named_modules():
        if isinstance(m, AttnBlock):
            out.append(f"{name}.NIN_1.b")
        elif isinstance(m, LegacyAttnBlock):
            out.append(f"{name}.K.bias")
        elif isinstance(m, ResnetBlock) and one_a_group(m.normalize1):
            out.append(f"{name}.conv0.bias")
            if hasattr(m, "dense"):
                out += [f"{name}.dense.weight", f"{name}.dense.bias"]
        elif isinstance(m, UNet) and one_a_group(m.normalize):
            last = f"{name}.upblocks.{len(m.upblocks) - 1}"
            out.append(f"{last}.conv1.bias")
            if hasattr(m.upblocks[-1], "nin"):
                out.append(f"{last}.nin.bias")
    return tuple(out)


def small5_model(card, name, yml, mods, n_gn, n_attn, n_jax):
    """One of the SMALL5 models at full width (random weights, zero-scale
    layers redrawn): one fp32 evaluation at B=64 through the kernels against
    `reference_ops()` (within TRAIN_GRAD_REL of the largest output, as
    wide_heads), exact launch counts; the bf16 evaluation (the model cast,
    as the sampler casts it), finite, exact launch counts and its distance
    to the fp32 plain output; one fp32 training step against
    `reference_ops()` (train_step_vs_plain) and 3 timed steps (train_steps)."""
    import copy

    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.tools.gn_calls import model_calls

    config = load_config(repo_path(yml), mods)
    config.model.dropout = 0.0
    B = 64
    gn, attn = model_calls(config, B)
    check((len(gn), len(attn)) == (n_gn, n_attn),
          f"{name}: {len(gn)} GroupNorm and {len(attn)} attention calls, want "
          f"{n_gn} and {n_attn}")
    model = _slice_model(config, 30)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == n_jax, f"{name}: {n_params} params, JAX has {n_jax}")
    d = config.data
    sz = d.image_size
    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(B, d.channels * d.num_frames, sz, sz, generator=g, device="cuda")
    cond = torch.rand(B, d.channels * d.num_frames_cond, sz, sz, generator=g,
                      device="cuda") * 2 - 1
    t = torch.randint(0, config.model.num_classes, (B,), generator=g, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want_eval = {"gn_fused": n_gn, "attention_fwd": n_attn}
    model.eval()
    out = {}
    with torch.inference_mode():
        for dn, net in (("float32", model),
                        ("bfloat16", copy.deepcopy(model).to(torch.bfloat16))):
            dt = next(net.parameters()).dtype
            xs, cs = x.to(dt), cond.to(dt)
            ops.reset_launches()
            got = net(xs, t, cs)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            check_launches(launches, want_eval, f"{name} {dn} evaluation")
            check(bool(torch.isfinite(got).all()), f"{name} {dn} evaluation not finite")
            if dn == "float32":
                with ops.reference_ops():
                    want = net(xs, t, cs)
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                net(xs, t, cs)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            big = float(want.abs().max())
            diff = float((got.float() - want).abs().max())
            if dn == "float32":
                check(diff <= TRAIN_GRAD_REL * big,
                      f"{name} evaluation: kernels vs plain max abs diff {diff}, largest {big}")
            out[dn] = dict(B=B, max_abs_diff_to_fp32_plain=diff, largest=big, launches=launches,
                           ms=statistics.median(ms), ms_all=ms)
    want_step = {**want_eval, "gn_fused_bwd": n_gn, "attention_bwd": n_attn}
    step = train_step_vs_plain(config, 30, B, want_step, name, model=model,
                               exact_zero=exact_zero_grads(model))
    del model
    torch.cuda.empty_cache()
    timed = train_steps(config, "float32", 3, want_step)
    emit("small5", card=card, model=name, config=yml, config_mod=mods,
         arch=config.model.arch, params=n_params, eval=out, train_step=step,
         train_steps=timed)
    return dict(eval_fp32_ms=out["float32"]["ms"], eval_bf16_ms=out["bfloat16"]["ms"],
                step_fp32_ms=timed["ms_per_step"], launches=step["launches"])


def small5_cli():
    """The CLI on the two small configs (`SMALL5_CLI_MODS`), each in an
    experiment of its own, side by side: --train to 3 with the in-training
    video_gen at 3; exact launch counts, checkpoint_3 loaded bit-equal,
    finite losses and metrics, the loop's ms a step. The runs share the card
    (with each other and the JAX export's video_gen), so their times are
    reported as `*_card_shared`, not comparable with a run alone."""
    from mcvd_tpu_torch.compat import yaml_subset

    def one(name):
        yml, _, n_gn, n_attn, _ = SMALL5[name]
        with tempfile.TemporaryDirectory(prefix=f"mcvd_{name}_") as exp:
            log, launches, wall_s = run_cli(exp, 3, "--train", config=yml,
                                            base_mods=SMALL5_CLI_MODS)
            check_launches(launches, _cli_launches(3, 1 + 2 * BLOCK, n_gn, n_attn),
                           f"cli {name} train")
            steps = _steps_waits(log)
            check(sorted(steps) == [1, 2, 3] and "training done at step 3" in log
                  and all(np.isfinite(v[0]) for v in steps.values()),
                  f"cli {name}: steps {steps}")
            logs = os.path.join(exp, "logs")
            best = yaml_subset.load_file(os.path.join(logs, "best_metrics.yml"))
            return {"train": dict(
                launches=launches, wall_s_card_shared=wall_s,
                ms_by_step_card_shared={k: v[1] for k, v in steps.items()},
                checkpoint_tensors_bit_equal=check_checkpoint(logs, yml, 3, SMALL5_CLI_MODS),
                snapshot_metrics=_finite_metrics(best, f"{name} best_metrics.yml"))}

    names = ("small5", "small5_3d")
    with ThreadPoolExecutor(len(names)) as pool:   # side by side (no time reported)
        return dict(zip(names, pool.map(one, names)))


def small5_jax_export():
    """The committed JAX export (`JAX_EXPORT`): imported by compat.jax_ckpt
    into a temporary log directory, its checkpoint's params and EMA bit-equal
    to the export's arrays, then --video_gen --ckpt 1 from it on the card
    with exact launch counts and finite metrics."""
    from mcvd_tpu_torch.compat import jax_ckpt, torch_state_dict_from_flax, yaml_subset
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.tools.gn_calls import model_calls
    from mcvd_tpu_torch.train import checkpoints

    with tempfile.TemporaryDirectory(prefix="mcvd_jax_export_") as exp:
        logs = os.path.join(exp, "logs")
        step = jax_ckpt.import_checkpoint(repo_path(JAX_EXPORT), logs)
        parts, _ = jax_ckpt.read_export(repo_path(JAX_EXPORT))
        saved = checkpoints.load_checkpoint(logs, name=f"checkpoint_{step}")
        n_equal = 0
        for which in ("params", "ema_params"):
            want = torch_state_dict_from_flax(parts[which])
            got = getattr(saved, which)
            check(set(got) == set(want), f"jax export {which}: other tensors")
            for k, v in want.items():
                check(torch.equal(got[k].contiguous(), v), f"jax export {which} {k} differs")
                n_equal += 1
        config_path = os.path.join(logs, "config.yml")
        n_gn, n_attn = (len(c) for c in model_calls(load_config(config_path), 16))
        log, launches, wall_s = run_cli(exp, step, "--video_gen", "--ckpt", str(step),
                                        config=config_path, base_mods=JAX_EXPORT_MODS)
        check_launches(launches, _cli_launches(0, 2 * BLOCK, n_gn, n_attn),
                       "cli video_gen from the JAX export")
        vid = _finite_metrics(yaml_subset.load_file(
            os.path.join(exp, "video_samples", "videos", "vid_metrics.yml")),
            "JAX export vid_metrics.yml")
    return dict(export=JAX_EXPORT, step=step, tensors_bit_equal=n_equal, launches=launches,
                wall_s_card_shared=wall_s, vid_metrics=vid)   # beside small5_cli


def phase_small5(card):
    """The slice of the legacy UNet and the 3D family on the card: the
    kernels at the new shapes (every GroupNorm and attention call of one
    evaluation of the three SMALL5 models, read from them, both dtypes,
    forward and backward; the attention at B=4 and B=64 clips; one call of
    each past the grid's 65,535), the three models at full width, the CLI
    on the two shipped configs, and a --video_gen from the committed JAX
    export. The kernels' timed cases are bf16 and fp32 at B=64 (attention)
    and the bf16 GroupNorm calls at C=84, of the legacy UNet and of the
    attention blocks (the time attention's B*256 examples of 7 or 2 rows)."""
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.tools.gn_calls import form, model_calls

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(40)
    gn_shapes = {}   # distinct calls of the three models at B=16, in order
    for name, (yml, mods, *_rest) in SMALL5.items():
        for c in model_calls(load_config(repo_path(yml), mods), 16)[0]:
            gn_shapes.setdefault(tuple(sorted(c.items())), name)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for key, name in gn_shapes.items():
            c = dict(key)
            timed = dtype == torch.bfloat16 and (c["C"] == 84 or name == "small5" or
                                                 (c["affine"] and not c["act"]))
            N = c["frames_last"]
            shape = (c["B"], c["C"] // N, c["H"], c["W"], N, form(c), c["num_groups"],
                     c["eps"], dtype)
            cases += [dict(gn_fwd_case(g, *shape, timed=timed, compare=timed), model=name),
                      dict(gn_bwd_case(g, *shape, timed=timed, compare=timed), model=name)]
        big = (PAST_GRID, 24, 7, 1, 1, "affine", 6, 1e-6, dtype)
        cases += [dict(gn_fwd_case(g, *big, timed=False), model="past_grid"),
                  dict(gn_bwd_case(g, *big, timed=False), model="past_grid")]
        for B in SMALL5_ATTN_B:
            config = load_config(repo_path(SMALL5["small5_3d"][0]))
            for a in model_calls(config, B)[1]:
                shape = (a["B"], a["T"], a["heads"], a["D"], dtype)
                cases += [attn_fwd_case(g, *shape, timed=B == 64),
                          attn_bwd_case(g, *shape, timed=B == 64)]
        cases += [attn_fwd_case(g, PAST_GRID, 7, 1, 24, dtype, timed=False),
                  attn_bwd_case(g, PAST_GRID, 7, 1, 24, dtype, timed=False)]
    attn = [c for c in cases if c["op"].startswith("attention")]
    routes = {c["route"] for c in attn}
    check(routes == {"wgmma"}, f"small5: the 3D family's attention took {routes}")
    for c in attn:   # packed at T <= 64, G = 64 // T sequences a tile
        want = ("packed", 64 // c["T"]) if c["T"] <= 64 else ("tiled", 1)
        got = (c["plan"]["form"], c["plan"]["seqs_per_tile"])
        check(got == want, f"small5: {c['op']} B={c['B']} T={c['T']} took plan {got}")
    torch.cuda.synchronize()
    emit("small5_kernels", card=card, cases=cases)
    models = {name: small5_model(card, name, yml, mods, n_gn, n_attn, n_jax)
              for name, (yml, mods, n_gn, n_attn, n_jax) in SMALL5.items()}
    with ThreadPoolExecutor(1) as beside:   # the export's video_gen beside the CLI
        export = beside.submit(small5_jax_export)
        cli = small5_cli()
        export = export.result()
    emit("small5_cli", card=card, config_mod=SMALL5_CLI_MODS, runs=cli, jax_export=export)
    return models


def _seconds(fn, n=3):
    """(median ms, all ms) of n synchronised calls of fn after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ms), ms


def smld_eval(name, yml, mods, B, n_jax, on_cpu):
    """One fp32 evaluation (TF32 off) of an SMLD model at full width, random
    weights from a seed: its parameter count against the JAX init's, finite
    output of the input's shape, its ms (median of 3 after a warm-up) and,
    where `on_cpu`, the same weights and input on the CPU within
    SMLD_EVAL_REL of the largest output. Returns (payload, model, config)."""
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.models import get_model

    config = load_config(repo_path(yml), mods)
    model = get_model(config, generator=torch.Generator().manual_seed(50), device="cuda")
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == n_jax, f"smld {name}: {n_params} params, JAX has {n_jax}")
    d = config.data
    sz = d.image_size
    g = torch.Generator().manual_seed(51)
    x = torch.rand(B, d.channels * d.num_frames, sz, sz, generator=g)
    y = torch.randint(0, config.model.num_classes, (B,), generator=g)
    xc = x.cuda().contiguous(memory_format=torch.channels_last)
    yc = y.cuda()
    with torch.inference_mode():
        ms, ms_all = _seconds(lambda: model(xc, yc))
        got = model(xc, yc)
    check(got.shape == x.shape and bool(torch.isfinite(got).all()),
          f"smld {name}: output {tuple(got.shape)} not finite")
    out = dict(model=name, config=yml, config_mod=mods, arch=config.model.arch,
               cls=type(model).__name__, params=n_params, B=B, image_size=sz, dtype="float32",
               ms=ms, ms_all=ms_all, out_std=float(got.std()))
    if on_cpu:
        cpu = get_model(config, device="cpu").eval()
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        with torch.inference_mode():
            want = cpu(x.contiguous(memory_format=torch.channels_last), y)
        big = float(want.abs().max())
        diff = float((got.cpu() - want).abs().max())
        check(diff <= SMLD_EVAL_REL * big,
              f"smld {name}: card vs CPU max abs diff {diff}, largest {big}")
        out.update(cpu_max_abs_diff=diff, largest=big, rel_tol=SMLD_EVAL_REL)
        del cpu
    return out, model, config


def smld_step_on(device, config, weights, X, draws, dtype=torch.float32, reference=False):
    """One train step of `config`'s model from `weights` on `device` in
    `dtype` (fp32, or fp64 for the reference; the plain versions under
    `ops.reference_ops()` where `reference`): (loss, grad_norm, Adam's first
    moment by name as fp64, the kernel launch counts)."""
    import contextlib

    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.train import create_train_state, make_train_step

    model = get_model(config, device=device).to(dtype)
    model.load_state_dict({k: v.to(device, dtype) for k, v in weights.items()})
    state = create_train_state(config, model, device=device)
    step = make_train_step(model, make_schedule(config), config)
    ops.reset_launches()
    with ops.reference_ops() if reference else contextlib.nullcontext():
        state, m = step(state, X.to(device, dtype),
                        draws={k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
                               for k, v in draws.items()})
    if device == "cuda":
        torch.cuda.synchronize()
    return float(m["loss"]), float(m["grad_norm"]), {
        n: t.detach().cpu().double() for n, t in state.opt_state["mu"].items()}, dict(
        ops.LAUNCHES)


def smld_hold_step(what, got, want, config, weights, X, draws):
    """Hold one fp32 step `got` to `want` (both `smld_step_on` results from
    the same weights and draws): loss and grad_norm within TRAIN_RTOL, every
    gradient (Adam's first moment) within TRAIN_GRAD_REL of its tensor's
    largest, or, where the two part further (the ncsn nets' gradients
    cancel: a sum over B*H*W positions of terms far larger than itself),
    `got` within WITNESS_FACTOR times `want`'s own error against the same
    step in fp64 on the CPU (plain versions throughout). Returns the
    payload."""
    for i, k in enumerate(("loss", "grad_norm")):
        check(abs(got[i] - want[i]) <= TRAIN_RTOL * abs(want[i]),
              f"{what} {k}: {got[i]} against {want[i]}")
    gmax = max(float(t.abs().max()) for t in want[2].values())

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6 * gmax)

    worst, witnessed, ref64 = 0.0, {}, None
    for n, w in want[2].items():
        e = rel(got[2][n], w)
        worst = max(worst, e)
        if e <= TRAIN_GRAD_REL:
            continue
        if ref64 is None:
            ref64 = smld_step_on("cpu", config, {k: v.double() for k, v in weights.items()},
                                 X, draws, torch.float64)[2]
        got64, want64 = rel(got[2][n], ref64[n]), rel(w, ref64[n])
        check(got64 <= WITNESS_FACTOR * want64,
              f"{what} grad {n}: {e} of its largest against the other step, {got64} against "
              f"fp64, over {WITNESS_FACTOR} x the other's own {want64}")
        witnessed[n] = dict(vs_other=e, vs_fp64=got64, other_vs_fp64=want64)
    return dict(loss=[got[0], want[0]], grad_norm=[got[1], want[1]], loss_rtol=TRAIN_RTOL,
                grad_rel=TRAIN_GRAD_REL, worst_grad_rel=worst, witnessed_by_fp64=witnessed,
                witness_factor=WITNESS_FACTOR)


def smld_train(config):
    """cifar10_ncsnv2's fp32 step: the yml's B=128 on the card (one warm-up,
    3 timed steps, no kernel launched: InstanceNorm++ is plain torch), and
    one step at SMLD_STEP_CHECK_B from the same weights and draws on the card
    and on the CPU, held by `smld_hold_step` (the CPU's own fp32 gradients
    part from fp64 by up to 6.8e-3 of a tensor's largest on this model)."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.train import create_train_state, make_train_step

    config.model.dropout = 0.0
    B = config.training.batch_size
    check(B == 128, f"cifar10_ncsnv2.yml trains at B={B}, expected 128")
    d = config.data
    sched = make_schedule(config)
    levels = len(sched.sigmas)
    g = torch.Generator().manual_seed(60)
    model = get_model(config, generator=torch.Generator().manual_seed(61), device="cuda")
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    X = torch.rand(B, d.num_frames, d.image_size, d.image_size, d.channels, generator=g)
    draws = {"labels": torch.randint(0, levels, (B,), generator=g),
             "z": torch.randn(B, d.channels * d.num_frames, d.image_size, d.image_size,
                              generator=g)}
    state = create_train_state(config, model, device="cuda")
    step = make_train_step(model, sched, config)
    Xc = X.cuda()
    dc = {k: v.cuda() for k, v in draws.items()}
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(4):
        ops.reset_launches()
        t0 = time.perf_counter()
        state, m = step(state, Xc, draws=dc)
        torch.cuda.synchronize()
        if i:
            times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        check_launches(dict(ops.LAUNCHES), {}, "smld train step")
    check(all(np.isfinite(losses)), f"smld train step losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, state, step
    torch.cuda.empty_cache()
    b = SMLD_STEP_CHECK_B
    small = {k: v[:b] for k, v in draws.items()}
    held = smld_hold_step("smld step card vs CPU",
                          smld_step_on("cuda", config, weights, X[:b], small),
                          smld_step_on("cpu", config, weights, X[:b], small),
                          config, weights, X[:b], small)
    return dict(B=B, dtype="float32", ms_per_step=statistics.median(times), ms_all=times,
                clips_per_s=1e3 * B / statistics.median(times), peak_mem_gib=peak,
                loss=losses, check_B=b, card_vs_cpu=held)


def smld_block(model, config):
    """One Langevin block of cifar10_ncsnv2 through `make_block_sampler`: the
    ladder cut to SMLD_LEVELS levels, the yml's n_steps_each and step_lr,
    B=16 on the card with explicit draws; its first SMLD_CPU_B rows against
    the same chain on the CPU (same weights, init and draws) within
    SMLD_BLOCK_REL of the largest |x|, or, where the chain amplifies
    rounding past that, within WITNESS_FACTOR times the CPU chain's own
    spread from an init moved by WITNESS_REL. ms per evaluation."""
    import copy

    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.eval import make_block_sampler
    from mcvd_tpu_torch.models import get_model

    config = copy.deepcopy(config)
    config.model.num_classes = SMLD_LEVELS
    sched = make_schedule(config)
    n = config.sampling.n_steps_each
    evals = SMLD_LEVELS * n + 1
    d = config.data
    B, sz, cf = 16, d.image_size, d.channels * d.num_frames
    g = torch.Generator().manual_seed(70)
    init = torch.rand(B, sz, sz, cf, generator=g)
    noise = torch.randn(SMLD_LEVELS, n, B, sz, sz, cf, generator=g)
    params = dict(model.named_parameters())
    block = make_block_sampler(config, model, sched)
    initc, noisec = init.cuda(), noise.cuda()
    got = block(params, initc, None, step_noise=noisec)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = block(params, initc, None, step_noise=noisec)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(got.shape == init.shape and bool(torch.isfinite(got).all()),
          "smld block output not finite")
    cpu = get_model(config, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cblock = make_block_sampler(config, cpu, sched)
    cparams = dict(cpu.named_parameters())
    b = SMLD_CPU_B
    want = cblock(cparams, init[:b], None, step_noise=noise[:, :, :b])
    big = float(want.abs().max())
    diff = float((got[:b].cpu() - want).abs().max())
    out = dict(B=B, levels=SMLD_LEVELS, n_steps_each=n, step_lr=config.sampling.step_lr,
               evals=evals, wall_s=wall_s, ms_per_eval=1e3 * wall_s / evals, cpu_B=b,
               max_abs_diff=diff, largest=big, out_range=[float(got.min()), float(got.max())])
    if diff <= SMLD_BLOCK_REL * big:
        out.update(bound="rel", rel_tol=SMLD_BLOCK_REL)
        return out
    delta = torch.randn(init[:b].shape, generator=g)
    delta *= WITNESS_REL * float(init.abs().max()) / float(delta.abs().max())
    far = float((cblock(cparams, init[:b] + delta, None, step_noise=noise[:, :, :b]) -
                 want).abs().max())
    check(diff <= WITNESS_FACTOR * far,
          f"smld block card vs CPU max abs diff {diff} > {SMLD_BLOCK_REL} x {big} and > "
          f"{WITNESS_FACTOR} x the CPU chain's own spread {far}")
    out.update(bound="witness", witness_rel=WITNESS_REL, witness_max_abs_diff=far,
               witness_factor=WITNESS_FACTOR)
    return out


def write_cifar(root):
    """CIFAR-10 python pickles of random images (SMLD_CIFAR_IMAGES)."""
    import pickle

    rng = np.random.default_rng(80)
    os.makedirs(root, exist_ok=True)
    n_train, n_test = SMLD_CIFAR_IMAGES
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = n_test if name == "test_batch" else n_train
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": [int(v) for v in rng.integers(0, 10, n)]}, f)


def smld_cli():
    """The CLI on cifar10_ncsnv2.yml at full width (ngf 128) on synthetic
    pickles, SMLD_CLI_MODS: --train to 3 (no kernel launched), then --sample
    --ckpt 3 with sampling.inpainting and with sampling.interpolation; the
    files, their keys and shapes, finite."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="mcvd_smld_cli_") as exp:
        write_cifar(os.path.join(exp, "data"))
        bs, n_interp = 4, 3
        for run, n_iters, flags, mods, name, want in (
                ("train", 3, ["--train"], [], None, None),
                ("inpainting", 3, ["--sample", "--ckpt", "3"], ["sampling.inpainting=true"],
                 "inpainting_3.npz", {"samples": (bs, 32, 32, 3), "refer": (bs, 32, 32, 3)}),
                ("interpolation", 3, ["--sample", "--ckpt", "3"],
                 ["sampling.interpolation=true"], "interpolation_3.npz",
                 {"samples": (bs * n_interp, 32, 32, 3)})):
            log, launches, wall_s = run_cli(exp, n_iters, *flags, mods=mods, config=SMLD_CONFIG,
                                            base_mods=SMLD_CLI_MODS)
            check_launches(launches, {}, f"smld cli {run}")
            res = dict(wall_s=wall_s)
            if run == "train":
                steps = _steps_waits(log)
                check(sorted(steps) == [1, 2, 3] and "training done at step 3" in log
                      and all(np.isfinite(v[0]) for v in steps.values()),
                      f"smld cli train: steps {steps}")
                res.update(ms_by_step={k: v[1] for k, v in steps.items()},
                           loss_by_step={k: v[0] for k, v in steps.items()})
            else:
                path = os.path.join(exp, "image_samples", "images", name)
                check(os.path.exists(path), f"smld cli {run}: no {name}")
                with np.load(path) as z:
                    shapes = {k: z[k].shape for k in z.files}
                    check(shapes == want and all(np.isfinite(z[k]).all() for k in z.files),
                          f"smld cli {run}: {name} holds {shapes}, want {want}")
                res["shapes"] = {k: list(v) for k, v in shapes.items()}
            out[run] = res
    return out


def smld_ffhq(model, config):
    """A synthetic `*r256.tfrecords` of SMLD_FFHQ_IMAGES images written by the
    port's writer, read by `get_dataset` on ffhq.yml (the seed-2019 9 / 1
    split), one batch of 2 through `DataLoader` into the 256-px model:
    the images as written, a finite output of their shape."""
    from mcvd_tpu_torch.data import DataLoader, data_transform, fold_frames, get_dataset
    from mcvd_tpu_torch.data import tfrecord

    rng = np.random.default_rng(90)
    imgs = rng.integers(0, 256, (SMLD_FFHQ_IMAGES, 3, 256, 256), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="mcvd_ffhq_") as root:
        t0 = time.perf_counter()
        tfrecord.write_examples(os.path.join(root, "ffhq-r256.tfrecords"),
                                ({"data": [im.tobytes()], "shape": [3, 256, 256]}
                                 for im in imgs))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        train, test = get_dataset(root, config)
        read_s = time.perf_counter() - t0
    check((len(train), len(test)) == (9, 1), f"ffhq split {len(train)} / {len(test)}")
    X, _ = next(iter(DataLoader(train, batch_size=2, shuffle=False)))
    flipped = [bool(train.dataset.random_flip and train.dataset._rng(i).integers(2) == 0)
               for i in train.indices[:2]]
    for j, i in enumerate(train.indices[:2]):
        want = imgs[i].transpose(1, 2, 0)[:, ::-1] if flipped[j] else imgs[i].transpose(1, 2, 0)
        check(np.array_equal(X[j, 0], want.astype(np.float32) / 255.0),
              f"ffhq image {i} read back other than written")
    x = fold_frames(data_transform(config, torch.from_numpy(X).cuda()))
    with torch.inference_mode():
        out = model(x.contiguous(memory_format=torch.channels_last),
                    torch.zeros(2, dtype=torch.long, device="cuda"))
    check(out.shape == (2, 3, 256, 256) and bool(torch.isfinite(out).all()),
          f"ffhq batch through the model: {tuple(out.shape)}")
    return dict(images=SMLD_FFHQ_IMAGES, split=[len(train), len(test)], write_s=write_s,
                read_s=read_s, batch=list(X.shape), out_std=float(out.std()))


def smld_groupnorm(card):
    """cifar10_ncsnv2 with model.normalization=GroupNorm: `gn_fused` and
    `gn_fused_bwd` at every shape `tools.gn_calls` reads from the model (B=16,
    fp32; the form affine, eps 1e-6), one fp32 evaluation at B=16 against
    `reference_ops()` within TRAIN_GRAD_REL of the largest output with
    exact launch counts, and one fp32 step (B=4) against `reference_ops()`
    with exact launch counts, held by `smld_hold_step`."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.tools.gn_calls import form, model_calls

    config = load_config(repo_path(SMLD_CONFIG), ["model.normalization=GroupNorm"])
    B = 16
    gn, attn = model_calls(config, B)
    check(attn == [] and len(gn) > 0, f"smld GroupNorm: {len(gn)} GroupNorm and "
                                      f"{len(attn)} attention calls")
    g = torch.Generator(device="cuda").manual_seed(100)
    cases = []
    for key in sorted({tuple(sorted(c.items())) for c in gn}):
        c = dict(key)
        shape = (c["B"], c["C"], c["H"], c["W"], 1, form(c), c["num_groups"], c["eps"],
                 torch.float32)
        cases += [dict(gn_fwd_case(g, *shape, compare=True),
                       calls=sum(dict(sorted(x.items())) == c for x in gn)),
                  gn_bwd_case(g, *shape, compare=True)]
    model = _slice_model(config, 101)
    model.eval()
    d = config.data
    gi = torch.Generator(device="cuda").manual_seed(102)
    x = torch.rand(B, d.channels, d.image_size, d.image_size, generator=gi, device="cuda")
    x = x.contiguous(memory_format=torch.channels_last)
    t = torch.randint(0, config.model.num_classes, (B,), generator=gi, device="cuda")
    with torch.inference_mode():
        ops.reset_launches()
        got = model(x, t)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        check_launches(launches, {"gn_fused": len(gn)}, "smld GroupNorm evaluation")
        with ops.reference_ops():
            want = model(x, t)
    big = float(want.abs().max())
    diff = float((got - want).abs().max())
    check(diff <= TRAIN_GRAD_REL * big,
          f"smld GroupNorm evaluation: kernels vs plain {diff}, largest {big}")
    config.model.dropout = 0.0
    b = SMLD_STEP_CHECK_B
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    g = torch.Generator().manual_seed(103)
    X = torch.rand(b, d.num_frames, d.image_size, d.image_size, d.channels, generator=g)
    draws = {"labels": torch.randint(0, config.model.num_classes, (b,), generator=g),
             "z": torch.randn(b, d.channels * d.num_frames, d.image_size, d.image_size,
                              generator=g)}
    kern = smld_step_on("cuda", config, weights, X, draws)
    check_launches(kern[3], {"gn_fused": len(gn), "gn_fused_bwd": len(gn)},
                   "smld GroupNorm step")
    plain = smld_step_on("cuda", config, weights, X, draws, reference=True)
    check_launches(plain[3], {}, "smld GroupNorm step under reference_ops")
    step = smld_hold_step("smld GroupNorm step kernels vs plain", kern, plain, config,
                          weights, X, draws)
    return dict(gn_calls=len(gn), cases=cases,
                eval=dict(B=B, max_abs_diff=diff, largest=big, launches=launches),
                train_step=dict(B=b, launches=kern[3], **step))


def phase_smld(card):
    """The SMLD family on the card: the five evaluations of SMLD_MODELS, the
    cifar10_ncsnv2 train step, one Langevin block through the port's
    `make_block_sampler`, the CLI on synthetic CIFAR-10 pickles (--train,
    --sample with inpainting and with interpolation), FFHQ through a
    synthetic r256 shard and `get_dataset` into the 256-px model, and the
    GroupNorm option (`model.normalization=GroupNorm`): an evaluation and a
    step against `ops.reference_ops()` with exact launch counts, and
    `gn_fused` / `gn_fused_bwd` at every shape `tools.gn_calls` reads from
    that model."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}
    t0 = time.perf_counter()
    evals, kept = [], {}
    for name, (yml, mods, B, n_jax, on_cpu) in SMLD_MODELS.items():
        out, model, config = smld_eval(name, yml, mods, B, n_jax, on_cpu)
        evals.append(out)
        if name in ("ncsnv2_32", "ncsnv2_deepest_256"):
            kept[name] = (model, config)
        else:
            del model
    torch.cuda.empty_cache()
    seconds["evals"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ffhq = smld_ffhq(*kept.pop("ncsnv2_deepest_256"))
    torch.cuda.empty_cache()
    seconds["ffhq"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    block = smld_block(*kept["ncsnv2_32"])
    seconds["block"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = smld_train(kept.pop("ncsnv2_32")[1])
    torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gn = smld_groupnorm(card)
    seconds["groupnorm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = smld_cli()
    seconds["cli"] = time.perf_counter() - t0
    emit("smld", card=card, evals=evals, train_step=train, block=block, ffhq=ffhq,
         groupnorm=gn, cli=cli, cli_mods=SMLD_CLI_MODS, seconds=seconds)


def train_steps(config, dn, n_steps, want_launches):
    """Training steps of `config`'s model at its B=64 (random weights from a
    seed, dropout and warmup as the config says) in compute dtype `dn`: one
    warm-up step, then `n_steps` timed steps, each with exact launch counts.
    Returns the payload."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.training.batch_size = B = 64   # the ymls' (smmnist_DDPM_big5[_spade].yml)
    config.training.compute_dtype = dn
    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
    state = create_train_state(config, model, device="cuda")
    step = make_train_step(model, make_schedule(config), config)
    d = config.data
    g = torch.Generator(device="cuda").manual_seed(7)
    X = torch.rand(B, d.num_frames_cond + d.num_frames, d.image_size, d.image_size,
                   d.channels, generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, X, generator=g)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times, losses, launches = [], [], None
    for _ in range(n_steps):
        ops.reset_launches()
        t0 = time.perf_counter()
        state, m = step(state, X, generator=g)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        launches = dict(ops.LAUNCHES)
        check_launches(launches, want_launches, f"train step {dn}")
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"])),
              f"train step {dn}: loss {losses[-1]}")
    ms = statistics.median(times)
    out = dict(B=B, dtype=dn, steps=n_steps, warmup_s=warm_s, ms_per_step=ms, ms_all=times,
               clips_per_s=1e3 * B / ms, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, loss=losses, grad_norm=float(m["grad_norm"]), step=state.step)
    del model, state, step, m
    torch.cuda.empty_cache()
    return out


def phase_train_headline(card):
    from mcvd_tpu_torch.config import flagship_config

    launches, step_ms = {}, {}
    for dn in ("float32", "bfloat16"):
        out = train_steps(flagship_config(), dn, 5, TRAIN_LAUNCHES)
        launches[dn], step_ms[dn] = out["launches"], out["ms_per_step"]
        emit("train_headline", card=card, **out)
    return launches["float32"], step_ms


def phase_eval_nets(card):
    """The metric networks from seeded random weights in the real files'
    schemas, on the card against the same module on the CPU (fp32, TF32
    off): I3D on 2 videos of 16 frames (64 px, resized to 224), NCDHW and
    channels_last_3d; LPIPS on 64 frame pairs of 128 px; the simple 2d
    Inception and the TorchScript stand-in on 64 frames of 64 px. Device ms
    per video, frame pair or image."""
    import copy

    from mcvd_tpu_torch.eval import i3d as I3D
    from mcvd_tpu_torch.eval import lpips as LP
    from mcvd_tpu_torch.eval import standins
    from mcvd_tpu_torch.tools.profile_gn2 import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    videos = torch.from_numpy(rng.rand(2, 16, 64, 64, 1).astype(np.float32))
    frames = [torch.from_numpy(rng.rand(64, 3, 128, 128).astype(np.float32)) * 2 - 1
              for _ in range(2)]
    images = torch.from_numpy(rng.rand(64, 3, 64, 64).astype(np.float32))
    lpips_net = LP.LPIPSAlex()
    lpips_net.load_state_dict(LP.convert_lpips_weights(
        standins.alexnet_features_state_dict(2), standins.lpips_lin_state_dict(1)))
    i3d = (I3D.build_embedder_from_state_dict(standins.i3d_state_dict(0)),
           [I3D.preprocess_videos(videos)], 2, "video")
    nets = {   # name: (CPU module, CPU inputs, items per call, unit, layout on the card)
        "i3d": (*i3d, None),
        "i3d_channels_last_3d": (*i3d, torch.channels_last_3d),
        "lpips": (lpips_net.eval(), frames, 64, "frame pair", None),
        "inception_simple2d": (I3D.build_embedder_from_state_dict(
            standins.simple_state_dict(3, 2, feat_dim=2048)), [images], 64, "image", None),
        "inception_torchscript": (standins.tiny_inception(3), [images], 64, "image", None),
    }
    out = {}
    with torch.inference_mode():
        pre_gpu = I3D.preprocess_videos(videos.cuda())
        err = float((pre_gpu.cpu() - nets["i3d"][1][0]).abs().max())
        check(err <= 1e-5, f"preprocess_videos on the card: {err}")
        out["i3d_preprocess"] = dict(max_abs_err=err, ms_per_video=device_ms(
            lambda: I3D.preprocess_videos(videos.cuda()), n=3, reps=3) / 2)
        for name, (net, inputs, per, unit, fmt) in nets.items():
            want = net(*inputs)
            gnet = copy.deepcopy(net).cuda()
            ginp = [x.cuda() for x in inputs]
            if fmt is not None:
                gnet = gnet.to(memory_format=fmt)
                ginp = [x.contiguous(memory_format=fmt) for x in ginp]
            got = gnet(*ginp).cpu()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(bool(torch.isfinite(got).all()) and err <= EVAL_NET_REL * scale,
                  f"{name} on the card: max abs err {err}, largest output {scale}")
            ms = device_ms(lambda: gnet(*ginp), n=3, reps=3)
            out[name] = {"max_abs_err": err, "largest_output": scale, "out_shape": list(got.shape),
                         "items_per_call": per, f"ms_per_{unit.replace(' ', '_')}": ms / per,
                         "ms_per_call": ms}
            del gnet, ginp
    torch.cuda.empty_cache()
    emit("eval_nets", card=card, rel_tol=EVAL_NET_REL, nets=out)


def run_cli(exp, n_iters, *flags, mods=(), config=CLI_CONFIG, base_mods=CLI_MODS,
            data_path=None):
    """One run of `python -m mcvd_tpu_torch.main` on `config` in a subprocess
    from the repo's root: (its log, the kernel launch counts it logged at its
    end, its wall seconds). The process starts with every count at 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mcvd_tpu_torch.main", "--config", config, "--exp", exp,
           "--data_path", data_path or os.path.join(exp, "data"), "--ni", *flags,
           "--config_mod", *base_mods, f"training.n_iters={n_iters}", *mods]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    check(out.returncode == 0, f"cli {flags}: exit {out.returncode}\n{out.stderr[-4000:]}")
    counts = re.findall(r"kernel launches: (\{.*\})", out.stderr)
    check(len(counts) == 1, f"cli {flags}: no launch count line")
    return out.stderr, json.loads(counts[0]), wall_s


def _steps(log):
    """{step: ms} of the runner's log lines (log_freq 1: each step alone)."""
    return {int(a): float(b) for a, b in
            re.findall(r"step (\d+) \| loss \S+ \| grad \S+ \| \S+ steps/s \| "
                       r"([\d.]+) ms/step", log)}


def _steps_waits(log):
    """{step: (loss, ms, ms the loop waited on the loader)} of the runner's
    log lines."""
    return {int(a): (float(b), float(c), float(d)) for a, b, c, d in
            re.findall(r"step (\d+) \| loss (\S+) \| grad \S+ \| \S+ steps/s \| "
                       r"([\d.]+) ms/step \| ([\d.]+) ms/step waiting on data", log)}


def _finite_metrics(d, what):
    out = {}
    for k in ("mse", "psnr", "ssim"):
        v = d[k]["value"] if isinstance(d[k], dict) else d[k]
        check(isinstance(v, float) and np.isfinite(v), f"{what}: {k} = {v}")
        out[k] = v
    return out


def _finite(v, what):
    check(isinstance(v, float) and np.isfinite(v), f"{what} = {v}")
    return v


def _eval_modes(exp, runs):
    """The checks of the evaluation modes' runs (their files, finite
    metrics); returns what the cli line reports of them."""
    from mcvd_tpu_torch.compat import yaml_subset

    logs, images = os.path.join(exp, "logs"), os.path.join(exp, "image_samples", "images")
    out = {}
    vid = yaml_subset.load_file(os.path.join(exp, "video_samples", "videos", "vid_metrics.yml"))
    out["video_gen"] = {k: _finite(vid.get(k), f"vid_metrics.yml {k}")
                        for k in ("mse", "psnr", "ssim", "lpips", "fvd")}
    check(out["video_gen"]["lpips"] > 0, "video_gen: lpips is 0")
    log = runs["video_gen"]["log"]
    check("FVD: I3D from" in log and "LPIPS: lin heads" in log and "metric left out" not in log,
          "video_gen: FVD or LPIPS was not built")
    losses = runs["test"]["yml"]
    check(sorted(losses) == [3, 6, 9], f"test_losses.yml checkpoints {sorted(losses)}")
    out["test"] = {k: _finite(v, f"test loss of {k}") for k, v in losses.items()}
    npz = np.load(os.path.join(images, "samples_9.npz"), allow_pickle=True)
    shapes = {k: npz[k].shape for k in ("samples", "real", "cond")}
    check(all(v == (16, 64, 64, 5) for v in shapes.values()), f"samples_9.npz {shapes}")
    check(np.isfinite(npz["samples"]).all() and 0 <= npz["samples"].min()
          and npz["samples"].max() <= 1, "samples_9.npz: samples outside [0, 1]")
    out["sample"] = {k: list(v) for k, v in shapes.items()}
    shards = sorted(f for f in os.listdir(images) if f.startswith("fid_samples_9_"))
    check(shards == ["fid_samples_9_00000.npz", "fid_samples_9_00001.npz"],
          f"FID sample shards {shards}")
    for f in shards:
        a = np.load(os.path.join(images, f))["samples"]
        check(a.shape == (16, 64, 64, 5) and np.isfinite(a).all(), f"{f}: {a.shape}")
    out["sample_fid_shards"] = len(shards)
    for name, tags in (("fast_fid", ["6", "9"]), ("fast_fid_ensemble", ["6_ens1", "9_ens2"])):
        fids = runs[name]["yml"]
        check(sorted(fids) == [6, 9], f"{name}: fids.yml checkpoints {sorted(fids)}")
        out[name] = {k: {m: _finite(v[m], f"{name} {k} {m}")
                         for m in ("fid", "precision", "recall")} for k, v in fids.items()}
        for t in tags:
            feats = np.load(os.path.join(images, f"feats_{t}.npy"))
            imgs = np.load(os.path.join(images, f"samples_{t}.npy"))
            check(feats.shape == (80, 64) and imgs.shape == (80, 64, 64, 1),
                  f"{name}: caches of {t}: {feats.shape}, {imgs.shape}")
    check(runs["fast_fid_cached"]["yml"] == runs["fast_fid"]["yml"],
          "fast_fid from its caches gave other numbers")
    check(runs["fast_fid_cached"]["log"].count("features read from") == 2
          and "loaded real features" in runs["fast_fid_ensemble"]["log"],
          "fast_fid did not read its caches")
    check("ensemble" in runs["fast_fid_ensemble"]["log"], "fast_fid ensemble: no ensemble")
    return out


def check_checkpoint(logs, config_path, step, mods=CLI_MODS):
    """checkpoint_{step} loaded into a fresh state (other weights) of the
    config's model (with `mods`), here: the same bits as the file
    (parameters, EMA, Adam's moments). Returns the number of tensors
    compared."""
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.train import checkpoints, create_train_state

    name = f"checkpoint_{step}"
    config = load_config(repo_path(config_path), mods)
    model = get_model(config, generator=torch.Generator().manual_seed(99), device="cuda")
    state = checkpoints.load_checkpoint(
        logs, name=name, target=create_train_state(config, model, device="cuda"))
    saved = torch.load(os.path.join(logs, name), map_location="cpu", weights_only=True)
    check(state.step == saved["step"] == step, f"{name} at step {state.step}")
    pairs = [(saved["params"], dict(model.named_parameters())),
             (saved["ema_params"], state.ema_params)]
    pairs += [(saved["opt_state"][k], state.opt_state[k]) for k in ("mu", "nu")]
    n_tensors = 0
    for want, got in pairs:
        check(want.keys() == got.keys(), f"{name}: other tensors")
        for k, t in want.items():
            check(torch.equal(got[k].detach().cpu(), t), f"{name}: {k} differs")
            n_tensors += 1
    del model, state, saved, pairs
    torch.cuda.empty_cache()
    return n_tensors


def cli_spade():
    """The SPADE runs (`CLI_SPADE_RUNS`) in an experiment of their own:
    steps 1-3, checkpoint_3 loaded bit-equal, finite metrics of the
    in-training and the DDIM video_gen, exact launch counts. They share the
    card with the flagship's evaluation modes, so their times are reported
    as `*_card_shared`."""
    from mcvd_tpu_torch.compat import yaml_subset

    with tempfile.TemporaryDirectory(prefix="mcvd_cli_spade_") as exp:
        runs = {}
        for name, n_iters, flags, mods in CLI_SPADE_RUNS:
            log, launches, wall_s = run_cli(exp, n_iters, *flags, mods=mods,
                                            config=SPADE_CONFIG)
            check_launches(launches, CLI_LAUNCHES[name], f"cli {name}")
            runs[name] = dict(log=log, launches=launches, wall_s=wall_s)
        logs = os.path.join(exp, "logs")
        steps = _steps(runs["spade_train"]["log"])
        check(sorted(steps) == [1, 2, 3] and "training done at step 3" in
              runs["spade_train"]["log"], f"cli spade train: steps {sorted(steps)}")
        n_tensors = check_checkpoint(logs, SPADE_CONFIG, 3)
        best = _finite_metrics(
            yaml_subset.load_file(os.path.join(logs, "best_metrics.yml")),
            "spade best_metrics.yml")
        vid = _finite_metrics(yaml_subset.load_file(
            os.path.join(exp, "video_samples", "videos", "vid_metrics.yml")),
            "spade DDIM vid_metrics.yml")
    return dict(config=SPADE_CONFIG, runs=[(n, f, m) for n, _, f, m in CLI_SPADE_RUNS],
                ms_by_step_card_shared=steps, checkpoint_tensors_bit_equal=n_tensors,
                best_metrics=best, ddim_vid_metrics=vid,
                wall_s_card_shared={k: r["wall_s"] for k, r in runs.items()},
                launches={k: r["launches"] for k, r in runs.items()})


def phase_cli(card, headline_ms):
    from mcvd_tpu_torch.compat import yaml_subset
    from mcvd_tpu_torch.eval import standins

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mcvd_cli_") as exp:
        wdir = os.path.join(exp, "weights")
        standins.write_standins(wdir, seed=0)
        fill = {"w": wdir, "feats": os.path.join(exp, "feats")}
        logs = os.path.join(exp, "logs")
        yml_of = {"test": "test_losses.yml", "fast_fid": "fids.yml",
                  "fast_fid_ensemble": "fids.yml", "fast_fid_cached": "fids.yml"}
        runs = {}
        with ThreadPoolExecutor(1) as beside:
            spade = None
            for name, n_iters, flags, mods in CLI_RUNS:
                log, launches, wall_s = run_cli(exp, n_iters,
                                                *[f.format(**fill) for f in flags],
                                                mods=[m.format(**fill) for m in mods])
                check_launches(launches, CLI_LAUNCHES[name], f"cli {name}")
                # the runs after CLI_SPADE_AFTER share the card with cli_spade
                runs[name] = dict(log=log, launches=launches, shared=spade is not None,
                                  wall_s=wall_s)
                if name in yml_of:   # read before the next run rewrites it
                    runs[name]["yml"] = yaml_subset.load_file(os.path.join(logs, yml_of[name]))
                if name == CLI_SPADE_AFTER:   # the timed runs are done
                    spade = beside.submit(cli_spade)
            spade = spade.result()
        t1, t2 = _steps(runs["train"]["log"]), _steps(runs["resume"]["log"])
        check(sorted(t1) == [1, 2, 3, 4, 5, 6] and "training done at step 6" in
              runs["train"]["log"], f"cli train: steps {sorted(t1)}")
        check("resumed from step 6" in runs["resume"]["log"] and sorted(t2) == [7, 8, 9]
              and "training done at step 9" in runs["resume"]["log"],
              f"cli resume: steps {sorted(t2)}")
        n_tensors = check_checkpoint(logs, CLI_CONFIG, 6)
        best = _finite_metrics(
            yaml_subset.load_file(os.path.join(logs, "best_metrics.yml")), "best_metrics.yml")
        vg = re.findall(r"video_gen: ([\d.]+) s for the harness", runs["video_gen"]["log"])
        check(len(vg) == 1, "cli video_gen: no harness time")
        evals = _eval_modes(exp, runs)
    steady = {s: ms for s, ms in {**t1, **t2}.items() if s not in (1, 7)}
    loop_ms = statistics.median(steady.values())
    emit("cli", card=card, config=CLI_CONFIG, config_mod=CLI_MODS,
         runs=[(n, f, m) for n, _, f, m in CLI_RUNS], B=64, dtype="float32",
         loop_ms_per_step=loop_ms, loop_ms_by_step={**t1, **t2},
         warmup_s={"train step 1": t1[1] / 1e3, "resume step 7": t2[7] / 1e3},
         train_headline_fp32_ms=headline_ms["float32"],
         loop_minus_headline_ms=loop_ms - headline_ms["float32"],
         video_gen_harness_s=float(vg[0]),
         wall_s={k: r["wall_s"] for k, r in runs.items() if not r["shared"]},
         wall_s_card_shared={k: r["wall_s"] for k, r in runs.items() if r["shared"]},
         launches={k: r["launches"] for k, r in runs.items()},
         checkpoint_tensors_bit_equal=n_tensors, best_metrics=best, eval_modes=evals,
         spade=spade)
    return {k: r["launches"] for k, r in runs.items()}


def run_ranks(cmd, n, backend=None):
    """`cmd` as the n ranks of one group from the repo's root
    (`parallel.launch.spawn_ranks`), `backend` as MCVD_DIST_BACKEND, each
    rank killed past DDP_TIMEOUT_S."""
    from mcvd_tpu_torch.parallel.launch import spawn_ranks

    env = dict(os.environ, **({"MCVD_DIST_BACKEND": backend} if backend else {}))
    return spawn_ranks(cmd, n, timeout=DDP_TIMEOUT_S, env=env, cwd=repo_path("."))


def ddp_check_run(n, backend, device):
    """`tools.ddp_check` on n ranks: its JSON line (every check held) and
    the wall seconds."""
    with tempfile.TemporaryDirectory(prefix="mcvd_ddp_") as d:
        out = os.path.join(d, "ddp.json")
        outs, wall_s = run_ranks([sys.executable, "-m", "mcvd_tpu_torch.tools.ddp_check",
                                  "--device", device, "--out", out], n, backend)
        for r, (rc, o, e) in enumerate(outs):
            check(rc == 0, f"ddp_check rank {r} of {n} ({backend or 'nccl'}): exit {rc}\n"
                           f"{o[-2000:]}\n{e[-4000:]}")
        with open(out) as f:
            res = json.load(f)
    check(res["ok"] and res["world"] == n and res["backend"] == (backend or "nccl"),
          f"ddp_check {n} ranks: {res}")
    return res, wall_s


def _rank_lines(logs, pattern, what):
    """Each rank's matches of `pattern`, the same on every rank, non-empty."""
    found = [re.findall(pattern, log) for log in logs]
    check(found[0] and all(f == found[0] for f in found), f"{what} differ across ranks: {found}")
    return found[0]


def ddp_cli(beside):
    """The flagship's CLI on DDP_RANKS gloo ranks of the one card
    (`DDP_CLI_RUNS`): exit 0, exact launch counts on each rank, one
    checkpoint file a name written by rank 0 alone, no log file lines or
    meters from rank 1, checkpoint_2 read back bit-equal, and the same
    finite losses, snapshot, test and video_gen metrics in each rank's log.
    `beside()` runs beside --test and --video_gen; returns (the phase's
    payload, what `beside` returned)."""
    from mcvd_tpu_torch.compat import yaml_subset

    from concurrent.futures import ThreadPoolExecutor

    with tempfile.TemporaryDirectory(prefix="mcvd_ddp_cli_") as exp:
        def launch(flags):
            return run_ranks([sys.executable, "-m", "mcvd_tpu_torch.main", "--config", CLI_CONFIG,
                              "--exp", exp, "--data_path", os.path.join(exp, "data"), "--ni",
                              "--device", "cuda:0", *flags, "--config_mod", *DDP_CLI_MODS,
                              "training.n_iters=3"], DDP_RANKS, "gloo")

        done = {"train": launch(DDP_CLI_RUNS[0][1])}
        with ThreadPoolExecutor(3) as pool:   # both read checkpoint_2; other files
            later = {name: pool.submit(launch, flags) for name, flags in DDP_CLI_RUNS[1:]}
            other = pool.submit(beside)
            done.update({name: f.result() for name, f in later.items()})
            other = other.result()
        runs = {}
        for name, _ in DDP_CLI_RUNS:
            outs, wall_s = done[name]
            logs = []
            for r, (rc, _, err) in enumerate(outs):
                check(rc == 0, f"ddp cli {name} rank {r}: exit {rc}\n{err[-4000:]}")
                counts = re.findall(r"kernel launches: (\{.*\})", err)
                check(len(counts) == 1, f"ddp cli {name} rank {r}: no launch count line")
                check_launches(json.loads(counts[0]), DDP_CLI_LAUNCHES[name],
                               f"ddp cli {name} rank {r}")
                logs.append(err)
            runs[name] = dict(logs=logs, wall_s=wall_s)
        logs_dir = os.path.join(exp, "logs")
        train = runs["train"]["logs"]
        steps = [_steps_waits(log) for log in train]
        check(all(sorted(s) == [1, 2, 3] for s in steps)
              and all("training done at step 3" in log for log in train),
              f"ddp cli train: steps {[sorted(s) for s in steps]}")
        losses = [{k: v[0] for k, v in s.items()} for s in steps]
        check(losses[0] == losses[1] and all(np.isfinite(v) for v in losses[0].values()),
              f"ddp cli train: the ranks' losses {losses}")
        written = [re.findall(r"checkpoint written: (\S+)", log) for log in train]
        check([os.path.basename(w) for w in written[0]] == ["checkpoint_2", "checkpoint",
                                                            "checkpoint"]
              and written[1] == [], f"ddp cli train: checkpoints written {written}")
        check(["meters and plots written" in log for log in train] == [True, False],
              "ddp cli train: meters written by rank 1, or not by rank 0")
        names = sorted(os.listdir(logs_dir))
        check([f for f in names if "checkpoint" in f] == ["checkpoint", "checkpoint_2"],
              f"ddp cli: checkpoint files {names}")
        with open(os.path.join(logs_dir, "stdout.txt")) as f:
            text = f.read()
        check("rank 0 -" in text and "rank 1 -" not in text, "ddp cli: stdout.txt holds rank 1")
        snap = _rank_lines(train, r"snapshot metrics @2: (.*)", "snapshot metrics")
        best = _finite_metrics(yaml_subset.load_file(os.path.join(logs_dir, "best_metrics.yml")),
                               "ddp best_metrics.yml")
        test = _rank_lines(runs["test"]["logs"], r"ckpt (\S+): test DSM loss (\S+) over (\d+)",
                           "test losses")
        check([t[0] for t in test] == ["2"] and all(np.isfinite(float(t[1])) for t in test),
              f"ddp cli test: {test}")
        _rank_lines(runs["video_gen"]["logs"], r"video_gen metrics: (.*)", "video_gen metrics")
        vid = _finite_metrics(yaml_subset.load_file(
            os.path.join(exp, "video_samples", "videos", "vid_metrics.yml")), "ddp vid_metrics")
        n_tensors = check_checkpoint(logs_dir, CLI_CONFIG, 2, DDP_CLI_MODS)
    payload = dict(config=CLI_CONFIG, config_mod=DDP_CLI_MODS, runs=DDP_CLI_RUNS,
                   ranks=DDP_RANKS, loop_ms_by_step={r: {k: v[1] for k, v in s.items()}
                                                     for r, s in enumerate(steps)},
                   losses=losses[0], snapshot=snap[0], best_metrics=best,
                   test_loss={t[0]: float(t[1]) for t in test}, vid_metrics=vid,
                   checkpoint_tensors_bit_equal=n_tensors,
                   wall_s={k: r["wall_s"] for k, r in runs.items()})
    return other, payload


def upfirdn_cases():
    """`ops.upfirdn.upsample_2d_fast` against `models.resample.upsample_2d`
    at UPFIRDN_SHAPES, fp32 and bf16: max abs error within TOL, device ms of
    each."""
    from mcvd_tpu_torch.models.blocks import FIR_KERNEL
    from mcvd_tpu_torch.models.resample import upsample_2d
    from mcvd_tpu_torch.ops.upfirdn import upsample_2d_fast

    g = torch.Generator(device="cuda").manual_seed(21)
    out = []
    for shape in UPFIRDN_SHAPES:
        for dn in ("float32", "bfloat16"):
            x = torch.randn(shape, generator=g, device="cuda").to(getattr(torch, dn))
            x = x.contiguous(memory_format=torch.channels_last)
            err, ok = max_err(upsample_2d_fast(x, FIR_KERNEL), upsample_2d(x, FIR_KERNEL), dn)
            check(ok, f"upsample_2d_fast {shape} {dn}: max abs err {err}")
            out.append(dict(shape=list(shape), dtype=dn, max_abs_err=err,
                            polyphase_ms=kernel_ms(lambda: upsample_2d_fast(x, FIR_KERNEL)),
                            zero_stuffed_ms=kernel_ms(lambda: upsample_2d(x, FIR_KERNEL))))
    return out


def phase_ddp(card):
    """Data parallelism on the one card: `tools.ddp_check` on 2 gloo ranks
    (the step and a 10-step block held to one process, the ranks'
    parameters the same bits, exact launch counts per rank) and on 1 NCCL
    rank (beside the 2-rank --test and --video_gen, so its times share the
    card); the flagship's CLI on 2 gloo ranks (`ddp_cli`); the polyphase FIR
    (`upfirdn_cases`). Gloo on one card moves nothing over an interconnect:
    its all-reduce ms is not a multi-card rate."""
    torch.cuda.empty_cache()
    gloo, gloo_s = ddp_check_run(DDP_RANKS, "gloo", "cuda:0")
    (nccl, nccl_s), cli = ddp_cli(lambda: ddp_check_run(1, None, "cuda"))
    fir = upfirdn_cases()
    emit("ddp", card=card, ranks=DDP_RANKS, gloo_two_ranks=gloo, nccl_one_rank=nccl,
         wall_s={"gloo_check": gloo_s, "nccl_check": nccl_s},
         step_ms={"two_ranks_rank0": gloo["ranks"][0]["step_ms"],
                  "two_ranks_rank1": gloo["ranks"][1]["step_ms"],
                  "one_process": gloo["step_ms_one_process"]},
         allreduce_ms_gloo=gloo["allreduce_ms"], allreduce_ms_nccl_one_rank=nccl["allreduce_ms"],
         allreduce_floats=gloo["allreduce_floats"],
         peak_mem_gib_per_rank=[r["peak_mem_gib"] for r in gloo["ranks"]],
         cli=cli, upfirdn=fir)


def synth_video(name, v, shape, n=DATA_FRAMES):
    """Video `v` of dataset `name`: smooth waves that drift, in bands of 16
    grey levels (runs of equal pixels, which LZF shrinks), with every 13th
    frame, counted from a per-video phase, uniform noise (LZF does not: it is
    stored raw); uint8, from a generator seeded by (name, v)."""
    rng = np.random.default_rng([sum(name.encode()), v])
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy, ph, vx, vy = rng.uniform([0.05, 0.05, 0, 0.1, 0.1], [0.3, 0.3, 6, 0.6, 0.6])
    skip = int(rng.integers(13))
    frames = []
    for t in range(n):
        if (t + skip) % 13 == 0:
            frames.append(rng.integers(0, 256, shape, dtype=np.uint8))
            continue
        base = 128 + 60 * np.sin(fx * x + ph + vx * t) + 50 * np.cos(fy * y - vy * t)
        base = np.clip(base, 0, 255) // 16 * 16
        if len(shape) == 3:
            base = np.stack([base, 0.75 * base + 32, 255 - base][:shape[2]], -1)
        frames.append(base.astype(np.uint8))
    return frames


def write_data(root):
    """Each reader's tree under `root`, written by the port's makers:
    KTH (persons 1-20 train, 21-25 test, persons.pkl, uint8 targets), BAIR
    and Cityscapes (train/ and test/), UCF101 (one shard, num_train /
    num_test). Returns {name: [(directory, video ids)]} and the seconds and
    bytes of the writes."""
    import pickle

    from mcvd_tpu_torch.data import h5

    layout, t0, raw = {}, time.perf_counter(), 0
    for name, (_, shape, n_train, n_test) in DATA_SETS.items():
        d = os.path.join(root, name)
        if name == "kth64_big":
            m = h5.KTHMaker(d, video=True)
            persons = {p: [] for p in range(1, 26)}
            for v in range(n_train + n_test):
                p = v % 20 + 1 if v < n_train else 21 + v % 5
                m.add_data((synth_video(name, v, shape), p, v % 6), dtype="uint8")
                persons[p].append(v)
            m.close()
            with open(os.path.join(d, "persons.pkl"), "wb") as f:
                pickle.dump(persons, f)
            layout[name] = [(d, range(n_train + n_test))]
        elif name == "ucf101":
            m = h5.UCFMaker(d, video=True)
            for v in range(n_train + n_test):
                m.add_data((synth_video(name, v, shape), v % 101), dtype="uint8")
            m.writer.create_dataset("num_train", data=n_train)
            m.writer.create_dataset("num_test", data=n_test)
            m.close()
            layout[name] = [(d, range(n_train + n_test))]
        else:
            layout[name] = []
            for split, first, n in (("train", 0, n_train), ("test", n_train, n_test)):
                m = h5.HDF5Maker(os.path.join(d, split), video=True)
                for v in range(first, first + n):
                    m.add_data(synth_video(name, v, shape), dtype="uint8")
                m.close()
                layout[name].append((os.path.join(d, split), range(first, first + n)))
        raw += (n_train + n_test) * DATA_FRAMES * int(np.prod(shape))
    return layout, time.perf_counter() - t0, raw


def read_back(layout):
    """Every frame read back through the native LZF route equals what was
    written; the first videos of each split through the plain route too.
    Returns the raw and stored chunk counts."""
    from mcvd_tpu_torch.data import h5, lzf

    counts = {"lzf_chunks": 0, "raw_chunks": 0, "frames": 0, "plain_frames": 0}
    for name, splits in layout.items():
        shape = DATA_SETS[name][1]
        for d, videos in splits:
            ds = h5.HDF5Dataset(d)
            check(len(ds) == len(videos), f"{name}: {len(ds)} videos in {d}")
            for i, v in enumerate(videos):
                want = synth_video(name, v, shape)
                shard, k = ds.get_indices(i)
                routes = [h5.open_shard(ds.shard_paths[shard])]
                if i < DATA_PLAIN_VIDEOS:
                    routes.append(h5.open_shard(ds.shard_paths[shard],
                                                decompress=lzf.decompress_plain))
                for f in routes:
                    check(int(f["len"][k][()]) == DATA_FRAMES, f"{name} {v}: len")
                    for t, fr in enumerate(want):
                        got = f[k][str(t)][()]
                        check(got.dtype == np.uint8 and np.array_equal(got, fr),
                              f"{name} video {v} frame {t} read back other bytes")
                counts["frames"] += DATA_FRAMES
                counts["plain_frames"] += DATA_FRAMES * (len(routes) - 1)
                for t in range(DATA_FRAMES):
                    for _, mask, _ in routes[0][k][str(t)].raw_chunks():
                        counts["raw_chunks" if mask & 1 else "lzf_chunks"] += 1
    check(counts["raw_chunks"] > 0 and counts["lzf_chunks"] > counts["raw_chunks"],
          f"chunks stored {counts}")
    return counts


def lzf_rates(layout):
    """Decode MB/s (decoded bytes) of the native and the plain LZF routes over
    the compressed chunks of Cityscapes' train shard, and the encode MB/s."""
    from mcvd_tpu_torch.data import h5, lzf

    d, _ = layout["cityscapes_big"][0]
    path = h5.HDF5Dataset(d).shard_paths[0]
    f = h5.open_shard(path)
    chunks = [(raw, int(np.prod(f[k][t].shape)))
              for k in f.keys() if k.isdigit() for t in f[k].keys()
              for _, mask, raw in f[k][t].raw_chunks() if not mask & 1]
    n_out = sum(n for _, n in chunks)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for raw, n in chunks:
            lzf.decompress(raw, n)
        times.append(time.perf_counter() - t0)
    plain = chunks[:16]
    t0 = time.perf_counter()
    for raw, n in plain:
        check(np.array_equal(lzf.decompress_plain(raw, n), lzf.decompress(raw, n)),
              "LZF: plain and native decoders disagree")
    plain_s = time.perf_counter() - t0
    frames = [lzf.decompress(raw, n) for raw, n in chunks[:64]]
    t0 = time.perf_counter()
    stored = [lzf.compress(fr) for fr in frames]
    enc_s = time.perf_counter() - t0
    return dict(chunks=len(chunks), decoded_mb=n_out / 1e6,
                stored_mb=sum(len(r) for r, _ in chunks) / 1e6,
                native_decode_mb_s=n_out / 1e6 / min(times),
                plain_decode_mb_s=sum(n for _, n in plain) / 1e6 / plain_s,
                native_encode_mb_s=sum(fr.size for fr in frames) / 1e6 / enc_s,
                encode_ratio=sum(len(e) for e in stored if e) / sum(fr.size for fr in frames))


def loader_rates(root):
    """Each reader through `DataLoader` at its config's batch (64), as the
    CLI's training loop builds it (`get_dataset`, clips of num_frames_cond +
    num_frames frames), with 0 and 4 worker threads: the first batch with the
    cache cold, then `DATA_WARM_BATCHES` warm; the two worker counts give the
    same batches."""
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.data import DataLoader, get_dataset

    out = {}
    for name, (cfg, *_rest) in DATA_SETS.items():
        config = load_config(repo_path(cfg))
        B = config.training.batch_size
        firsts, rates = [], {}
        for nw in DATA_WORKERS:
            train, _ = get_dataset(os.path.join(root, name), config,
                                   video_frames_pred=config.data.num_frames)
            it = iter(DataLoader(train, batch_size=B, shuffle=True, seed=0, drop_last=True,
                                 repeat=True, num_workers=nw))
            t0 = time.perf_counter()
            xs, _ = next(it)
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(DATA_WARM_BATCHES):
                next(it)
            warm = (time.perf_counter() - t0) / DATA_WARM_BATCHES
            it.close()
            firsts.append(xs)
            rates[f"workers_{nw}"] = dict(cold_clips_per_s=B / cold,
                                          warm_clips_per_s=B / warm, cold_s=cold,
                                          warm_s=warm)
        check(all(np.array_equal(firsts[0], x) for x in firsts[1:]),
              f"{name}: the worker counts gave other batches")
        d = config.data
        check(firsts[0].shape == (B, d.num_frames_cond + d.num_frames, d.image_size,
                                  d.image_size, d.channels) and firsts[0].dtype == np.float32,
              f"{name}: batch {firsts[0].shape}")
        out[name] = dict(B=B, clip_shape=list(firsts[0].shape[1:]), **rates)
    return out


def smmnist_rates():
    """SMMNIST's batch path (the host synthesizer) against its per-item path,
    at the flagship's B=64 and 10 frames."""
    from mcvd_tpu_torch.config import flagship_config
    from mcvd_tpu_torch.data import StochasticMovingMNIST

    d = flagship_config().data
    with tempfile.TemporaryDirectory(prefix="mcvd_mnist_") as tmp:
        ds = StochasticMovingMNIST(tmp, seq_len=d.num_frames_cond + d.num_frames,
                                   num_digits=d.num_digits, image_size=d.image_size)
    idx = np.arange(64)
    t0 = time.perf_counter()
    for _ in range(5):
        xb, _ = ds.get_batch(idx)
    batch_s = (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    xi = np.stack([ds[int(i)][0] for i in idx])
    item_s = time.perf_counter() - t0
    check(xb.shape == xi.shape and np.isfinite(xb).all() and 0 <= xb.min() and xb.max() <= 1,
          f"smmnist get_batch {xb.shape}")
    return dict(B=64, frames=int(xb.shape[1]), get_batch_clips_per_s=64 / batch_s,
                per_item_clips_per_s=64 / item_s)


def phase_data(card, root):
    """The data readers on the card's host: synthetic shards written by the
    port's HDF5Maker in each reader's layout, read back bit-equal through
    the native and the plain LZF decoders; LZF MB/s; each reader's clips/s
    through the loader; SMMNIST's batch path against its per-item path."""
    layout, write_s, raw = write_data(root)
    t0 = time.perf_counter()
    counts = read_back(layout)
    read_s = time.perf_counter() - t0
    stored = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(root)
                 for f in fs if f.endswith(".hdf5"))
    emit("data", card=card, videos={k: v[2:] for k, v in DATA_SETS.items()},
         frames=DATA_FRAMES, write_s=write_s, raw_mb=raw / 1e6, stored_mb=stored / 1e6,
         read_back_s=read_s, read_back=counts, lzf=lzf_rates(layout),
         loader=loader_rates(root), smmnist=smmnist_rates())
    return layout


def cli_data_launches(config, runs):
    """Each run's launches: a training step's GroupNorm and attention calls
    forward and backward, one validation evaluation, and BLOCK evaluations a
    block of video_gen."""
    n_gn, n_attn = model_calls(config, 1)
    blocks = -(-10 // config.data.num_frames)   # sampling.num_frames_pred=10
    out = {}
    for name, n_iters, flags, _ in runs:
        steps, evals = (n_iters, 1) if "--train" in flags else (0, BLOCK * blocks)
        out[name] = {"gn_fused": n_gn * (steps + evals), "gn_fused_bwd": n_gn * steps,
                     "attention_fwd": n_attn * (steps + evals),
                     "attention_bwd": n_attn * steps}
    return out


def phase_cli_data(card, root):
    """The CLI on the data phase's shards (`CLI_DATA_RUNS`), at the configs'
    full width: exact launch counts, the checkpoint loaded bit-equal, a finite
    loss and finite metrics; the loop's ms a step and its wait on the
    loader."""
    from mcvd_tpu_torch.compat import yaml_subset
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.eval import standins

    out = {}
    for name, runs in CLI_DATA_RUNS:
        cfg = DATA_SETS[name][0]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix=f"mcvd_cli_{name}_") as exp:
            wdir = os.path.join(exp, "weights")
            standins.write_standins(wdir, seed=0)
            config = load_config(repo_path(cfg))
            want = cli_data_launches(config, runs)
            res = {}
            for run, n_iters, flags, mods in runs:
                mods = [m.format(w=wdir) for m in mods]
                base = [*CLI_DATA_MODS, f"training.snapshot_freq={n_iters}",
                        f"training.val_freq={n_iters}"]
                log, launches, wall_s = run_cli(exp, n_iters, *flags, mods=mods, config=cfg,
                                                base_mods=base,
                                                data_path=os.path.join(root, name))
                check_launches(launches, want[run], f"cli {name} {run}")
                res[run] = dict(launches=launches, wall_s=wall_s)
                if "--train" in flags:
                    steps = _steps_waits(log)
                    check(sorted(steps) == list(range(1, n_iters + 1))
                          and f"training done at step {n_iters}" in log,
                          f"cli {name}: steps {sorted(steps)}")
                    check(all(np.isfinite(v[0]) for v in steps.values()),
                          f"cli {name}: losses {steps}")
                    check("test loss" in log, f"cli {name}: no validation loss")
                    res[run].update(
                        ms_by_step={k: v[1] for k, v in steps.items()},
                        wait_ms_by_step={k: v[2] for k, v in steps.items()},
                        loss_by_step={k: v[0] for k, v in steps.items()},
                        checkpoint_tensors_bit_equal=check_checkpoint(
                            os.path.join(exp, "logs"), cfg, n_iters))
                else:
                    vid = yaml_subset.load_file(
                        os.path.join(exp, "video_samples", "videos", "vid_metrics.yml"))
                    res[run]["vid_metrics"] = {k: _finite(vid.get(k), f"{name} {k}")
                                               for k in ("mse", "psnr", "ssim", "lpips", "fvd")}
            mods_all = {r: m for r, _, _, m in runs}
            out[name] = dict(config=cfg, runs=res, mods=mods_all,
                             B=next((int(m.split("=")[1]) for m in mods_all["train"]
                                     if m.startswith("training.batch_size")),
                                    config.training.batch_size),
                             num_workers=int(getattr(config.data, "num_workers", 0) or 0))
    emit("cli_data", card=card, config_mod=CLI_DATA_MODS, dtype="float32", configs=out)
    return out


# The images phase: the image readers without PIL (CelebA, LSUN, ImageFolder)
# on the card machine's host, the codecs held to the committed goldens (PIL's
# decodes and resizes, tests/golden/images.npz), the kernels at celeba.yml's
# shapes, and the CLI on celeba.yml and church.yml.
IMAGES_GOLDEN = "tests/golden/images.npz"
IMAGES_FILES = 256          # files (LMDB values) in each reader's tree, copied from the goldens
IMAGES_B = 128              # the ymls' batch
IMAGES_WORKERS = (0, 4)
IMAGES_MIN_S = 0.25         # each codec's rate: decodes repeated for at least this long
CELEBA_CONFIG = "configs/celeba.yml"
CELEBA_PARAMS = 53_417_859  # the port's NCSN++ at ngf 128, 64 px
CELEBA_CALLS = (67, 10)     # GroupNorm and attention calls of one evaluation
CELEBA_B = 16
CHURCH_CONFIG = "configs/church.yml"
# The CLI: celeba.yml --train to 3 at B=16 and church.yml --train to 2 at the
# yml's B=128 on an LMDB of WebP values, each validating once at its last step
# (no in-training video_gen: on an unconditional image config it fails in
# both packages, ROADMAP Queue 3 F4).
IMAGES_CLI_MODS = ["training.snapshot_sampling=False", "training.log_freq=1"]
IMAGES_CLI_RUNS = [   # (name, yml, tree, n_iters, config mods)
    ("celeba", CELEBA_CONFIG, "celeba", 3, [f"training.batch_size={CELEBA_B}"]),
    ("church", CHURCH_CONFIG, "lsun", 2, []),
]
FID_PR_IMAGES = 64   # images in each .npz set of the fid_pr run


def _bmp24(img):
    """A bottom-up 24-bit BMP of (H, W, 3) uint8 (the BMP rate's input)."""
    h, w = img.shape[:2]
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    head = b"BM" + (54 + rows.size).to_bytes(4, "little") + bytes(4) + (54).to_bytes(4, "little")
    info = (40).to_bytes(4, "little") + w.to_bytes(4, "little") + h.to_bytes(4, "little") + \
        (1).to_bytes(2, "little") + (24).to_bytes(2, "little") + bytes(24)
    return head + info + rows.tobytes()


def images_goldens():
    """Every committed golden decoded by the port, bit-equal to PIL's decode
    stored beside it, and the datasets' transforms bit-equal to PIL's resizes;
    then each codec's decode rate (MB/s of encoded input and of RGB output,
    images/s) on the real-size images."""
    from mcvd_tpu_torch.data import codecs, image_datasets
    from mcvd_tpu_torch.data.resize import resize_bilinear

    with np.load(repo_path(IMAGES_GOLDEN)) as z:
        stored = {k: z[k] for k in z.files}
    decoded, by_format = {}, {}
    for key in sorted(stored):
        kind, name = key.split(":", 1)
        if kind != "dec":
            continue
        data = stored[f"enc:{name}"].tobytes()
        got = codecs.decode_image(data)
        check(got.shape == stored[key].shape and np.array_equal(got, stored[key]),
              f"images: golden {name} decodes other than PIL")
        decoded[name] = got
        fmt = codecs.image_format(data)
        by_format[fmt] = by_format.get(fmt, 0) + 1
    resized = 0
    for key in sorted(k for k in stored if k.startswith("rsz:")):
        _, name, kind, size = key.split(":")
        src, size = decoded[name], int(size)
        got = (resize_bilinear(image_datasets._center_crop(src, 140), (size, size))
               if kind == "crop140" else image_datasets._resize_short_side_crop(src, size))
        check(np.array_equal(got, stored[key]), f"images: resize {key} other than PIL's")
        resized += 1
    inputs = {"jpeg_celeba_178x218": stored["enc:celeba"].tobytes(),
              "jpeg_imagenet_500x375": stored["enc:imagenet"].tobytes(),
              "webp_lsun_341x256": stored["enc:lsun"].tobytes(),
              "png_500x375": codecs.encode_png(decoded["imagenet"]),
              "bmp_500x375": _bmp24(decoded["imagenet"])}
    rates = {}
    for name, data in inputs.items():
        out = codecs.decode_image(data)
        n, t0 = 0, time.perf_counter()
        while True:
            codecs.decode_image(data)
            n += 1
            s = time.perf_counter() - t0
            if s >= IMAGES_MIN_S:
                break
        rates[name] = dict(encoded_bytes=len(data), shape=list(out.shape), decodes=n,
                           images_per_s=n / s, encoded_mb_s=n * len(data) / 1e6 / s,
                           decoded_mb_s=n * out.size / 1e6 / s)
    return dict(decoded=len(decoded), by_format=by_format, resized=resized,
                golden_bytes=os.path.getsize(repo_path(IMAGES_GOLDEN)), rates=rates), stored


def write_image_trees(root, stored):
    """The readers' trees, each of IMAGES_FILES images copied from the
    goldens: CelebA's layout (JPEG 178x218, all train but 16 test), LSUN's
    LMDB (WebP 341x256, church_outdoor train and val) written by the port's
    write_lmdb, ImageNet's folders (JPEG 500x375, two classes, train and
    val)."""
    from mcvd_tpu_torch.data.lmdb_io import write_lmdb

    celeba = stored["enc:celeba"].tobytes()
    d = os.path.join(root, "celeba", "celeba", "img_align_celeba")
    os.makedirs(d)
    lines = []
    for i in range(IMAGES_FILES + 16):
        with open(os.path.join(d, f"{i:06d}.jpg"), "wb") as f:
            f.write(celeba)
        lines.append(f"{i:06d}.jpg {0 if i < IMAGES_FILES else 2}")
    with open(os.path.join(root, "celeba", "celeba", "list_eval_partition.txt"), "w") as f:
        f.write("\n".join(lines))
    lsun = stored["enc:lsun"].tobytes()
    for split, n in (("train", IMAGES_FILES), ("val", 16)):
        write_lmdb(os.path.join(root, "lsun", f"church_outdoor_{split}_lmdb"),
                   [(f"{i:040x}".encode(), lsun) for i in range(n)])
    imagenet = stored["enc:imagenet"].tobytes()
    for split, n in (("train", IMAGES_FILES // 2), ("val", 8)):
        for cls in ("n01440764", "n01443537"):
            d = os.path.join(root, "imagenet", split, cls)
            os.makedirs(d)
            for i in range(n):
                with open(os.path.join(d, f"{cls}_{i:05d}.JPEG"), "wb") as f:
                    f.write(imagenet)


def images_reader_rates(root):
    """Each reader through `DataLoader` at B=128 with 0 and 4 worker threads,
    as the CLI's loop builds it (`get_dataset` of the yml): the first batch
    and one more, items/s; the worker counts give the same batches."""
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.data import DataLoader, get_dataset

    readers = {"celeba_64": (CELEBA_CONFIG, "celeba", []),
               "lsun_64": (CHURCH_CONFIG, "lsun", []),
               "lsun_128": (CHURCH_CONFIG, "lsun", ["data.image_size=128"]),
               "imagenet_64": (CELEBA_CONFIG, "imagenet", ["data.dataset=IMAGENET"])}
    out = {}
    for name, (cfg, tree, mods) in readers.items():
        config = load_config(repo_path(cfg), mods)
        firsts, rates = [], {}
        for nw in IMAGES_WORKERS:
            train, _ = get_dataset(os.path.join(root, tree), config, video_frames_pred=1)
            it = iter(DataLoader(train, batch_size=IMAGES_B, shuffle=True, seed=0,
                                 drop_last=True, repeat=True, num_workers=nw))
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                xs, _ = next(it)
                times.append(time.perf_counter() - t0)
                if len(times) == 1:
                    firsts.append(xs)
            it.close()
            rates[f"workers_{nw}"] = dict(first_items_per_s=IMAGES_B / times[0],
                                          second_items_per_s=IMAGES_B / times[1],
                                          batch_s=times)
        size = config.data.image_size
        check(firsts[0].shape == (IMAGES_B, 1, size, size, 3) and firsts[0].dtype == np.float32,
              f"images: {name} batch {firsts[0].shape}")
        check(all(np.array_equal(firsts[0], x) for x in firsts[1:]),
              f"images: {name}: the worker counts gave other batches")
        out[name] = dict(config=cfg, mods=mods, B=IMAGES_B, **rates,
                         speedup_4_over_0=rates["workers_4"]["second_items_per_s"]
                         / rates["workers_0"]["second_items_per_s"])
    return out


def images_kernel_cases():
    """Every distinct GroupNorm and attention call of one evaluation of
    celeba.yml's model at B=16, through the kernels against the plain
    versions, fp32, forward and backward, timed (small5's helpers)."""
    from mcvd_tpu_torch.config import load_config
    from mcvd_tpu_torch.tools.gn_calls import form, model_calls

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(50)
    gn, attn = model_calls(load_config(repo_path(CELEBA_CONFIG)), CELEBA_B)
    cases = []
    for key in dict.fromkeys(tuple(sorted(c.items())) for c in gn):
        c = dict(key)
        N = c["frames_last"]
        shape = (c["B"], c["C"] // N, c["H"], c["W"], N, form(c), c["num_groups"], c["eps"],
                 torch.float32)
        cases += [gn_fwd_case(g, *shape, compare=True), gn_bwd_case(g, *shape, compare=True)]
    for a in dict.fromkeys((a["B"], a["T"], a["heads"], a["D"]) for a in attn):
        cases += [attn_fwd_case(g, *a, torch.float32), attn_bwd_case(g, *a, torch.float32)]
    torch.cuda.synchronize()
    return cases


def images_model():
    """celeba.yml's NCSN++ at full width (random weights, zero-scale layers
    redrawn): one fp32 evaluation at B=16 through the kernels against
    `reference_ops()` (within TRAIN_GRAD_REL of the largest output), exact
    launch counts, the parameter count; one fp32 training step against
    `reference_ops()` (train_step_vs_plain)."""
    from mcvd_tpu_torch import ops
    from mcvd_tpu_torch.config import load_config

    config = load_config(repo_path(CELEBA_CONFIG))
    config.model.dropout = 0.0
    n_gn, n_attn = CELEBA_CALLS
    model = _slice_model(config, 60)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == CELEBA_PARAMS, f"celeba: {n_params} params, want {CELEBA_PARAMS}")
    g = torch.Generator(device="cuda").manual_seed(61)
    B, sz = CELEBA_B, config.data.image_size
    x = torch.randn(B, 3, sz, sz, generator=g, device="cuda")
    t = torch.randint(0, config.model.num_classes, (B,), generator=g, device="cuda")
    want_eval = {"gn_fused": n_gn, "attention_fwd": n_attn}
    model.eval()
    with torch.inference_mode():
        ops.reset_launches()
        got = model(x, t, None)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        check_launches(launches, want_eval, "celeba evaluation")
        with ops.reference_ops():
            want = model(x, t, None)
            plain_ms, _ = _seconds(lambda: model(x, t, None))
        ms, _ = _seconds(lambda: model(x, t, None))
    big, diff = float(want.abs().max()), float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and diff <= TRAIN_GRAD_REL * big,
          f"celeba evaluation: kernels vs plain max abs diff {diff}, largest {big}")
    step = train_step_vs_plain(config, 60, B, {**want_eval, "gn_fused_bwd": n_gn,
                                               "attention_bwd": n_attn}, "celeba",
                               model=model, exact_zero=exact_zero_grads(model))
    del model
    torch.cuda.empty_cache()
    return dict(params=n_params, B=B, eval=dict(max_abs_diff=diff, largest=big,
                                                launches=launches, ms=ms, plain_ms=plain_ms),
                train_step=step)


def images_cli(root):
    """--train on celeba.yml and church.yml (`IMAGES_CLI_RUNS`): exact launch
    counts, finite losses, the validation loss, the checkpoint loaded
    bit-equal; the loop's ms and wait on the loader a step."""
    out = {}
    for name, cfg, tree, n_iters, mods in IMAGES_CLI_RUNS:
        torch.cuda.empty_cache()
        n_gn, n_attn = CELEBA_CALLS if name == "celeba" else (0, 0)
        with tempfile.TemporaryDirectory(prefix=f"mcvd_cli_{name}_") as exp:
            base = [*IMAGES_CLI_MODS, f"training.checkpoint_freq={n_iters}",
                    f"training.snapshot_freq={n_iters}", f"training.val_freq={n_iters}"]
            log, launches, wall_s = run_cli(exp, n_iters, "--train", mods=mods, config=cfg,
                                            base_mods=base, data_path=os.path.join(root, tree))
            want = {"gn_fused": n_gn * (n_iters + 1), "gn_fused_bwd": n_gn * n_iters,
                    "attention_fwd": n_attn * (n_iters + 1), "attention_bwd": n_attn * n_iters}
            check_launches(launches, want, f"cli {name}")
            st = _steps_waits(log)
            check(sorted(st) == list(range(1, n_iters + 1))
                  and f"training done at step {n_iters}" in log
                  and all(np.isfinite(v[0]) for v in st.values()) and "test loss" in log,
                  f"cli {name}: steps {st}")
            out[name] = dict(
                config=cfg, mods=mods, launches=launches, wall_s=wall_s,
                ms_by_step={k: v[1] for k, v in st.items()},
                wait_ms_by_step={k: v[2] for k, v in st.items()},
                loss_by_step={k: v[0] for k, v in st.items()},
                checkpoint_tensors_bit_equal=check_checkpoint(os.path.join(exp, "logs"), cfg,
                                                              n_iters))
    return out


def images_grid_roundtrip():
    """`plots.save_video_grid` on the card machine's host: its PNG decoded by
    the port equal to `video_grid`, its GIF's size."""
    from mcvd_tpu_torch.data import codecs
    from mcvd_tpu_torch.runners import plots

    rng = np.random.default_rng(7)
    pred, real = (rng.random((8, 5, 64, 64, 3), np.float32) for _ in range(2))
    with tempfile.TemporaryDirectory(prefix="mcvd_grid_") as d:
        t0 = time.perf_counter()
        path = plots.save_video_grid(os.path.join(d, "g"), pred=pred, real=real)
        s = time.perf_counter() - t0
        with open(path, "rb") as f:
            got = codecs.decode_image(f.read())
        check(np.array_equal(got, plots.video_grid(pred=pred, real=real)),
              "images: the grid's PNG decodes other than the grid")
        gif_bytes = os.path.getsize(os.path.join(d, "g.gif"))
    return dict(grid_shape=list(got.shape), gif_frames=5, gif_bytes=gif_bytes, write_s=s)


def images_fid_pr():
    """The fid_pr tool's entry point (`python -m mcvd_tpu_torch.tools.fid_pr`'s
    `main`, in this process to spare a process start) on the card: two .npz
    sets of FID_PR_IMAGES 64-px images cut from the goldens, the stand-in
    Inception, the nearest-neighbour grid; FID, precision and recall
    finite."""
    from mcvd_tpu_torch.data import codecs
    from mcvd_tpu_torch.eval import standins
    from mcvd_tpu_torch.tools import fid_pr

    with np.load(repo_path(IMAGES_GOLDEN)) as z:
        src = codecs.decode_image(z["enc:imagenet"].tobytes()).astype(np.float32) / 255
    rng = np.random.default_rng(8)
    with tempfile.TemporaryDirectory(prefix="mcvd_fid_pr_") as d:
        paths = standins.write_standins(os.path.join(d, "w"), seed=0)
        for name, noise in (("real", 0.02), ("gen", 0.1)):
            ys, xs = rng.integers(0, 375 - 64, FID_PR_IMAGES), rng.integers(0, 500 - 64,
                                                                           FID_PR_IMAGES)
            imgs = np.stack([src[y:y + 64, x:x + 64] for y, x in zip(ys, xs)])
            np.savez(os.path.join(d, f"{name}.npz"),
                     np.clip(imgs + rng.normal(0, noise, imgs.shape), 0, 1).astype(np.float32))
        argv = [os.path.join(d, "real.npz"), os.path.join(d, "gen.npz"), "--weights",
                paths["inception"], "--nn", "3", "--nn-samples", "4", "--nn-out",
                os.path.join(d, "nn.png")]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            res = fid_pr.main(argv)
        wall_s = time.perf_counter() - t0
        check(json.loads(printed.getvalue().strip().splitlines()[-1]) == res,
              "fid_pr: its printed line is not its result")
        for k in ("fid", "precision", "recall"):
            _finite(float(res[k]), f"fid_pr {k}")
        with open(os.path.join(d, "nn.png"), "rb") as f:
            grid = codecs.decode_image(f.read())
        check(grid.shape == (4 * 64, 4 * 64, 3), f"fid_pr: nn grid {grid.shape}")
    return dict(result=res, wall_s=wall_s)


def phase_images(card):
    """The image readers without PIL, and the image configs' path on the
    card (see IMAGES_*): goldens and codec rates, the readers' items/s, the
    kernels at celeba's shapes and its model against `reference_ops()`, the
    sample grid's PNG and GIF, the CLI on celeba.yml and church.yml, and the
    fid_pr tool."""
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return r

    goldens, stored = part("goldens", images_goldens)
    with tempfile.TemporaryDirectory(prefix="mcvd_images_") as root:
        part("write_trees", write_image_trees, root, stored)
        readers = part("readers", images_reader_rates, root)
        cases = part("kernels", images_kernel_cases)
        model = part("model", images_model)
        grid = part("grid", images_grid_roundtrip)
        cli = part("cli", images_cli, root)
    fid = part("fid_pr", images_fid_pr)
    emit("images", card=card, goldens=goldens, readers=readers, kernel_cases=cases,
         celeba_model=model, grid=grid, cli=cli, cli_mods=IMAGES_CLI_MODS, fid_pr=fid,
         seconds=seconds)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import mcvd_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    card = timed("env", phase_env)
    timed("build", phase_build)
    cases, summary = timed("kernels", phase_kernels, card)
    timing, tool_launches = timed("profile_gn2", phase_profile_gn2, card, summary)
    timed("slice", phase_slice, card)
    launches = timed("headline", phase_headline, card)
    timed("spade", phase_spade, card)
    timed("samplers", phase_samplers, card)
    train_cases = timed("train_kernels", phase_train_kernels, card, summary)
    timed("train_slice", phase_train_slice, card)
    timed("wide_heads", phase_wide_heads, card)
    timed("small5", phase_small5, card)
    timed("smld", phase_smld, card)
    train_launches, headline_ms = timed("train_headline", phase_train_headline, card)
    timed("eval_nets", phase_eval_nets, card)
    timed("cli", phase_cli, card, headline_ms)
    timed("ddp", phase_ddp, card)
    with tempfile.TemporaryDirectory(prefix="mcvd_data_") as root:
        timed("data", phase_data, card, root)
        timed("cli_data", phase_cli_data, card, root)
    timed("images", phase_images, card)
    emit("phases", seconds=seconds)
    check("jax" not in sys.modules, "jax was imported")

    # times of the GroupNorm and attention kernels at the heaviest main-path
    # shape, in the headline's bf16
    gn_big = next(c for c in cases if c["op"] == "group_norm" and c["dtype"] == "bfloat16"
                  and (c["C"], c["H"], c["form"]) == (192, 64, "adagn_silu"))
    attn_big = next(c for c in cases if c["op"] == "attention" and c["dtype"] == "bfloat16"
                    and (c["T"], c["head_dim"]) == (1024, 64))
    timing["gn_fused"] = dict(ms=gn_big["ms"], plain_ms=gn_big["plain_ms"],
                              library_ms=None,   # no one call does GroupNorm + AdaGN + SiLU
                              bound=(gn_big["bound_ms"], gn_big["bound_by"]),
                              host_us=gn_big["host_us"])
    timing["attention_fwd"] = dict(ms=attn_big["ms"], plain_ms=attn_big["plain_ms"],
                                   library_ms=attn_big["library_ms"],
                                   bound=(attn_big["bound_ms"], attn_big["bound_by"]))
    # the backward kernels at the same shapes, in the training config's fp32
    for name, op, key in (("gn_fused_bwd", "group_norm_bwd", ("C", "H", "form")),
                          ("attention_bwd", "attention_bwd", ("T", "head_dim"))):
        want = (192, 64, "adagn_silu") if name == "gn_fused_bwd" else (1024, 64)
        c = next(c for c in train_cases if c["op"] == op and c["dtype"] == "float32"
                 and tuple(c[k] for k in key) == want)
        timing[name] = dict(ms=c["ms"], plain_ms=c["plain_ms"], library_ms=c["library_ms"],
                            bound=(c["bound_ms"], c["bound_by"]), dtype="float32")
    where = {   # name: (route, source, the TPU kernel it replaces, launches)
        "gn_fused": ("cuda", "mcvd_tpu_torch/csrc/groupnorm.cu",
                     "mcvd_tpu/ops/lab/groupnorm.py:409", launches),
        "attention_fwd": ("cuda", "mcvd_tpu_torch/csrc/attention_wgmma.cuh",
                          "mcvd_tpu/ops/lab/attention.py:60", launches),
        "fused_leaky_relu": ("triton", "mcvd_tpu_torch/ops/fused_act.py",
                             "mcvd_tpu/ops/fused_act.py:46", tool_launches),
        "gn_fused_bwd": ("cuda", "mcvd_tpu_torch/csrc/groupnorm.cu",
                         "mcvd_tpu/ops/lab/groupnorm.py:160", train_launches),
        "attention_bwd": ("cuda", "mcvd_tpu_torch/csrc/attention_wgmma.cuh",
                          "mcvd_tpu/ops/lab/attention.py:187", train_launches),
        "gn_copy": ("cuda", "mcvd_tpu_torch/csrc/profile_gn2.cu",
                    "tools/profile_gn2.py:65", tool_launches),
        "gn_variant": ("cuda", "mcvd_tpu_torch/csrc/profile_gn2.cu",
                       "tools/profile_gn2.py:145", tool_launches),
    }
    kernels = []
    for name, (route, source, replaces, counts) in where.items():
        t = timing[name]
        check(counts[name] > 0, f"{name} was not launched on its path")
        extra = {k: t[k] for k in ("host_us", "dtype") if k in t}
        if name == "gn_fused":   # it replaces the Pallas tiled path too
            extra["also_replaces"] = ["mcvd_tpu/ops/lab/groupnorm.py:283",
                                      "mcvd_tpu/ops/lab/groupnorm.py:324"]
        if name.endswith("_bwd"):   # counterparts of custom VJPs, not of Pallas bodies
            extra["counterpart_of"] = "the JAX custom VJP (jnp/einsum code XLA compiles)"
        if name == "attention_bwd":
            extra["also_replaces"] = ["mcvd_tpu/ops/lab/attention.py:78"]
        if name.startswith("attention"):   # the one route (attention_route) and its sources
            extra["routes"] = ATTN_ROUTES
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=counts[name], ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound"][0], bound_by=t["bound"][1],
                            library_ms=t["library_ms"], **extra, **summary[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
