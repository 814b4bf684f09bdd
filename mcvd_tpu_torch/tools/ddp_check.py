"""The data-parallel step and sampler held against one process.

    MCVD_DIST=1 MCVD_COORDINATOR=localhost:PORT MCVD_NUM_PROCESSES=P \\
        MCVD_PROCESS_ID=r [MCVD_DIST_BACKEND=gloo] \\
        python -m mcvd_tpu_torch.tools.ddp_check [--device cuda:0] [--out F]

Run once per rank. Every rank builds the flagship (or `--config` with
`--config_mod`) at its width from one seed, its zero-scale layers redrawn at
scale 1 (else most gradients are ~0), warmup 0, fp32 with TF32 off, and
then, as a rank of the group:

  1. broadcasts rank 0's train state (`train.broadcast_state_`) and takes one
     training step on its rows of a seeded global batch of `--batch` clips,
     its draws the global batch's (`parallel.draws.RowDraws`), timed after
     a warm-up step from the same state; its kernel launches counted (the
     model's GroupNorm and attention calls, forward and backward, on the
     card; none on the CPU);
  2. checks the ranks' parameters are the same bits (an all-gathered
     checksum of their int32 views);
  3. times `parallel.all_reduce_mean_` of the model's gradients (its
     parameters' shapes, fp32) over the group;
  4. runs a `--block_steps` DDPM block + denoise of the full batch through
     `parallel.wrap_chain`, each rank its rows, the launches counted;
  5. reports its peak device memory.

Then every rank leaves the group, and rank 0 alone repeats the step on the
full batch and the block from the same initial state and draws as one
process, and holds the group's results to it: the loss at rtol 1e-4, the
gradients (Adam's first moment after one step, through the clip) and second
moments at 1e-3 and 2e-3 of each tensor's largest, the parameters and EMA
as the card's train_slice check holds them, and the block at atol 5e-3. It
prints one JSON line (and writes it to `--out`) and exits 1 if any check
failed; a rank's own check failure exits 1 on that rank.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from .. import ops
from ..config import flagship_config, load_config
from ..diffusion import make_schedule
from ..eval.video_gen import make_block_sampler
from ..models import get_model
from ..models.layers import init_weights
from ..parallel import (all_reduce_mean_, gather_rows, init_from_env, rank, shard_rows,
                        shutdown, world, wrap_chain)
from ..parallel import dist as pdist
from ..train import broadcast_state_, create_train_state, make_train_step
from .gn_calls import model_calls

LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
BLOCK_ATOL = 5e-3
SEED = 10


def build(config, seed: int, device):
    """The model with its zero-scale layers redrawn at scale 1."""
    model = get_model(config, generator=torch.Generator().manual_seed(seed), device=device)
    for m in model.modules():
        if getattr(m, "init_scale", None) == 0.0:
            m.init_scale = 1.0
    init_weights(model, torch.Generator().manual_seed(seed + 1))
    return model


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_once(config, model, weights, X, seed: int, device):
    """One step from `weights` on X with a generator seeded `seed`: (state
    snapshot, metrics, ms, launches)."""
    model.load_state_dict(weights)
    state = create_train_state(config, model, device=device)
    broadcast_state_(state)
    step = make_train_step(model, make_schedule(config), config)
    g = torch.Generator(device=device).manual_seed(seed)
    sync(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    state, m = step(state, X, generator=g)
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    snap = {k: {n: t.detach().clone() for n, t in d.items()} for k, d in
            (("params", state.params), ("ema", state.ema_params),
             ("mu", state.opt_state["mu"]), ("nu", state.opt_state["nu"]))}
    return snap, {k: float(v) for k, v in m.items()}, ms, launches


def checksum(tensors) -> int:
    """A position-weighted sum of the tensors' int32 bits (mod 2^64)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).view(torch.int32).long()
    w = torch.arange(flat.numel(), device=flat.device) % 65521 + 1
    return int((flat * w).sum())


def compare_steps(got, want, mk, mr, lr):
    """The P-rank step against the one-process step; returns the worst of
    each measure (each within 1 where it holds)."""
    worst = {"loss_rel": abs(mk["loss"] - mr["loss"]) / abs(mr["loss"])}
    gmax = max(float(t.abs().max()) for t in want["mu"].values()) / 0.1
    for slot, rel, floor in (("mu", GRAD_REL, 0.1 * 1e-6 * gmax),
                             ("nu", 2 * GRAD_REL, 1e-3 * (1e-6 * gmax) ** 2)):
        worst[slot] = max(float((got[slot][n] - want[slot][n]).abs().max())
                          / max(float(want[slot][n].abs().max()), floor) / rel
                          for n in want[slot])
    worst["param"] = worst["ema"] = 0.0
    for n, mu in want["mu"].items():
        atol = torch.where(mu.abs() < 1e-2 * float(mu.abs().max()), 2 * lr, 0.1 * lr)
        worst["param"] = max(worst["param"], float(
            ((got["params"][n] - want["params"][n]).abs() / atol).max()))
        worst["ema"] = max(worst["ema"], float(
            ((got["ema"][n] - want["ema"][n]).abs() / (1e-3 * atol + 1e-6)).max()))
    worst["loss_over_tol"] = worst["loss_rel"] / LOSS_RTOL
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=None, help="a yml (the flagship when not given)")
    ap.add_argument("--config_mod", nargs="*", default=[])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--block_steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = init_from_env(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = load_config(args.config, args.config_mod) if args.config else flagship_config()
    config.optim.warmup = 0   # with warmup the first update is exactly zero
    config.sampling.subsample = args.block_steps
    P, r, B = world(), rank(), args.batch
    model = build(config, SEED, device)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    n_gn, n_attn = (len(c) for c in model_calls(config, 1))
    on_card = device.type == "cuda"
    d, sz = config.data, config.data.image_size
    gx = torch.Generator(device=device).manual_seed(SEED + 2)
    X = torch.rand(B, d.num_frames_cond + d.num_frames, sz, sz, d.channels, generator=gx,
                   device=device)
    init = torch.randn(B, sz, sz, d.channels * d.num_frames, generator=gx, device=device)
    cond = torch.randn(B, sz, sz, d.channels * d.num_frames_cond, generator=gx, device=device)
    failures = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)

    # 1-2. the step on this rank's rows, then the ranks' parameters compared
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    step_once(config, model, weights, shard_rows(X), SEED + 3, device)   # warm-up
    got, mk, ms_p, launches = step_once(config, model, weights, shard_rows(X),
                                        SEED + 3, device)
    want_step = ({"gn_fused": n_gn, "gn_fused_bwd": n_gn, "attention_fwd": n_attn,
                  "attention_bwd": n_attn} if on_card else {})
    check(launches == {k: want_step.get(k, 0) for k in launches},
          f"rank {r} step launches {launches}, want {want_step}")
    sums = gather_rows(torch.tensor([checksum(got["params"].values())], device=device))
    check(len(set(sums.tolist())) == 1, f"the ranks' parameters differ: checksums {sums}")

    # 3. the gradients' all-reduce alone
    grads = [torch.randn(p.shape, generator=gx, device=device) for p in got["params"].values()]
    times = []
    for _ in range(4):
        sync(device)
        t0 = time.perf_counter()
        all_reduce_mean_(grads)
        sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    n_grad = sum(g.numel() for g in grads)
    del grads

    # 4. the wrapped block, each rank its rows
    block = make_block_sampler(config, model, make_schedule(config))
    params = {k: v.clone() for k, v in weights.items()}
    evals = args.block_steps + 1
    ops.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    out_p = wrap_chain(block)(params, init, cond, None,
                              generator=torch.Generator(device=device).manual_seed(SEED + 4))
    sync(device)
    block_ms_p = 1e3 * (time.perf_counter() - t0)
    block_launches = dict(ops.LAUNCHES)
    want_block = {"gn_fused": n_gn * evals, "attention_fwd": n_attn * evals} if on_card else {}
    check(block_launches == {k: want_block.get(k, 0) for k in block_launches},
          f"rank {r} block launches {block_launches}, want {want_block}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None

    # 5. every rank's report on rank 0, then the group ends
    report = dict(rank=r, device=str(device), step_ms=ms_p, step_launches=launches,
                  block_ms=block_ms_p, block_launches=block_launches,
                  peak_mem_gib=peak, failures=list(failures))
    reports = [report]
    backend = None
    if pdist.active():
        reports = [None] * P
        torch.distributed.all_gather_object(reports, report, group=pdist.control_group())
        backend = torch.distributed.get_backend()
    shutdown()
    if r != 0:
        return 1 if failures else 0

    # the one-process reference in rank 0's process
    step_once(config, model, weights, X, SEED + 3, device)   # warm-up at this batch
    want, mr, ms_1, _ = step_once(config, model, weights, X, SEED + 3, device)
    worst = compare_steps(got, want, mk, mr, config.optim.lr)
    for k, v in worst.items():
        if k != "loss_rel":
            check(v <= 1.0, f"step {k}: {v} of its tolerance")
    out_1 = block(params, init, cond, None,
                  generator=torch.Generator(device=device).manual_seed(SEED + 4))
    sync(device)
    block_err = float((out_p - out_1).abs().max())
    check(bool(torch.isfinite(out_p).all()) and block_err <= BLOCK_ATOL,
          f"block: max abs err {block_err} against one process")
    failures += [f for rep in reports for f in rep["failures"] if rep["rank"] != 0]
    check("jax" not in sys.modules, "jax was imported")
    line = dict(tool="ddp_check", backend=backend, world=P, batch=B,
                rows_per_rank=B // P, params=sum(p.numel() for p in model.parameters()),
                loss=mk, loss_one_process=mr, worst=worst, step_ms_one_process=ms_1,
                allreduce_ms=statistics.median(times[1:]), allreduce_floats=n_grad,
                block_steps=args.block_steps, block_max_abs_err=block_err,
                jax_imported="jax" in sys.modules,
                block_atol=BLOCK_ATOL, param_checksums=sums.tolist(), ranks=reports,
                failures=failures, ok=not failures)
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
