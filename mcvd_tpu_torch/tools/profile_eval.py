"""Where the flagship's time goes on the card: torch.profiler over the bf16
block sampler at the bench protocol's batch, and over the training step.

    python -m mcvd_tpu_torch.tools.profile_eval
    python -m mcvd_tpu_torch.tools.profile_eval --config configs/X.yml \
        [--batch 4] [--dtype float32] [--evals 5] [--cudnn_benchmark]

The flagship NCSN++ (random weights from seed 0), B=16, bf16 score network,
one block of 10 DDPM steps + denoise (11 evaluations) after a warm-up
block, under torch.profiler with CPU and CUDA activities; then 5 bare
network evaluations the same way; then one training step of the yml's
config (B=64, fp32 and then bf16 compute) after a warm-up step. For each
window: wall ms per evaluation or step (host clock around the synchronised
window, median of 3 runs without the profiler, which slows the host; the
profiled run's wall is reported beside it), device busy ms (the kernels'
device time summed in the profiled run; one stream, so they do not
overlap), the device's idle share (1 - busy / unprofiled wall), device ms by
kind of kernel, and the top kernels by device time. The last line printed
is one JSON record, with the card's name and power limit. Needs one CUDA
card; raises without one, and if the profiler reports no device time.

With `--config`, that yml's model at full width (random weights from seed
0; TF32 off in fp32): first one evaluation with each module of
`unet.all_modules` (an ncsn net's top-level blocks) timed alone (host
clock, synchronised before and after
it; the modules sorted by ms), then the bare network window over `--evals`
evaluations after one. `--cudnn_benchmark` lets cuDNN time its algorithms
at each new shape (`torch.backends.cudnn.benchmark`) instead of taking its
heuristics' choice, as the port does by default.

With `--config` and `--train_batches 32,16,8`, instead: the yml's model at
full width, one fp32 training step (TF32 off, the yml's dropout) at each
batch after a warm-up step: ms (host clock, synchronised) and the peak
device memory of that step (and of the warm-up, where `--cudnn_benchmark`
lets cuDNN try workspaces as large as the free memory); a batch that does
not fit is recorded as out of memory.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from ..config import flagship_config, load_config
from ..diffusion import make_schedule
from ..eval import make_block_sampler
from ..models import get_model
from ..train import create_train_state, make_train_step
from .profile_gn2 import nvidia_smi

# kind of kernel: the first pattern found in its name (lower case)
KINDS = [("gn_bwd_", "groupnorm backward"), ("gn_fused", "groupnorm"),
         ("attention_bwd", "attention backward"), ("attention_fwd", "attention"),
         ("multi_tensor_apply", "optimizer"),
         ("conv2d_grouped_direct", "FIR depthwise conv"), ("conv", "conv"),
         ("xmma", "conv"), ("cudnn", "conv"), ("gemm", "matmul"), ("cutlass", "matmul"),
         ("elementwise", "elementwise"), ("vectorized", "elementwise"),
         ("reduce", "reduction"), ("cat", "copy"), ("copy", "copy")]


def kind(name: str) -> str:
    low = name.lower()
    return next((k for pat, k in KINDS if pat in low), "other")


def wall_s(fn) -> float:
    """Seconds of one synchronised fn() on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile(fn, n_evals: int, unit: str = "eval") -> dict:
    """Wall per `unit` (fn() runs `n_evals` of them) without the profiler,
    then fn() under torch.profiler: device busy per unit and the idle share
    against the unprofiled wall, device ms per unit by kind and the top 15
    kernels."""
    wall = statistics.median(wall_s(fn) for _ in range(3))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_wall = wall_s(fn)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("profile_eval: the profiler reported no device time")
    by_kind = defaultdict(float)
    for e in kernels:
        by_kind[kind(e.key)] += e.self_device_time_total / 1e3 / n_evals
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    wall_ms = 1e3 * wall / n_evals
    busy_ms = busy_us / 1e3 / n_evals
    u = unit
    return {f"{u}s": n_evals, f"wall_ms_per_{u}": wall_ms,
            f"profiled_wall_ms_per_{u}": 1e3 * profiled_wall / n_evals,
            f"device_busy_ms_per_{u}": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
            f"kernel_launches_per_{u}": sum(e.count for e in kernels) / n_evals,
            f"device_ms_per_{u}_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": e.key[:100], "kind": kind(e.key),
                             f"ms_per_{u}": e.self_device_time_total / 1e3 / n_evals,
                             f"calls_per_{u}": e.count / n_evals} for e in top]}


def measure(batch: int = 16) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_eval runs on the card: no CUDA device")
    config = flagship_config()
    config.sampling.compute_dtype = "bfloat16"
    config.sampling.subsample = 10
    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
    sched = make_schedule(config)
    block = make_block_sampler(config, model, sched)
    d = config.data
    sz = d.image_size
    g = torch.Generator(device="cuda").manual_seed(6)
    cond = torch.randn(batch, sz, sz, d.num_frames_cond, generator=g, device="cuda")
    init = torch.randn(batch, sz, sz, d.num_frames, generator=g, device="cuda")
    params = dict(model.named_parameters())
    block(params, init, cond, generator=g)   # warm-up
    out = {"sampler_block": profile(lambda: block(params, init, cond, generator=g), 11)}

    net = model.to(torch.bfloat16).eval()
    x = init.permute(0, 3, 1, 2).to(torch.bfloat16)
    c = cond.permute(0, 3, 1, 2).to(torch.bfloat16)
    t = torch.full((batch,), 500, dtype=torch.long, device="cuda")

    def evals(n):
        with torch.inference_mode():
            for _ in range(n):
                net(x, t, c)

    evals(2)
    out["bare_network"] = profile(lambda: evals(5), 5)
    return out


def modules_ms(net, *args) -> list:
    """One evaluation of `net` with each module of `net.unet.all_modules`
    (the ncsn nets, which have no `unet`: each of their top-level blocks)
    timed alone: [(index, class name, ms)], slowest first."""
    times = []

    def pre(_m, _a):
        torch.cuda.synchronize()
        times.append(time.perf_counter())

    def post(m, _a, _o):
        torch.cuda.synchronize()
        times[-1] = (m, 1e3 * (time.perf_counter() - times[-1]))

    mods = list(net.unet.all_modules) if hasattr(net, "unet") else list(net.children())
    hooks = [h for m in mods for h in (m.register_forward_pre_hook(pre),
                                       m.register_forward_hook(post))]
    try:
        with torch.inference_mode():
            net(*args)
    finally:
        for h in hooks:
            h.remove()
    index = {id(m): i for i, m in enumerate(mods)}
    return sorted(((index[id(m)], type(m).__name__, ms) for m, ms in times),
                  key=lambda r: -r[2])


def measure_network(config_path: str, batch: int, dtype: str, n_evals: int = 5) -> dict:
    """Per module, then the bare network window, on a yml config's model at
    full width."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = load_config(config_path)
    comp = torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float32
    net = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
    net = net.to(comp).eval()
    d = config.data
    sz = d.image_size
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(batch, d.channels * d.num_frames, sz, sz, generator=g,
                    device="cuda").to(comp)
    c = torch.randn(batch, d.channels * d.num_frames_cond, sz, sz, generator=g,
                    device="cuda").to(comp)
    t = torch.full((batch,), 500, dtype=torch.long, device="cuda")

    def evals(n):
        with torch.inference_mode():
            for _ in range(n):
                net(x, t, c)

    evals(1)
    by_module = modules_ms(net, x, t, c)
    return {"config": config_path, "batch": batch, "dtype": dtype,
            "modules_ms": [{"index": i, "module": name, "ms": ms} for i, name, ms in by_module],
            "bare_network": profile(lambda: evals(n_evals), n_evals)}


def measure_train(compute_dtype: str, batch: int = 64) -> dict:
    """One training step of the flagship at the yml's batch (64) after a
    warm-up step, fp32 (TF32 off) or bf16 compute, dropout as configured."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = flagship_config()
    config.training.batch_size = batch
    config.training.compute_dtype = compute_dtype
    model = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
    state = create_train_state(config, model, device="cuda")
    step = make_train_step(model, make_schedule(config), config)
    d = config.data
    g = torch.Generator(device="cuda").manual_seed(8)
    X = torch.rand(batch, d.num_frames_cond + d.num_frames, d.image_size, d.image_size,
                   d.channels, generator=g, device="cuda")
    step(state, X, generator=g)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    out = profile(lambda: step(state, X, generator=g), 1, unit="step")
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def measure_train_memory(config_path: str, batches) -> list:
    """One fp32 step of a yml's model at each batch: ms and peak GiB."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = load_config(config_path)
    config.training.compute_dtype = "float32"
    d = config.data
    out = []
    for batch in batches:
        model = state = step = X = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            model = get_model(config, generator=torch.Generator().manual_seed(0), device="cuda")
            state = create_train_state(config, model, device="cuda")
            step = make_train_step(model, make_schedule(config), config)
            g = torch.Generator(device="cuda").manual_seed(8)
            X = torch.rand(batch, d.num_frames_cond + d.num_frames + getattr(
                d, "num_frames_future", 0), d.image_size, d.image_size, d.channels,
                generator=g, device="cuda")
            step(state, X, generator=g)   # warm-up (and cuDNN's algorithm search)
            torch.cuda.synchronize()
            warm_peak = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(state, X, generator=g)
            torch.cuda.synchronize()
            out.append({"batch": batch, "ms": 1e3 * (time.perf_counter() - t0),
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "warmup_peak_mem_gib": warm_peak,
                        "params": sum(p.numel() for p in model.parameters())})
        except torch.cuda.OutOfMemoryError as e:
            out.append({"batch": batch, "out_of_memory": str(e).splitlines()[0],
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", help="profile one evaluation of this yml's model")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--evals", type=int, default=5)
    ap.add_argument("--cudnn_benchmark", action="store_true")
    ap.add_argument("--train_batches", default=None,
                    help="with --config: a training step's peak memory at these batches")
    args = ap.parse_args(argv)
    card = nvidia_smi()
    if args.config and args.train_batches:
        torch.backends.cudnn.benchmark = args.cudnn_benchmark
        steps = measure_train_memory(args.config,
                                     [int(b) for b in args.train_batches.split(",")])
        print(json.dumps({"tool": "profile_eval", "card": card,
                          "device": torch.cuda.get_device_name(0), "config": args.config,
                          "dtype": "float32", "cudnn_benchmark": args.cudnn_benchmark,
                          "train_steps": steps}), flush=True)
        return 0
    if args.config:
        torch.backends.cudnn.benchmark = args.cudnn_benchmark
        result = measure_network(args.config, args.batch, args.dtype, args.evals)
        result["cudnn_benchmark"] = args.cudnn_benchmark
        r = result["bare_network"]
        print(f"{args.config} B={args.batch} {args.dtype}: wall {r['wall_ms_per_eval']:.2f} "
              f"ms/eval, device busy {r['device_busy_ms_per_eval']:.2f}, idle "
              f"{100 * r['device_idle_share']:.1f}%", flush=True)
        print(json.dumps({"tool": "profile_eval", "card": card,
                          "device": torch.cuda.get_device_name(0), **result}), flush=True)
        return 0
    result = measure()
    for dtype in ("float32", "bfloat16"):
        result[f"train_step_{dtype}"] = measure_train(dtype)
        torch.cuda.empty_cache()
    for window, r in result.items():
        u = "step" if window.startswith("train") else "eval"
        print(f"{window}: wall {r[f'wall_ms_per_{u}']:.2f} ms/{u} "
              f"({r[f'profiled_wall_ms_per_{u}']:.2f} profiled), device busy "
              f"{r[f'device_busy_ms_per_{u}']:.2f} ms/{u}, idle "
              f"{100 * r['device_idle_share']:.1f}%", flush=True)
    print(json.dumps({"tool": "profile_eval", "card": card,
                      "device": torch.cuda.get_device_name(0), **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
