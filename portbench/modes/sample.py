"""Mode `sample`: autoregressive video prediction in batches, as a user
scores a checkpoint.

The window issues requests back to back, each `eval.video_gen.
autoregressive_predict` over `make_block_sampler` (the DDPM sampler in the
configuration's compute dtype): the workload's `batch` clips, `frames_pred`
frames in blocks of `num_frames` on `num_frames_cond` cond frames, the cond
window sliding. It stops issuing once `--seconds` have passed and ends when
the request in flight has finished; `sample_frames_per_s` is the predicted
frames of every request in the window over the window's wall time. Cond
frames, init noise and each step's noise come from the seed, per request and
block, and are handed to the program as explicit draws.

Set-up warms the cell's shapes with a short request (two blocks of two
steps + denoise, six evaluations) at the cell's batch through a sampler of
its own. A traced run (`--trace 1`) then traces one more whole request.

Check: `check_rows` rows of one finished request, both drawn from the seed,
are predicted again by the float32 reference from the same cond and draws
(free-running, block after block); the number compared is the worst, over
those rows and the request's blocks, of ||program - reference|| / ||reference||
over the block's frames (`frames_rel_rms`).

`Control` is the reference in the program's place with every product's
operands in fp8 (e4m3, a scale a tensor), the step below the configuration's
bfloat16; it predicts the rows the check reads and leaves the others zero.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from portbench import reference as ref
from portbench.harness import program, trace, weights
from portbench.harness.cell import Outcome

E2E = {"sample_frames_per_s": "frames/s"}


class Traffic:
    """The cell's requests: sizes, and each request's cond and block draws."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        d = cfg["data"]
        self.B, self.n_pred = wl["batch"], wl["frames_pred"]
        self.C, self.F, self.Fc, self.sz = (d["channels"], d["num_frames"],
                                            d["num_frames_cond"], d["image_size"])
        self.L = len(ref.sampler_tables(cfg)["labels"])   # steps a block
        self.n_blocks = math.ceil(self.n_pred / self.F)
        self.seed, self.device = seed, device

    def cond(self, r: int) -> torch.Tensor:
        g = weights.generator(self.device, self.seed, "cond", r)
        shape = (self.B, self.sz, self.sz, self.Fc * self.C)
        return torch.rand(shape, generator=g, device=self.device).mul_(2.0).sub_(1.0)

    def block(self, r: int, k: int) -> dict:
        """Block k of request r: its init noise and its L - 1 steps' noise
        (the last step adds none)."""
        shape = (self.B, self.sz, self.sz, self.F * self.C)
        g = weights.generator(self.device, self.seed, "noise", r, k)
        init = torch.randn(shape, generator=g, device=self.device)
        noise = torch.randn((self.L - 1, *shape), generator=g, device=self.device)
        return {"init": init, "step_noise": noise}

    def draws(self, r: int):
        return Draws(self, r)


class Draws:
    """Request r's block draws, made when the program asks for block k."""

    def __init__(self, traffic: Traffic, r: int):
        self.t, self.r = traffic, r

    def __len__(self):
        return self.t.n_blocks

    def __getitem__(self, k):
        if not 0 <= k < self.t.n_blocks:
            raise IndexError(k)
        return self.t.block(self.r, k)


class Port:
    """The program under test: the port's block sampler and its
    autoregressive loop, in the configuration's compute dtype."""

    def __init__(self, ctx, w: dict, traffic: Traffic):
        from mcvd_tpu_torch.diffusion import make_schedule
        from mcvd_tpu_torch.eval import autoregressive_predict, make_block_sampler

        self.config = program.namespace(ctx.config)
        self.model = program.build_model(self.config, w, ctx.device)
        self.sched = make_schedule(self.config)
        self.block = make_block_sampler(self.config, self.model, self.sched)
        self.params = dict(self.model.named_parameters())
        self.n_pred = traffic.n_pred
        self._predict = autoregressive_predict
        self._make = make_block_sampler

    def warm(self, cond: torch.Tensor, draws) -> torch.Tensor:
        """A request of two blocks of two steps + denoise at the cell's batch,
        through a sampler of its own: every operation of a request runs once
        (its kernels load, cuDNN picks its algorithms)."""
        cfg1 = copy.deepcopy(self.config)
        cfg1.sampling.subsample = 2
        block = self._make(cfg1, self.model, self.sched)
        n = min(self.n_pred, 2 * self.config.data.num_frames)
        short = [{"init": d["init"], "step_noise": d["step_noise"][:1]}
                 for d in (draws[k] for k in range(min(2, len(draws))))]
        return self._predict(cfg1, block, self.params, cond, None, n, 0, self.sched,
                             draws=short)

    def request(self, cond: torch.Tensor, draws) -> torch.Tensor:
        return self._predict(self.config, self.block, self.params, cond, None, self.n_pred,
                             0, self.sched, draws=draws)


class Control:
    """The control: the reference in the program's place, fp8 operands."""

    def __init__(self, ctx, w: dict, traffic: Traffic):
        self.cfg, self.w, self.traffic = ctx.config, w, traffic
        self.rows = check_rows(ctx.workload, ctx.seed, traffic.B, ctx.device)

    def warm(self, cond, draws):
        return None

    def request(self, cond: torch.Tensor, draws) -> torch.Tensor:
        t = self.traffic
        got = torch.cat(reference_outputs(self.cfg, self.w, t, cond, draws, self.rows,
                                          ref.PRECISIONS["fp8"]), dim=-1)
        out = torch.zeros((t.B, t.sz, t.sz, t.n_pred * t.C), device=cond.device)
        out[self.rows] = got[..., :t.n_pred * t.C]
        return out


def check_rows(wl: dict, seed: int, B: int, device) -> torch.Tensor:
    """The rows of a request the check reads, drawn from the seed."""
    rng = np.random.default_rng(weights.seed_for(seed, "check", "rows"))
    return torch.as_tensor(np.sort(rng.choice(B, wl["check_rows"], replace=False)),
                           device=device)


def run(ctx) -> Outcome:
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = str(dev).startswith("cuda")
    traffic = Traffic(cfg, wl, ctx.seed, dev)
    w = weights.make_weights(ref.Plan(cfg).shapes(), ctx.seed, dev)
    system = (ctx.system or Port)(ctx, w, traffic)
    rows = check_rows(wl, ctx.seed, traffic.B, dev)
    system.warm(traffic.cond(-1), traffic.draws(-1))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    kept, r = [], 0
    setup_s = time.perf_counter() - ctx.t0
    with trace.Window(dev) as win:
        t_end = time.perf_counter() + ctx.seconds
        while True:
            out = system.request(traffic.cond(r), traffic.draws(r))
            kept.append(out.index_select(0, rows))
            r += 1
            if time.perf_counter() >= t_end:
                break
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    evals = traffic.n_blocks * (traffic.L + 1)    # a request's
    reading = None
    if ctx.trace:
        with trace.Window(dev, trace=True) as traced:
            system.request(traffic.cond(r), traffic.draws(r))
        reading = traced.reading
    del system, out
    if cuda:
        torch.cuda.empty_cache()

    checked = int(np.random.default_rng(weights.seed_for(ctx.seed, "check")).integers(r))
    gap = check(cfg, w, traffic, checked, rows, kept[checked])
    frames = traffic.B * traffic.n_pred * r
    return Outcome(e2e={"sample_frames_per_s": frames / win.seconds}, setup_s=setup_s,
                   attempted=r, failed=0, window_s=win.seconds, units=r * evals,
                   checks={"frames_rel_rms": [gap, wl["limits"]["frames_rel_rms"]]},
                   readings={"frames_rel_rms": gap}, memory_peak_bytes=peak,
                   reading=reading, traced_units=evals if reading is not None else 0)


def reference_outputs(cfg, w, traffic: Traffic, cond, draws, rows, precision=None):
    """The reference's blocks for `rows` of a request, from its cond and
    draws (float32, or `precision`'s rounding for a control)."""
    net = ref.NCSNpp(cfg, precision=precision)
    picked = [{"init": draws[k]["init"].index_select(0, rows),
               "step_noise": draws[k]["step_noise"].index_select(1, rows)}
              for k in range(traffic.n_blocks)]
    with torch.no_grad():
        return ref.predict(lambda x, t, c: net(w, x, t, c), cfg, cond.index_select(0, rows),
                           picked, traffic.n_pred)


def check(cfg, w, traffic: Traffic, r: int, rows, got: torch.Tensor) -> float:
    """The worst block's ||got - reference|| / ||reference|| over the rows of
    request r."""
    want = reference_outputs(cfg, w, traffic, traffic.cond(r), traffic.draws(r), rows)
    FC = traffic.F * traffic.C
    worst = 0.0
    for k, blk in enumerate(want):
        g = got[..., k * FC:(k + 1) * FC].float()
        blk = blk[..., :g.shape[-1]]
        num = (g - blk).flatten(1).norm(dim=1)
        den = blk.flatten(1).norm(dim=1)
        worst = max(worst, float((num / den).max()))
    return worst
