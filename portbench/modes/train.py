"""Mode `train`: the training step, steps back to back, as `Runner.train`
drives it (no validation, checkpoints or logging).

The step is `train.make_train_step`'s (transform, DSM loss, gradients
through the kernels' backward passes, clip, Adam, EMA) on one
`create_train_state`, in the configuration's compute dtype. The state's
optimizer count starts at twice `optim.warmup` (`start_count`), as a run
resumed past its warm-up: every step takes the full learning rate, as
nearly all of a run's steps do. Each step's noise levels and noise are
drawn from the seed and handed to the step (`draws`); its dropout masks
come from a generator seeded per step. The feed is the workload's:
  * `loader`: the port's `get_dataset` (the configuration's dataset; one
    that needs no files, as StochasticMovingMNIST's procedural digits),
    `DataLoader` and `prefetch_to_device`, as `Runner.train` reads it; the
    host's wait in `next()` is kept per step (`data_wait_ms`);
  * `device`: `device_batches` clips U[0, 1) made on the card at set-up from
    the seed, handed to the step in turn (the data layer bypassed).

Set-up builds the state and takes it through its first three steps, from the
feed, through the window's own call; they warm every shape, and the window
continues the same state. `train_clips_per_s` is the clips of every step
in the window over its wall time; the window ends synchronised at a step
boundary. A traced run (`--trace 1`) then traces `TRACE_STEPS` more steps.

Check, by the float32 reference (`Reference`), in two stages:
  * the start: the reference follows the first three steps from the seed's
    weights, clips and draws: the worst step's relative loss gap
    (`loss_rel`); the first step's clipped gradient as Adam took it (its
    first moment / (1 - beta1)) by the worst leaf's gap of norms
    (`grad_leaf_gap`); the parameters' and the EMA's change over the three
    steps, by the worst leaf (`change_leaf_gap`, `ema_leaf_gap`);
  * one window step, picked from the seed among the window's first
    `CHECK_WITHIN`: the program's state (parameters, moments, EMA, count)
    is copied before it and its parameters and EMA after it, into copies
    made at set-up, and the reference follows that one step from the copy:
    `window_loss_rel`, and the change of the parameters and of the EMA by
    the worst leaf (`window_change_leaf_gap`, `window_ema_leaf_gap`).
A leaf's gap is |norm(program) - norm(reference)| over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone under Adam; they are left out of the changes' gaps. The
numbers compared are those the workload gives a limit; the run reads all.

`Control` is the reference in the program's place with every product's
operands in TF32, the precision below the configuration's float32.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import reference as ref
from portbench.harness import program, trace, weights
from portbench.harness.cell import Outcome

E2E = {"train_clips_per_s": "clips/s"}
CHECK_STEPS = 3
CHECK_WITHIN = 6    # the checked window step is one of the window's first six
TRACE_STEPS = 16


def start_count(cfg: dict) -> int:
    """The optimizer's count before the first step: twice the warm-up."""
    return 2 * int(cfg["optim"].get("warmup", 0) or 0)


STATE = ("params", "mu", "nu", "ema", "count")


def _copy(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


@torch.no_grad()
def snapshot(src: dict, parts, into=None) -> dict:
    """Copies of `parts` of a state's parts (`src`), or copied into the
    tensors of an earlier snapshot (`into`): no allocation."""
    if into is None:
        return {p: src[p] if p == "count" else _copy(src[p]) for p in parts}
    for p in parts:
        if p == "count":
            into[p] = src[p]
        else:
            for k, t in into[p].items():
                t.copy_(src[p][k])
    return into


class Port:
    """The program under test: the port's train state and step."""

    def __init__(self, ctx, w: dict):
        from mcvd_tpu_torch.diffusion import make_schedule
        from mcvd_tpu_torch.train import create_train_state, make_train_step

        self.config = program.namespace(ctx.config)
        self.config.training.batch_size = ctx.workload["batch"]
        model = program.build_model(self.config, w, ctx.device)
        self.state = create_train_state(self.config, model, device=ctx.device)
        self.state.opt_state["count"] = start_count(ctx.config)
        self.step_fn = make_train_step(model, make_schedule(self.config), self.config)
        self.beta1 = float(getattr(self.config.optim, "beta1", 0.9))

    def step(self, X, draws, gen):
        self.state, m = self.step_fn(self.state, X, draws=draws, generator=gen)
        return m

    def first_grads(self):
        """The first step's gradient as the optimizer took it, from its moment."""
        mu = self.state.opt_state["mu"]
        return {k: v / (1.0 - self.beta1) for k, v in mu.items()}

    def parts(self) -> dict:
        s, o = self.state, self.state.opt_state
        return {"params": s.params, "mu": o["mu"], "nu": o["nu"], "ema": s.ema_params,
                "count": int(o["count"])}

    def snapshot(self, parts=STATE, into=None) -> dict:
        return snapshot(self.parts(), parts, into)

    @torch.no_grad()
    def restore(self, snap: dict) -> None:
        """Puts the parts of a snapshot back into the state."""
        dst = self.parts()
        for part, v in snap.items():
            if part == "count":
                self.state.opt_state["count"] = v
            else:
                for k, t in v.items():
                    dst[part][k].copy_(t)


class Reference:
    """The reference's training state and step, float32 (or `precision`'s
    rounding of every product's operands), from `state`: params, ema,
    count and, optionally, the moments mu and nu."""

    def __init__(self, cfg: dict, state: dict, precision=None):
        self.cfg = cfg
        self.net = ref.NCSNpp(cfg, precision=precision)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in state["params"].items()}
        self.opt = ref.Adam(cfg, self.params, count=state["count"], mu=state.get("mu"),
                            nu=state.get("nu"))
        self.ema = _copy(state["ema"])
        dev = next(iter(self.params.values())).device
        self.alphas = torch.as_tensor(ref.schedule(cfg)["alphas"], device=dev)
        self.rate = float(cfg["model"].get("dropout", 0.0))
        self.g1 = None   # the first step's clipped gradients

    def step(self, X, draws, gen):
        drop = (self.rate, gen)
        loss = ref.dsm_loss(lambda x, t, c: self.net(self.params, x, t, c, dropout=drop),
                            self.cfg, X, draws["labels"], draws["z"], self.alphas)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        _, clipped = self.opt.update(self.params, dict(zip(self.params, grads)), self.ema)
        if self.g1 is None:
            self.g1 = _copy(clipped)
        return {"loss": loss.detach()}

    def after(self) -> dict:
        return {"params": _copy(self.params), "ema": self.ema}


class Control(Reference):
    """The control: the reference in the program's place, TF32 operands."""

    def __init__(self, ctx, w: dict):
        super().__init__(ctx.config, {"params": w, "ema": w, "count": start_count(ctx.config)},
                         ref.PRECISIONS["tf32"])

    def first_grads(self):
        return self.g1

    def snapshot(self, parts=STATE, into=None) -> dict:
        return snapshot({"params": self.params, "mu": self.opt.mu, "nu": self.opt.nu,
                         "ema": self.ema, "count": self.opt.count}, parts, into)


class Feed:
    """The cell's batches, (B, Fc + F, H, W, C) in [0, 1] on the device."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        d = cfg["data"]
        self.kind = wl["feed"]
        self.waits = []
        B, T = wl["batch"], d["num_frames_cond"] + d["num_frames"]
        if self.kind == "device":
            g = weights.generator(device, seed, "clips")
            self.batches = [torch.rand((B, T, d["image_size"], d["image_size"], d["channels"]),
                                       generator=g, device=device)
                            for _ in range(wl["device_batches"])]
            self.i = 0
        elif self.kind == "loader":
            from mcvd_tpu_torch.data import DataLoader, get_dataset, prefetch_to_device

            config = program.namespace(cfg)
            ds, _ = get_dataset(wl.get("data_path", "portbench/no_data"), config,
                                video_frames_pred=d["num_frames"], seed=seed)
            loader = DataLoader(ds, batch_size=B, shuffle=True, seed=seed, drop_last=True,
                                repeat=True, num_workers=int(d.get("num_workers", 0) or 0))
            self.it = prefetch_to_device(iter(loader), device)
        else:
            raise ValueError(f"feed {self.kind!r} is not loader or device")

    def next(self) -> torch.Tensor:
        if self.kind == "device":
            X = self.batches[self.i % len(self.batches)]
            self.i += 1
            return X
        t = time.perf_counter()
        X, _ = next(self.it)
        self.waits.append(time.perf_counter() - t)
        return X

    def close(self):
        if self.kind == "loader":
            self.it.close()


def step_draws(cfg: dict, B: int, seed: int, i: int, device):
    """Step i's noise levels (B,), noise (B, F*C, H, W) and dropout generator."""
    d = cfg["data"]
    g = weights.generator(device, seed, "step", i)
    labels = torch.randint(0, cfg["model"]["num_classes"], (B,), generator=g, device=device)
    z = torch.randn((B, d["num_frames"] * d["channels"], d["image_size"], d["image_size"]),
                    generator=g, device=device)
    return {"labels": labels, "z": z}, weights.generator(device, seed, "dropout", i)


def run(ctx) -> Outcome:
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = wl["batch"]
    cuda = str(dev).startswith("cuda")
    w = weights.make_weights(ref.Plan(cfg).shapes(), ctx.seed, dev)
    system = (ctx.system or Port)(ctx, w)
    feed = Feed(cfg, wl, ctx.seed, dev)
    start, losses, g1 = [], [], None
    for i in range(CHECK_STEPS):
        X = feed.next()
        draws, gen = step_draws(cfg, B, ctx.seed, i, dev)
        m = system.step(X, draws, gen)
        start.append((X.clone(), draws))
        losses.append(float(m["loss"]))
        if i == 0:
            g1 = _copy(system.first_grads())
    after_start = system.snapshot(("params", "ema"))
    # the window step's copies, made here so that the window allocates nothing
    before, after = system.snapshot(), system.snapshot(("params", "ema"))
    pick = int(np.random.default_rng(weights.seed_for(ctx.seed, "check")).integers(CHECK_WITHIN))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    feed.waits.clear()
    n, held, issued = CHECK_STEPS, None, []
    setup_s = time.perf_counter() - ctx.t0
    with trace.Window(dev) as win:
        t_end = time.perf_counter() + ctx.seconds
        while True:
            issued.append(time.perf_counter())
            X = feed.next()
            draws, gen = step_draws(cfg, B, ctx.seed, n, dev)
            if n - CHECK_STEPS == pick:
                held = {"n": n, "X": X.clone(), "draws": draws,
                        "before": system.snapshot(into=before)}
                held["loss"] = system.step(X, draws, gen)["loss"].detach().clone()
                held["after"] = system.snapshot(("params", "ema"), into=after)
            else:
                system.step(X, draws, gen)
            n += 1
            if held is not None and time.perf_counter() >= t_end:
                break
    steps = n - CHECK_STEPS
    half = steps // 2
    if half >= 2:   # the window's two halves by when their steps were issued
        print(f"portbench: window halves {B * half / (issued[half] - issued[0])!r} "
              f"{B * (steps - 1 - half) / (issued[-1] - issued[half])!r} clips/s",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    extra = {"data_wait_ms": 1e3 * float(np.mean(feed.waits))} if feed.waits else {}
    reading = None
    if ctx.trace:
        with trace.Window(dev, trace=True) as traced:
            for _ in range(TRACE_STEPS):
                draws, gen = step_draws(cfg, B, ctx.seed, n, dev)
                system.step(feed.next(), draws, gen)
                n += 1
        reading = traced.reading
    feed.close()
    del system, feed
    if cuda:
        torch.cuda.empty_cache()

    readings = check(cfg, w, ctx.seed, start, losses, g1, after_start, held)
    lim = wl["limits"]
    return Outcome(e2e={"train_clips_per_s": B * steps / win.seconds}, setup_s=setup_s,
                   attempted=steps, failed=0, window_s=win.seconds, units=steps,
                   checks={k: [readings[k], lim[k]] for k in lim}, readings=readings,
                   memory_peak_bytes=peak, reading=reading,
                   traced_units=TRACE_STEPS if reading is not None else 0, extra=extra)


def leaf_gaps(got: dict, want: dict, keep=None) -> torch.Tensor:
    """Each leaf's |norm(got) - norm(want)| over the larger of norm(want) and
    the median leaf's norm(want)."""
    names = [k for k in want if keep is None or keep[k]]
    ng = torch.stack([got[k].double().norm() for k in names])
    nw = torch.stack([want[k].double().norm() for k in names])
    return (ng - nw).abs() / torch.maximum(nw, nw.median())


def moved(g: dict) -> dict:
    """The leaves whose gradient is a thousandth of the median leaf's or more."""
    norm = {k: float(v.double().norm()) for k, v in g.items()}
    med = float(np.median(list(norm.values())))
    return {k: v >= 1e-3 * med for k, v in norm.items()}


def _changes(prefix: str, before: dict, got: dict, want: dict, keep: dict) -> dict:
    """The worst leaf's gap of the parameters' and the EMA's change from
    `before`, the program's (`got`) against the reference's."""
    out = {}
    for part, name in (("params", "change"), ("ema", "ema")):
        b = before[part]
        gaps = leaf_gaps({k: got[part][k] - b[k] for k in b},
                         {k: want[part][k] - b[k] for k in b}, keep)
        out[f"{prefix}{name}_leaf_gap"] = float(gaps.max())
    return out


def check(cfg, w, seed, start, losses, g1, after_start, held) -> dict:
    """The numbers that hold the program's first three steps (from the
    seed's weights w: their losses, the first step's clipped gradients g1,
    the parameters and EMA after them) and its window step `held` (the state
    before it, the loss, the parameters and EMA after it) to the reference's."""
    r = Reference(cfg, {"params": w, "ema": w, "count": start_count(cfg)})
    r_losses = [float(r.step(X, d, step_draws(cfg, X.shape[0], seed, i, X.device)[1])["loss"])
                for i, (X, d) in enumerate(start)]
    out = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
           "grad_leaf_gap": float(leaf_gaps(g1, r.g1).max())}
    out.update(_changes("", {"params": w, "ema": w}, after_start, r.after(), moved(r.g1)))
    del r
    b, X = held["before"], held["X"]
    r = Reference(cfg, b)
    loss = float(r.step(X, held["draws"], step_draws(cfg, X.shape[0], seed, held["n"],
                                                     X.device)[1])["loss"])
    out["window_loss_rel"] = abs(float(held["loss"]) - loss) / abs(loss)
    out.update(_changes("window_", b, held["after"], r.after(), moved(r.g1)))
    return out
