"""The rank side of `tests/test_torch_port_parallel.py`, and the launcher the
port's multi-process tests share (`mcvd_tpu_torch.parallel.launch`, one
torch thread a rank).

    python -m tests.torch_parallel_ranks IN.pt OUT_PREFIX

Each rank (MCVD_DIST=1 and the MCVD_* variables, gloo on the CPU) reads the
inputs the test wrote, runs the collectives, two train steps of the tiny
flagship on its rows (the JAX draws sliced, then the port's own draws from a
generator) and the collective block sampler, and writes what it got to
OUT_PREFIX.<rank>.pt. It imports no JAX.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_THREADS = 1   # a rank's torch threads (the suite runs six workers)


def spawn_ranks(cmd, n, *, timeout=180, env=None, cwd=REPO):
    """`cmd` as the n ranks of one gloo group on this host
    (`parallel.launch.spawn_ranks`), TORCH_THREADS torch threads each;
    [(exit code, stdout, stderr)] in rank order."""
    from mcvd_tpu_torch.parallel.launch import spawn_ranks as spawn

    env = dict(os.environ if env is None else env, OMP_NUM_THREADS=str(TORCH_THREADS))
    return spawn(cmd, n, timeout=timeout, env=env, cwd=cwd)[0]


def main(inp: str, out_prefix: str) -> int:
    import torch

    torch.set_num_threads(TORCH_THREADS)
    from mcvd_tpu_torch import parallel as par
    from mcvd_tpu_torch.compat import load_flax_params
    from mcvd_tpu_torch.config import flagship_config
    from mcvd_tpu_torch.diffusion import make_schedule
    from mcvd_tpu_torch.eval.video_gen import make_block_sampler
    from mcvd_tpu_torch.models import get_model
    from mcvd_tpu_torch.parallel import draws as rng
    from mcvd_tpu_torch.train import create_train_state, make_train_step

    par.init_from_env("cpu")
    r = par.rank()
    data = torch.load(inp, weights_only=False)
    res = {"world": par.world(), "rank": r}

    # the collectives
    res["votes"] = [par.all_processes_true(True), par.all_processes_true(r != 1)]
    res["broadcast"] = par.broadcast_from_primary({"from": r, "rows": [r] * 3}, "test")
    x = data["rows"]
    res["my_rows"] = par.shard_rows(x)
    res["round_trip"] = par.gather_rows(par.shard_rows(x))
    res["clamped"] = {}
    for bs, n in data["clamp_cases"]:
        try:
            res["clamped"][bs, n] = par.clamp_batch(bs, n, "test")
        except ValueError:
            res["clamped"][bs, n] = None
    means = [torch.full((3, 5), float(r + 1)), torch.arange(7.0) * (r + 1)]
    res["means"] = [t.clone() for t in par.all_reduce_mean_(means, bucket_bytes=64)]
    g = par.RowDraws(torch.Generator().manual_seed(5))
    conc = par.shard_rows(data["concentration"])
    res["draws"] = {"randn": rng.randn((2, 3), g), "rand": rng.rand((2,), g),
                    "randint": rng.randint(9, (2, 4), g), "gamma": rng.standard_gamma(conc, g)}
    par.barrier("collectives")

    def train(params0, dropout, step_inputs):
        config = flagship_config(tiny=True)
        config.model.dropout = dropout
        config.optim.warmup = 0
        model = get_model(config, device="cpu")
        load_flax_params(model, params0)
        state = create_train_state(config, model, device="cpu")
        step = make_train_step(model, make_schedule(config), config)
        metrics = []
        for X, kw in step_inputs:
            state, m = step(state, par.shard_rows(X), **kw)
            metrics.append({k: float(v) for k, v in m.items()})
        return {"params": {k: v.detach().clone() for k, v in state.params.items()},
                "ema": state.ema_params, "mu": state.opt_state["mu"],
                "nu": state.opt_state["nu"], "metrics": metrics}

    # two steps on the JAX draws, each rank its rows; then two on the port's
    # own draws from one seeded generator, dropout on
    res["jax_draws"] = train(data["params0"], 0.0, [
        (X, {"draws": {k: par.shard_rows(v) for k, v in d.items()}})
        for X, d in zip(data["X"], data["draws"])])
    gen = torch.Generator().manual_seed(data["seed"])
    res["own_draws"] = train(data["params0"], 0.1, [(X, {"generator": gen}) for X in data["X"]])

    # the collective block: JAX's step noise, then a generator's
    config = flagship_config(tiny=True)
    config.data.num_frames = config.data.num_frames_cond = 2
    config.model.dropout = 0.0
    config.sampling.subsample = data["block_steps"]
    model = get_model(config, device="cpu")
    block = par.wrap_chain(make_block_sampler(config, model, make_schedule(config)))
    b = data["block"]
    res["block_jax_noise"] = block(b["params"], b["init"], b["cond"], None,
                                   step_noise=b["step_noise"])
    res["block_generator"] = block(b["params"], b["init"], b["cond"], None,
                                   generator=torch.Generator().manual_seed(data["seed"]))
    torch.save(res, f"{out_prefix}.{r}.pt")
    par.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
