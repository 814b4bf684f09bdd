"""The port's data parallelism (`mcvd_tpu_torch/parallel/`) against the JAX
package's single-process results and the port's own one-process results.

Two ranks of a gloo group on this host (`tests/torch_parallel_ranks.py`,
spawned once for the module) run the collectives, two train steps of the
tiny flagship on their rows of a global batch of 4 (the JAX draws, made for
the global batch and sliced; then the port's own draws from one seeded
generator, dropout on) and the collective block sampler. Here: the JAX
package's `make_train_step` on the global batch for the same two steps, its
`make_block_sampler` on the full batch with the same noise, the port in one
process, its loader's shards against the JAX loader's, and the launch
variables. The rule held: for the same global batch and seed, two ranks
give what one process gives, within fp32 rounding.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.data import get_dataset as jax_get_dataset
from mcvd_tpu.data.loader import DataLoader as JaxDataLoader
from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.eval import video_gen as jax_video_gen
from mcvd_tpu.models import get_model as jax_get_model
from mcvd_tpu.runners.runner import Runner as JaxRunner
from mcvd_tpu.train import create_train_state as jax_create_train_state
from mcvd_tpu.train import make_train_step as jax_make_train_step
from mcvd_tpu_torch import parallel as par
from mcvd_tpu_torch.compat import load_flax_params
from mcvd_tpu_torch.data import DataLoader, get_dataset
from mcvd_tpu_torch.diffusion import make_schedule
from mcvd_tpu_torch.eval.video_gen import make_block_sampler
from mcvd_tpu_torch.models import get_model
from mcvd_tpu_torch.parallel import dist as pdist
from mcvd_tpu_torch.train import create_train_state, make_train_step
from tests.test_torch_port_sampling import ar_config, port_params, replay_sampler_draws
from tests.test_torch_port_train import (GRAD_REL, SLICE_RTOL, adam_slots, as_torch,
                                         assert_close_to_max, jax_draws, perturbed,
                                         tiny_configs)
from tests.test_torch_port_video_data import batches, smmnist_ns
from tests.torch_parallel_ranks import TORCH_THREADS, spawn_ranks

B = 4                 # the global batch: 2 rows a rank
BLOCK_STEPS = 5
SEED = 17
# the block on the same noise: a 5-step chain of a tiny net, its rows
# evaluated in batches of 2 here and of 4 in one process or in JAX
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
CLAMP_CASES = [(16, 100), (15, 100), (16, 7), (3, 100), (1, 100), (8, 1)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX reference, the inputs written for the ranks, and what each
    rank got."""
    d = tmp_path_factory.mktemp("ranks")
    jcfg, _ = tiny_configs()
    jmodel, jsched = jax_get_model(jcfg), jax_make_schedule(jcfg)
    sz = jcfg.data.image_size
    x0 = jnp.zeros((B, sz, sz, 5))
    state = jax_create_train_state(jcfg, jmodel, (x0, jnp.zeros((B,), jnp.int32), x0),
                                   jax.random.PRNGKey(0))
    params0 = perturbed(state.params, 23)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params0),
                          ema_params=jax.tree_util.tree_map(jnp.asarray, params0))
    rng = np.random.RandomState(24)
    X = [rng.rand(B, 10, sz, sz, 1).astype(np.float32) for _ in range(2)]
    keys = [jax.random.PRNGKey(41), jax.random.PRNGKey(42)]
    jstep = jax_make_train_step(jmodel, jsched, jcfg)
    metrics = []
    for Xi, k in zip(X, keys):
        state, m = jstep(state, jnp.asarray(Xi), k)
        metrics.append({n: float(v) for n, v in m.items()})
    n_labels = len(make_schedule(tiny_configs()[1]).alphas)
    draws = [jax_draws(jcfg, k, Xi.shape, n_labels) for Xi, k in zip(X, keys)]

    # the JAX block on the full batch
    bcfg = ar_config()
    bcfg.sampling.subsample = BLOCK_STEPS
    bmodel = jax_get_model(bcfg)
    xb = jnp.zeros((1, sz, sz, 2))
    bparams = jax.jit(bmodel.init)(jax.random.PRNGKey(3), xb, jnp.zeros((1,), jnp.int32),
                                   xb)["params"]
    bparams = perturbed(bparams, 25)
    shape = (B, sz, sz, 2)
    init = rng.randn(*shape).astype(np.float32)
    cond = rng.randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(43)
    jblock = jax_video_gen.make_block_sampler(bcfg, bmodel, jax_make_schedule(bcfg))
    block_want = np.asarray(jblock(bparams, key, jnp.asarray(init), jnp.asarray(cond), None))
    _, step_noise = replay_sampler_draws(key, shape, BLOCK_STEPS)

    inp = str(d / "in.pt")
    torch.save({"rows": torch.arange(24.0).reshape(8, 3), "clamp_cases": CLAMP_CASES,
                "concentration": torch.linspace(0.5, 4.0, 8).reshape(4, 2),
                "params0": params0, "X": [torch.from_numpy(a) for a in X], "draws": draws,
                "seed": SEED, "block_steps": BLOCK_STEPS,
                "block": {"params": port_params(bparams), "init": torch.from_numpy(init),
                          "cond": torch.from_numpy(cond), "step_noise": step_noise}}, inp)
    outs = spawn_ranks([sys.executable, "-m", "tests.torch_parallel_ranks", inp,
                        str(d / "out")], 2)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r}: exit {rc}\n{out[-2000:]}\n{err[-4000:]}"
    got = [torch.load(str(d / f"out.{r}.pt"), weights_only=False) for r in range(2)]
    return types.SimpleNamespace(got=got, params0=params0, X=X, draws=draws, jstate=state,
                                 metrics=metrics, block_want=block_want, bparams=bparams,
                                 init=init, cond=cond, step_noise=step_noise)


def test_collectives_on_two_ranks(ranks):
    """One False vote makes the AND false on both ranks; rank 0's value is
    every rank's; the rows split in rank order and gather back; the bucketed
    mean; draws cut from the global batch's."""
    rows = torch.arange(24.0).reshape(8, 3)
    for r, got in enumerate(ranks.got):
        assert got["world"] == 2 and got["rank"] == r
        assert got["votes"] == [True, False]
        assert got["broadcast"] == {"from": 0, "rows": [0, 0, 0]}
        assert torch.equal(got["my_rows"], rows[4 * r:4 * r + 4])
        assert torch.equal(got["round_trip"], rows)
        assert torch.equal(got["means"][0], torch.full((3, 5), 1.5))
        assert torch.equal(got["means"][1], torch.arange(7.0) * 1.5)
    g = torch.Generator().manual_seed(5)
    want = {"randn": torch.randn(4, 3, generator=g), "rand": torch.rand(4, generator=g),
            "randint": torch.randint(0, 9, (4, 4), generator=g),
            "gamma": torch._standard_gamma(torch.linspace(0.5, 4.0, 8).reshape(4, 2),
                                           generator=g)}
    for k, v in want.items():
        assert torch.equal(torch.cat([got["draws"][k] for got in ranks.got]), v), k


def test_eval_batch_clamped_as_jax(ranks):
    """`parallel.clamp_batch` on two ranks is the JAX runner's
    `_eval_batch_size` on a 2-device data axis: clamped to the split, a
    multiple of the ranks, and a refusal where none fits."""
    fake = types.SimpleNamespace(mesh=types.SimpleNamespace(shape={"data": 2}))
    for bs, n in CLAMP_CASES:
        try:
            want = JaxRunner._eval_batch_size(fake, bs, n, "test")
        except ValueError:
            want = None
        for got in ranks.got:
            assert got["clamped"][bs, n] == want, (bs, n)


def test_two_rank_steps_match_jax(ranks):
    """Two steps on the JAX draws, each rank its 2 rows, against the JAX
    package's one process on the global batch of 4: loss and grad norm at
    rtol 1e-4; Adam's moments, parameters and EMA at the step tests'
    tolerances."""
    js = ranks.jstate
    jparams, jema = as_torch(js.params), as_torch(js.ema_params)
    mu, nu = adam_slots(js)
    lr = tiny_configs()[1].optim.lr
    for got in ranks.got:
        g = got["jax_draws"]
        for m, want in zip(g["metrics"], ranks.metrics):
            np.testing.assert_allclose(m["loss"], want["loss"], rtol=SLICE_RTOL)
            np.testing.assert_allclose(m["grad_norm"], want["grad_norm"], rtol=SLICE_RTOL)
        floor = 1e-6 * max(float(t.abs().max()) for t in mu.values()) / 0.1
        for n in jparams:
            assert_close_to_max(g["mu"][n], mu[n], GRAD_REL, 0.1 * floor, f"mu {n}")
            assert_close_to_max(g["nu"][n], nu[n], 2 * GRAD_REL, 1e-3 * floor ** 2, f"nu {n}")
            atol = torch.where(mu[n].abs() < 1e-2 * float(mu[n].abs().max()), 2 * lr, 0.1 * lr)
            assert bool(((g["params"][n] - jparams[n]).abs() <= atol).all()), f"param {n}"
            assert bool(((g["ema"][n] - jema[n]).abs() <= 1e-3 * atol + 1e-6).all()), n


def test_two_ranks_hold_the_same_bits(ranks):
    """Every rank receives the same reduced gradients, so the ranks'
    parameters, EMA and moments are equal bit for bit after each run."""
    a, b = ranks.got
    for run in ("jax_draws", "own_draws"):
        for slot in ("params", "ema", "mu", "nu"):
            for n, t in a[run][slot].items():
                assert torch.equal(t, b[run][slot][n]), (run, slot, n)
        assert a[run]["metrics"] == b[run]["metrics"]


def test_two_rank_steps_match_one_process(ranks):
    """The port's own draws (dropout masks, noise levels, noise) from one
    seeded generator, made for the global batch and cut to each rank's rows:
    two ranks give the one-process steps within fp32 rounding."""
    torch.set_num_threads(TORCH_THREADS)
    _, config = tiny_configs()
    config.model.dropout = 0.1
    model = get_model(config, device="cpu")
    load_flax_params(model, ranks.params0)
    state = create_train_state(config, model, device="cpu")
    step = make_train_step(model, make_schedule(config), config)
    gen = torch.Generator().manual_seed(SEED)
    metrics = []
    for X in ranks.X:
        state, m = step(state, torch.from_numpy(X), generator=gen)
        metrics.append({k: float(v) for k, v in m.items()})
    got = ranks.got[0]["own_draws"]
    for a, b in zip(got["metrics"], metrics):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=SLICE_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=SLICE_RTOL)
    lr = config.optim.lr
    mu = state.opt_state["mu"]
    floor = 1e-6 * max(float(t.abs().max()) for t in mu.values()) / 0.1
    for n, p in state.params.items():
        assert_close_to_max(got["mu"][n], mu[n], GRAD_REL, 0.1 * floor, f"mu {n}")
        atol = torch.where(mu[n].abs() < 1e-2 * float(mu[n].abs().max()), 2 * lr, 0.1 * lr)
        assert bool(((got["params"][n] - p.detach()).abs() <= atol).all()), f"param {n}"
        assert bool(((got["ema"][n] - state.ema_params[n]).abs()
                     <= 1e-3 * atol + 1e-6).all()), n


def test_wrapped_block_matches_jax_and_one_process(ranks):
    """The collective block (each rank 2 of the 4 rows) on JAX's step noise
    against the JAX block on the full batch; on a generator's draws against
    the port's one-process block; the same full output on both ranks."""
    a, b = ranks.got
    for k in ("block_jax_noise", "block_generator"):
        assert a[k].shape == (B, 16, 16, 2) and torch.equal(a[k], b[k]), k
    np.testing.assert_allclose(a["block_jax_noise"].numpy(), ranks.block_want, **BLOCK_TOL)
    config = ar_config()
    config.sampling.subsample = BLOCK_STEPS
    block = make_block_sampler(config, get_model(config, device="cpu"), make_schedule(config))
    one = block(port_params(ranks.bparams), torch.from_numpy(ranks.init),
                torch.from_numpy(ranks.cond), None,
                generator=torch.Generator().manual_seed(SEED))
    np.testing.assert_allclose(a["block_generator"].numpy(), one.numpy(), **BLOCK_TOL)
    again = block(port_params(ranks.bparams), torch.from_numpy(ranks.init),
                  torch.from_numpy(ranks.cond), None, step_noise=ranks.step_noise)
    np.testing.assert_allclose(again.numpy(), ranks.block_want, **BLOCK_TOL)


@pytest.mark.parametrize("proc", [0, 1])
def test_loader_shards_match_jax(tmp_path, proc):
    """Each rank's loader shard (`num_processes=2, process_index=proc`) is
    the JAX loader's, over two epochs: SMMNIST's batch path (`get_batch`)
    and an index dataset's per-item path, ragged split included."""
    jt, _ = jax_get_dataset(str(tmp_path), smmnist_ns("StochasticMovingMNIST"),
                            video_frames_pred=3, seed=1)
    pt, _ = get_dataset(str(tmp_path), smmnist_ns("StochasticMovingMNIST"),
                        video_frames_pred=3, seed=1)
    kw = dict(batch_size=4, shuffle=True, seed=3, drop_last=True, repeat=True,
              num_processes=2, process_index=proc)
    jl, pl_ = JaxDataLoader(jt, **kw), DataLoader(pt, **kw)
    n = min(2 * len(pl_), 6)
    for (xj, yj), (xp, yp) in zip(batches(jl, n), batches(pl_, n)):
        assert xp.shape == (4, 5, 64, 64, 1) and np.array_equal(xj, xp)
        assert np.array_equal(yj, yp)

    class Items:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return np.full((2,), i, np.float32), i

    kw.update(batch_size=3, drop_last=False)
    jl, pl_ = JaxDataLoader(Items(), **kw), DataLoader(Items(), **kw)
    for (xj, yj), (xp, yp) in zip(batches(jl, 2 * len(pl_)), batches(pl_, 2 * len(pl_))):
        assert np.array_equal(xj, xp) and np.array_equal(yj, yp)


def test_single_process_takes_no_collective():
    """Without MCVD_DIST no group starts: rank 0 of 1, every collective
    gives its input back, draws are the generator's own, the chain is the
    function's own result."""
    assert not pdist.active() and par.rank() == 0 and par.world() == 1 and par.is_main()
    x = torch.arange(6.0).reshape(3, 2)
    assert par.shard_rows(x) is x and par.gather_rows(x) is x
    ts = [x.clone()]
    assert par.all_reduce_mean_(ts) is ts and torch.equal(ts[0], x)
    assert par.all_processes_true(0) is False and par.broadcast_from_primary("v") == "v"
    par.barrier("nothing")
    g = torch.Generator()
    assert par.row_draws(g) is g
    assert par.clamp_batch(7, 5, "t") == 5
    with pytest.raises(ValueError, match="cannot fill"):
        par.clamp_batch(3, 0, "t")
    assert par.wrap_chain(lambda p, a, generator=None: a * 2)(None, x).equal(x * 2)


def test_launch_reads_the_jax_variables_then_torchrun(monkeypatch):
    """`init_from_env`'s launch: the MCVD_* variables, else torchrun's; what
    is missing is named; a rank's device; NCCL refused on the CPU; without
    MCVD_DIST only the device, and no group."""
    for k in ("MCVD_COORDINATOR", "MCVD_NUM_PROCESSES", "MCVD_PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MCVD_DIST_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MCVD_DIST", "1")
    with pytest.raises(RuntimeError, match="MCVD_COORDINATOR.*MCVD_NUM_PROCESSES"):
        pdist.launch_spec()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pdist.launch_spec() == {"coordinator": "localhost:1234", "world": 4, "rank": 3,
                                   "local_rank": 1}
    monkeypatch.setenv("MCVD_COORDINATOR", "h:9")
    monkeypatch.setenv("MCVD_NUM_PROCESSES", "2")
    monkeypatch.setenv("MCVD_PROCESS_ID", "2")
    with pytest.raises(RuntimeError, match="rank 2 outside a world of 2"):
        pdist.launch_spec()
    monkeypatch.setenv("MCVD_PROCESS_ID", "1")
    assert pdist.launch_spec()["coordinator"] == "h:9"
    assert pdist.rank_device("cpu", 1, 1) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pdist.rank_device("cuda", 1, 3) == torch.device("cuda", 1)
    assert pdist.rank_device("cuda", None, 3) == torch.device("cuda", 1)
    assert pdist.rank_device("cuda:0", 1, 3) == torch.device("cuda", 0)
    monkeypatch.setenv("MCVD_DIST_BACKEND", "nccl")
    with pytest.raises(RuntimeError, match="nccl needs a card"):
        pdist.init_from_env("cpu")
    monkeypatch.setenv("MCVD_DIST", "0")
    assert pdist.init_from_env("cpu") == torch.device("cpu") and not pdist.active()


def test_rank_sources_import_no_jax():
    """The rank side of these tests imports no JAX (it runs in the ranks)."""
    src = open(os.path.join(os.path.dirname(__file__), "torch_parallel_ranks.py")).read()
    assert "import jax" not in src and "from jax" not in src and "mcvd_tpu." not in src
