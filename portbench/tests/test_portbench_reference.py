"""The benchmark's reference against the port's plain path on the CPU, at a
small size: the NCSN++ forward at head dims 64 and 96 (evaluation and
training mode with its dropout draws), the DDPM block with clip_before and
denoise, the autoregressive loop, and three training steps (DSM loss,
clip, Adam with warmup, EMA). The test imports both; the reference itself
imports nothing of the port (test_portbench_imports)."""

import copy
import json

import pytest
import torch

import pbtest_tiny  # noqa: F401  (puts the repository on sys.path)
from portbench import reference as ref
from portbench.harness import cell, discovery, program, weights


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_config(base: str, head: int) -> dict:
    cfg = copy.deepcopy(discovery.load_config(base)["config"])
    cfg["model"].update(ngf=head, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16, 8],
                        n_head_channels=head)
    cfg["data"]["image_size"] = 16
    return cfg


def inputs(cfg, B, seed):
    d = cfg["data"]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, d["num_frames"] * d["channels"], 16, 16, generator=g)
    c = torch.rand(B, d["num_frames_cond"] * d["channels"], 16, 16, generator=g) * 2 - 1
    t = torch.randint(0, 1000, (B,), generator=g)
    return x, t, c


@pytest.mark.parametrize("base,head", [("smmnist_DDPM_big5", 64), ("bair_big", 96)])
def test_forward_matches_port(base, head):
    cfg = small_config(base, head)
    w = weights.make_weights(ref.Plan(cfg).shapes(), pbtest_tiny.SEED, "cpu")
    model = program.build_model(program.namespace(cfg), w, "cpu").eval()
    x, t, c = inputs(cfg, 2, 1)
    calls = []
    with torch.no_grad():
        want = ref.NCSNpp(cfg, record=calls)(w, x, t, c)
        got = model(x, t, c)
    assert {(k["kernel"], k.get("D")) for k in calls} >= {("attention_fwd", head)}
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_dropout_draws_match_port():
    cfg = small_config("smmnist_DDPM_big5", 64)
    w = weights.make_weights(ref.Plan(cfg).shapes(), 5, "cpu")
    model = program.build_model(program.namespace(cfg), w, "cpu").train()
    x, t, c = inputs(cfg, 2, 2)
    with torch.no_grad():
        got = model(x, t, c, dropout_generator=torch.Generator().manual_seed(9))
        want = ref.NCSNpp(cfg)(w, x, t, c, dropout=(0.1, torch.Generator().manual_seed(9)))
        plain = ref.NCSNpp(cfg)(w, x, t, c)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert float((plain - want).abs().max()) > 1e-2 * scale   # the masks did act


def test_ddpm_block_matches_port_sampler():
    from mcvd_tpu_torch.diffusion import make_schedule, samplers

    cfg = small_config("smmnist_DDPM_big5", 64)
    cfg["sampling"]["subsample"] = 10
    sched = make_schedule(program.namespace(cfg))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 16, 5, generator=g)
    noise = torch.randn(9, 2, 16, 16, 5, generator=g)

    def eps(x, labels):   # a toy score, x folded (B, H, W, F*C)
        return 0.7 * x + 0.05 * torch.sin(labels.float())[:, None, None, None]

    got = samplers.ddpm_sampler(x, eps, sched, subsample_steps=10, clip_before=True,
                                denoise=True, step_noise=noise)[-1]
    want = ref.ddpm_block(lambda xn, t, c: eps(xn.permute(0, 2, 3, 1), t).permute(0, 3, 1, 2),
                          x, torch.zeros(2, 16, 16, 5), ref.sampler_tables(cfg), noise)
    assert float((got - want).abs().max()) <= 1e-5


def test_autoregressive_prediction_matches_port(tmp_path):
    root = pbtest_tiny.tiny_root(tmp_path)
    wl = discovery.load_workload("tiny-sample", root)
    cfg = discovery.load_config("tiny", root)["config"]
    cfg["sampling"]["compute_dtype"] = "float32"
    mode = discovery.load_mode("sample", root)
    traffic = mode.Traffic(cfg, wl, pbtest_tiny.SEED, "cpu")
    w = weights.make_weights(ref.Plan(cfg).shapes(), pbtest_tiny.SEED, "cpu")
    ctx = cell.Context(workload=wl, config_file={"config": cfg}, seed=pbtest_tiny.SEED,
                       seconds=0.0, trace=False, device="cpu", t0=0.0, root=root)
    port = mode.Port(ctx, w, traffic)
    rows = torch.tensor([1, 3])
    got = port.request(traffic.cond(0), traffic.draws(0)).index_select(0, rows)
    # fp32 rounding, amplified by x0 = (x - sqrt(1 - a) eps) / sqrt(a) at the
    # noisiest level (1 / sqrt(a) ~ 160), still far under bf16's ~1e-2
    assert mode.check(cfg, w, traffic, 0, rows, got) <= 1e-4


def test_train_steps_match_port(tmp_path):
    """The reference follows the port's first three steps and one window step
    (from the port's own state) to fp32 rounding."""
    root = pbtest_tiny.tiny_root(tmp_path)
    out = cell.run_cell("tiny-train", pbtest_tiny.SEED, 0.0, False, "cpu", 0.0, root=root)
    got = out["_readings"]
    assert got["loss_rel"] <= 1e-6 and got["window_loss_rel"] <= 1e-6, got
    assert got["grad_leaf_gap"] <= 1e-4, got
    for part in ("change", "ema", "window_change", "window_ema"):
        assert got[f"{part}_leaf_gap"] <= 5e-3, got


def test_precisions_round_as_stated():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(4))
    t = ref.precision.tf32(x)
    assert float(((t - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert bool((t.view(torch.int32) & 0x1FFF == 0).all())
    f = ref.precision.fp8(x)
    assert float(((f - x).abs() / x.abs().clamp_min(x.abs().max() / 64)).max()) <= 2.0 ** -3
    a = x[:64].reshape(8, 8).requires_grad_(True)
    p = ref.PRECISIONS["tf32"]
    (p.output(p.operand(a) @ p.operand(a))).sum().backward()
    assert a.grad is not None and bool(torch.isfinite(a.grad).all())


def test_reference_schedule_is_upstreams():
    cfg = discovery.load_config("smmnist_DDPM_big5")["config"]
    s = ref.schedule(cfg)
    assert s["alphas"][0] < 1e-4 < s["alphas"][-1] < 1.0
    tab = ref.sampler_tables(cfg)
    assert len(tab["labels"]) == 100 and tab["labels"][1] == 10
    assert json.loads(json.dumps(cfg))["sampling"]["compute_dtype"] == "bfloat16"
