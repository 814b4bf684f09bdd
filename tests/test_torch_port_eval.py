"""The port's evaluation networks and loaders against the JAX package, on the
same seeded numpy weights (written in the real files' schemas, BatchNorm
statistics included) and the same inputs: I3D in the full schema, the simple
3d and 2d embedders (TorchScript archives, with and without a wrapper
prefix), the FVD preprocessing, LPIPS, the FID math, the Inception embedder,
the ensemble block sampler (the JAX draws replayed), and
`load_model_from_ckpt` on an upstream-format `.pt`."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from mcvd_tpu.diffusion import make_schedule as jax_make_schedule
from mcvd_tpu.eval import fid as jax_fid
from mcvd_tpu.eval import i3d as jax_i3d
from mcvd_tpu.eval import lpips as jax_lpips
from mcvd_tpu.eval import video_gen as jax_video_gen
from mcvd_tpu_torch.compat import yaml_subset
from mcvd_tpu_torch.config import flagship_config, namespace2dict
from mcvd_tpu_torch.diffusion import make_schedule
from mcvd_tpu_torch.eval import fid, i3d, lpips, standins, video_gen
from mcvd_tpu_torch.eval import weights as W
from mcvd_tpu_torch.models import get_model
from test_torch_port_sampling import (CHAIN_TOL, port_params, replay_sampler_draws,  # noqa: F401
                                      tiny_models)

# The networks: fp32 on both sides with the same weights; the port's
# convolutions (oneDNN) and XLA's sum in other orders.
NET_REL = 1e-4      # of the largest output (I3D logits, embedder features)
PRE_TOL = 1e-5      # the resize: the same bilinear weights, fp32 rounding
LPIPS_TOL = 1e-5    # per-video LPIPS, absolute
FID_RTOL = 1e-6     # float64 numpy on the same features


def assert_rel(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} vs largest {scale}"


# ------------------------------------------------------------------ I3D

def test_i3d_full_schema_matches_jax():
    """Seeded weights in upstream InceptionI3d's schema (BN statistics
    included): both converters give the same folded weights (the port's
    in float64, so rtol 1e-6), and B=1 at 16 x 224 x 224 gives the same 400
    logits within 1e-4 of the largest."""
    sd = standins.i3d_state_dict(0)
    jmodel, jparams = jax_i3d.build_jax_embedder_from_state_dict(sd)
    folded = i3d.convert_i3d_state_dict(sd)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert len(jflat) == len(folded) == 2 * (3 + 6 * len(i3d.MIXED) + 1)
    for key, w in folded.items():
        name, kind = key.rsplit(".conv3d.", 1)
        want = jflat[f"{name.replace('.', '/')}/conv3d/{'kernel' if kind == 'weight' else 'bias'}"]
        got = w.numpy().transpose(2, 3, 4, 1, 0) if kind == "weight" else w.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=key)

    x = np.random.RandomState(1).rand(1, 16, 224, 224, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax.jit(jmodel.apply)({"params": jparams}, jnp.asarray(x)))
    net = i3d.build_embedder_from_state_dict(sd)
    with torch.inference_mode():
        got = net(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()).numpy()
    assert got.shape == (1, 400)
    assert_rel(got, want, NET_REL, "I3D logits")


class Wrapped(nn.Module):
    """A TorchScript wrapper that nests the embedder under `inner.`."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner(x)


def scripted(sd, nd, wrap, stride, pad):
    w = sd["conv.weight"]
    cls = i3d.SimpleScriptEmbedder3d if nd == 3 else i3d.SimpleScriptEmbedder2d
    net = cls(w.shape[1], w.shape[0], sd["head.weight"].shape[0], w.shape[2:],
              stride=(stride,) * nd, pad=(pad,) * nd)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return torch.jit.script(Wrapped(net) if wrap else net).eval()


@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrapped"])
def test_simple3d_torchscript_matches_jax(tmp_path, wrap):
    """A simple 3d TorchScript archive (stride 2, padding 1 on its conv):
    the port's embedder, preprocessing included, against the JAX package's
    jitted embedder and against the archive's own forward. Wrapped under
    `inner.`, the port strips the prefix and still finds the conv's stride
    and padding; the JAX loader does not look into the wrapper, so it is
    given the port's spec."""
    sd = standins.simple_state_dict(4, 3)
    path = str(tmp_path / "i3d.pt")
    scripted(sd, 3, wrap, 2, 1).save(path)
    videos = np.random.RandomState(5).rand(3, 6, 32, 32, 1).astype(np.float32)

    got = i3d.make_i3d_embedder(path, device="cpu", batch_size=2)(videos)
    p_sd, spec, mod = i3d.load_embedder_spec(path)
    assert spec == {"stride": (2, 2, 2), "padding": (1, 1, 1)} and sorted(p_sd) == sorted(sd)
    with torch.inference_mode():
        own = mod(i3d.preprocess_videos(torch.from_numpy(videos))).numpy()
    assert_rel(got, own, NET_REL, "vs the archive")
    if wrap:
        jmodel, jparams = jax_i3d.build_jax_embedder_from_state_dict(
            jax_i3d.load_embedder_weights(path), spec)
        want = np.asarray(jmodel.apply({"params": jparams},
                                       jax_i3d.preprocess_videos(jnp.asarray(videos))))
    else:
        want = jax_i3d.make_jax_i3d_embedder(path, batch_size=2)(videos)
    assert got.shape == want.shape == (3, 32)
    assert_rel(got, want, NET_REL, "vs JAX")


@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrapped"])
def test_simple2d_inception_matches_jax(tmp_path, wrap):
    """The simple 2d schema as fast_fid's Inception embedder, grayscale
    frames repeated to 3 channels: the port against the JAX package's jitted
    embedder (given the port's spec where the archive is wrapped) and
    against the archive's own forward."""
    sd = standins.simple_state_dict(6, 2, feat_dim=24)
    path = str(tmp_path / "inception.pt")
    scripted(sd, 2, wrap, 1, 1).save(path)
    images = np.random.RandomState(7).rand(5, 16, 16, 1).astype(np.float32)

    got = fid.make_inception_embedder(path, device="cpu", batch_size=2)(images)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).repeat(1, 3, 1, 1)
    with torch.inference_mode():
        own = torch.jit.load(path)(x).numpy()
    assert_rel(got, own, NET_REL, "vs the archive")
    if wrap:
        _, spec, _ = i3d.load_embedder_spec(path)
        jmodel, jparams = jax_i3d.build_jax_embedder_from_state_dict(
            jax_i3d.load_embedder_weights(path), spec)
        want = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.tile(jnp.asarray(images), (1, 1, 1, 3))))
    else:
        want = jax_i3d.make_jax_inception_embedder(path, batch_size=2)(images)
    assert got.shape == want.shape == (5, 24)
    assert_rel(got, want, NET_REL, "vs JAX")


def test_inception_torchscript_module_matches_the_jax_sidecar(tmp_path):
    """An Inception archive outside the simple schema runs as it is (on the
    caller's device): the same features as the JAX package's torch
    sidecar. A plain state dict outside the simple schema, and a file that
    is not a checkpoint, raise."""
    path = str(tmp_path / "inception.pt")
    standins.tiny_inception(8).save(path)
    images = np.random.RandomState(9).rand(7, 32, 32, 3).astype(np.float32)
    got = fid.make_inception_embedder(path, device="cpu", batch_size=3)(images)
    want = jax_fid.make_inception_embedder(path, batch_size=3)(images)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got.shape == (7, 64)

    sd_path = str(tmp_path / "sd.pt")
    torch.save(standins.tiny_inception(8).state_dict(), sd_path)
    with pytest.raises(ValueError, match="not in the simple 2d schema"):
        fid.make_inception_embedder(sd_path, device="cpu")
    bad = tmp_path / "broken.pt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        fid.make_inception_embedder(str(bad), device="cpu")


@pytest.mark.parametrize("shape", [(2, 3, 64, 64, 1), (1, 2, 256, 256, 3), (1, 2, 48, 80, 3)],
                         ids=["up64", "down256", "up48x80"])
def test_preprocess_videos_matches_jax(shape):
    """Shortest side to 224, center crop, [-1, 1]: the port's resize
    (antialiased where it downscales) against `jax.image.resize`'s, within
    1e-5, upscaling, downscaling and one non-square clip."""
    videos = np.random.RandomState(10).rand(*shape).astype(np.float32)
    want = np.asarray(jax_i3d.preprocess_videos(jnp.asarray(videos)))
    got = i3d.preprocess_videos(torch.from_numpy(videos))
    assert got.shape == (shape[0], 3, shape[1], 224, 224)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, rtol=0, atol=PRE_TOL)


def test_same_pad_matches_jax():
    for size in range(1, 20):
        for k in (1, 2, 3, 7):
            for s in (1, 2):
                assert i3d.same_pad(size, k, s) == jax_i3d._same_pad(size, k, s)


# ------------------------------------------------------------------ LPIPS

@pytest.mark.parametrize("form,shape", [("features", (2, 3, 64, 64, 1)),
                                        ("whole_net", (1, 2, 160, 160, 3))],
                         ids=["features_up64", "wholenet_down160"])
def test_lpips_matches_jax(tmp_path, form, shape):
    """The same AlexNet and lin-head files into both packages'
    `make_lpips_fn`: per-video LPIPS within 1e-5, with the frames upscaled
    and downscaled to 128; the converters give the same weights."""
    alex = standins.alexnet_features_state_dict(
        11, prefix="features." if form == "whole_net" else "")
    lin = standins.lpips_lin_state_dict(12)
    alex_path = standins.save_state_dict(alex, str(tmp_path / W.ALEXNET))
    lin_path = standins.save_state_dict(lin, str(tmp_path / W.LPIPS_LIN))
    rng = np.random.RandomState(13)
    real, pred = (rng.rand(*shape).astype(np.float32) for _ in range(2))
    want = jax_lpips.make_lpips_fn(lin_path, alex_path)(real, pred)
    got = lpips.make_lpips_fn(lin_path, alex_path, device="cpu", batch_size=3)(real, pred)
    assert len(got) == len(want) == shape[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=LPIPS_TOL)

    jparams = jax_lpips.convert_lpips_weights(alex, lin)
    conv = lpips.convert_lpips_weights(alex, lin)
    for i in range(5):
        np.testing.assert_array_equal(conv[f"net.conv{i}.weight"].numpy().transpose(2, 3, 1, 0),
                                      jparams["net"][f"conv{i}"]["kernel"])
        np.testing.assert_array_equal(conv[f"lin{i}"].numpy(), jparams[f"lin{i}"])
    with pytest.raises(ValueError, match="AlexNet"):
        lpips.make_lpips_fn(lin_path, None, device="cpu")


# ------------------------------------------------------------------ FID

def test_fid_functions_match_jax():
    """calculate_frechet_distance (a well-conditioned pair, and a singular
    one that takes the eps*I offset), activation_statistics, the kNN
    precision/recall at k = 1, 3 and get_fid_pr, within 1e-6 relative."""
    rng = np.random.RandomState(14)
    fr = rng.randn(40, 6)
    fg = rng.randn(35, 6) * 1.3 + 0.2
    for a, b in ((fr, fg), (fr[:4], fg[:3])):   # 4 and 3 samples in 6 dims: singular
        mu_r, sig_r = fid.activation_statistics(a)
        mu_g, sig_g = fid.activation_statistics(b)
        jm, js = jax_fid.activation_statistics(a)
        np.testing.assert_array_equal(mu_r, jm)
        np.testing.assert_array_equal(sig_r, js)
        got = fid.calculate_frechet_distance(mu_r, sig_r, mu_g, sig_g)
        want = jax_fid.calculate_frechet_distance(mu_r, sig_r, mu_g, sig_g)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=FID_RTOL)
    for k in (1, 3):
        assert fid.calculate_precision_recall(fr, fg, k) == \
            jax_fid.calculate_precision_recall(fr, fg, k)
    got, want = fid.get_fid_pr(fr, fg, k=3), jax_fid.get_fid_pr(fr, fg, k=3)
    assert sorted(got) == sorted(want) == ["fid", "precision", "recall"]
    for m in want:
        np.testing.assert_allclose(got[m], want[m], rtol=FID_RTOL)
    # FVD's Frechet distance keeps its own rule (no offset): the JAX harness's
    np.testing.assert_allclose(video_gen.frechet_distance(fr, fg),
                               jax_video_gen.frechet_distance(fr, fg), rtol=FID_RTOL)


# ------------------------------------------------------------------ weights

def test_find_weights_order(tmp_path, monkeypatch):
    """The config's path, then $MCVD_WEIGHTS_DIR, then weights/ in the
    temporary directory; None where no file is; a config path that is not
    a file raises."""
    env_dir, tmp_dir = tmp_path / "env", tmp_path / "tmp"
    (tmp_dir / "weights").mkdir(parents=True)
    env_dir.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_dir))
    monkeypatch.setattr("tempfile.tempdir", None)
    monkeypatch.delenv("MCVD_WEIGHTS_DIR", raising=False)
    assert W.find_weights(None, W.I3D) is None
    (tmp_dir / "weights" / W.I3D).write_bytes(b"x")
    assert W.find_weights(None, W.I3D) == str(tmp_dir / "weights" / W.I3D)
    monkeypatch.setenv("MCVD_WEIGHTS_DIR", str(env_dir))
    (env_dir / W.I3D).write_bytes(b"x")
    assert W.find_weights(None, W.I3D) == str(env_dir / W.I3D)
    named = tmp_path / "mine.pt"
    named.write_bytes(b"x")
    assert W.find_weights(str(named), W.I3D) == str(named)
    with pytest.raises(FileNotFoundError, match="not a file"):
        W.find_weights(str(tmp_path / "absent.pt"), W.I3D)


# ------------------------------------------------------------------ ensemble sampler

@pytest.mark.parametrize("n_members", [2, 3])
def test_ensemble_block_sampler_matches_jax(tiny_models, n_members):
    """make_block_sampler(ensemble=True) with a list of state dicts against
    the JAX sampler with the same params stacked, the JAX draws replayed:
    within the sampler tests' chain tolerance. An ensemble of one weight set
    given twice gives that weight set's block bit for bit."""
    config, jmodel, params, model = tiny_models
    jsched, sched = jax_make_schedule(config), make_schedule(config)
    rng = np.random.RandomState(15)
    members = [params] + [jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.05 * rng.randn(*a.shape))).astype(np.float32), params)
        for _ in range(n_members - 1)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)
    shape = (2, 16, 16, 2)
    init = rng.randn(*shape).astype(np.float32)
    cond = rng.randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(16)
    jblock = jax_video_gen.make_block_sampler(config, jmodel, jsched, ensemble=True)
    want = np.asarray(jblock(stacked, key, jnp.asarray(init), jnp.asarray(cond), None))
    inj, step = replay_sampler_draws(key, shape, config.sampling.subsample)
    block = video_gen.make_block_sampler(config, model, sched, ensemble=True)
    got = block([port_params(p) for p in members], torch.from_numpy(init),
                torch.from_numpy(cond), inj_noise=inj, step_noise=step)
    np.testing.assert_allclose(got.numpy(), want, **CHAIN_TOL)

    one = video_gen.make_block_sampler(config, model, sched)
    w = port_params(params)
    args = (torch.from_numpy(init), torch.from_numpy(cond))
    assert torch.equal(block([w, w], *args, inj_noise=inj, step_noise=step),
                       one(w, *args, inj_noise=inj, step_noise=step))
    with pytest.raises(ValueError, match="no state dicts"):
        block([], *args, inj_noise=inj, step_noise=step)


# ------------------------------------------------------------------ load_model_from_ckpt

def test_load_model_from_upstream_pt_matches_jax(tmp_path):
    """A tiny upstream-format `.pt` ([sd, optim, epoch, step, ema], keys
    under `module.`, the EMA shadow differing from sd) with config.yml
    beside it: the port's load_model and the JAX package's (template init,
    load_reference_checkpoint with the EMA) give the same forward; the EMA
    is what both load. The port's own checkpoint loads its EMA too."""
    import load_model_from_ckpt as jax_loader
    from mcvd_tpu_torch.load_model_from_ckpt import load_model
    from mcvd_tpu_torch.train import checkpoints, create_train_state

    config = flagship_config(tiny=True)
    config.model.dropout = 0.0
    config.model.ema = True
    yaml_subset.dump_file(namespace2dict(config), str(tmp_path / "config.yml"))
    src = get_model(config, generator=torch.Generator().manual_seed(17), device="cpu")
    g = torch.Generator().manual_seed(18)
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    ema = {k: v + 0.05 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
           for k, v in dict(src.named_parameters()).items()}
    torch.save([{f"module.{k}": v for k, v in sd.items()}, {}, 1, 100,
                {f"module.{k}": v for k, v in ema.items()}], str(tmp_path / "ckpt.pt"))

    model, params, cfg, sched = load_model(str(tmp_path / "ckpt.pt"), device="cpu")
    assert cfg.model.ngf == config.model.ngf and sorted(params) == sorted(ema)
    for k, v in ema.items():
        assert torch.equal(params[k], v) and torch.equal(dict(model.named_parameters())[k], v)

    d, sz = config.data, config.data.image_size
    rng = np.random.RandomState(19)
    x = rng.randn(2, sz, sz, d.num_frames * d.channels).astype(np.float32)
    cond = rng.randn(2, sz, sz, d.num_frames_cond * d.channels).astype(np.float32)
    t = np.array([3, 500], np.int32)
    jmodel, jparams, jconfig, _ = jax_loader.load_model(str(tmp_path / "ckpt.pt"))
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(cond)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long(),
                    torch.from_numpy(cond).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)

    state = create_train_state(config, src, device="cpu")
    with torch.no_grad():
        for k, v in state.ema_params.items():
            v.copy_(ema[k])
    checkpoints.save_checkpoint(str(tmp_path), state, name="checkpoint_5")
    _, params2, _, _ = load_model(str(tmp_path / "checkpoint_5"), device="cpu")
    assert all(torch.equal(params2[k], ema[k]) for k in ema)
    torch.save({"not": "a list"}, str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="upstream checkpoint list"):
        load_model(str(tmp_path / "bad.pt"), device="cpu")
