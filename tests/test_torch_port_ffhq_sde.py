"""The port's pure-Python TFRecord reader and writer (`data/tfrecord.py`),
its FFHQ reader and split (`data/image_datasets.py`, `get_dataset`), the
score SDEs (`diffusion/sde_lib.py`) and the score-SDE registry
(`models/registry.py`) against the JAX package: records written by each
package read by the other bit-equal with their CRCs checked, FFHQ's images
and 90/10 split bit-equal, the SDE tables exact and their methods within
rtol 1e-6, the registry's ladders and tables exact and its score
wrappers' labels and scalings within rtol 1e-6."""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcvd_tpu.config import dict2namespace as jax_dict2namespace
from mcvd_tpu.data import get_dataset as jax_get_dataset
from mcvd_tpu.data import tfrecord as jtf
from mcvd_tpu.diffusion import sde_lib as jsde
from mcvd_tpu.models import registry as jreg
from mcvd_tpu_torch.config import dict2namespace, load_config
from mcvd_tpu_torch.data import get_dataset
from mcvd_tpu_torch.data import tfrecord as tf
from mcvd_tpu_torch.diffusion import sde_lib
from mcvd_tpu_torch.models import registry
from mcvd_tpu_torch.models.ncsnpp import UNetMoreDDPM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6

# ---------------------------------------------------------------- TFRecords

EXAMPLES = [
    {"data": [b"\x00\x01\xff" * 5], "shape": [3, 1, 5], "neg": [-1, -(2 ** 40), 7]},
    {"floats": [0.5, -2.25, 1e-3], "mixed": [1, 2.5], "bytes2": [b"a", b"", b"ccc"]},
    {"big": [2 ** 62, 0], "name": ["ffhq".encode()]},
]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tfrecords_cross_read_bit_equal(tmp_path, writer):
    """Examples written by one package, read by both with verify_crc: the
    same payloads, the same parsed features; the two writers' files are
    byte-identical; a flipped payload byte fails the CRC in both readers."""
    w, r = (jtf, tf) if writer == "jax" else (tf, jtf)
    path = str(tmp_path / "x.tfrecords")
    w.write_examples(path, EXAMPLES)
    other = str(tmp_path / "y.tfrecords")
    r.write_examples(other, EXAMPLES)
    assert open(path, "rb").read() == open(other, "rb").read()
    for reader in (r, w):
        got = list(reader.read_examples(path, verify_crc=True))
        assert len(got) == len(EXAMPLES)
        for g, e in zip(got, EXAMPLES):
            assert set(g) == set(e)
            for k in e:
                if isinstance(e[k][0], float) or k == "mixed":
                    np.testing.assert_array_equal(np.float32(g[k]), np.float32(e[k]))
                else:
                    assert g[k] == e[k], k
    assert list(r.read_tfrecord(path)) == list(w.read_tfrecord(path))
    raw = bytearray(open(path, "rb").read())
    raw[12 + 3] ^= 0xFF   # a byte of the first payload (8 length + 4 crc)
    bad = str(tmp_path / "bad.tfrecords")
    open(bad, "wb").write(bytes(raw))
    for reader in (tf, jtf):
        with pytest.raises(ValueError, match="payload-crc"):
            list(reader.read_tfrecord(bad, verify_crc=True))
    assert tf._masked_crc(b"123456789") == jtf._masked_crc(b"123456789")
    assert tf._crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value
    assert struct.unpack("<Q", bytes(raw[:8]))[0] == len(list(tf.read_tfrecord(path))[0])


def test_encode_example_refuses_what_the_jax_writer_refuses():
    for bad in ({"e": []}, {"m": [b"a", 1]}, {"o": [object()]}):
        for m in (tf, jtf):
            with pytest.raises(ValueError):
                m.encode_example(bad)


# --------------------------------------------------------------------- FFHQ

def write_ffhq(path, n, res, seed=0):
    """StyleGAN's layout: per example 'data' = raw CHW uint8, 'shape' =
    [3, res, res]."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 3, res, res), dtype=np.uint8)
    tf.write_examples(path, ({"data": [im.tobytes()], "shape": [3, res, res]} for im in imgs))
    return imgs


def ffhq_dict(res, flip):
    return {"data": {"dataset": "FFHQ", "image_size": res, "channels": 3, "num_frames": 1,
                     "num_frames_cond": 0, "num_frames_future": 0, "random_flip": flip},
            "model": {"version": "SMLD"}}


@pytest.mark.parametrize("flip", [False, True])
def test_ffhq_dataset_and_split_match_jax(tmp_path, flip):
    """Two shards of the resolution (and one of another, which the glob
    leaves out): both packages' get_dataset give the same 90/10 split of
    the seed-2019 shuffle and bit-equal (1, H, W, 3) images, flips
    included."""
    write_ffhq(str(tmp_path / "ffhq-0-r16.tfrecords"), 7, 16, seed=1)
    write_ffhq(str(tmp_path / "ffhq-1-r16.tfrecords"), 6, 16, seed=2)
    write_ffhq(str(tmp_path / "ffhq-r32.tfrecords"), 2, 32, seed=3)
    d = ffhq_dict(16, flip)
    jtrain, jtest = jax_get_dataset(str(tmp_path), jax_dict2namespace(d), seed=5)
    train, test = get_dataset(str(tmp_path), dict2namespace(d), seed=5)
    assert (len(train), len(test)) == (len(jtrain), len(jtest)) == (11, 2)
    assert train.indices == jtrain.indices and test.indices == jtest.indices
    for ds, jds in ((train, jtrain), (test, jtest)):
        for i in range(len(ds)):
            (v, t), (jv, jt) = ds[i], jds[i]
            assert v.shape == (1, 16, 16, 3) and v.dtype == np.float32 and t == jt == 0
            np.testing.assert_array_equal(v, jv)


def test_get_dataset_reads_ffhq_yml(tmp_path):
    """ffhq.yml as shipped (256 px) on a synthetic r256 shard: 9 train and
    1 test image, the first one's pixels as written (CHW -> HWC, / 255)."""
    imgs = write_ffhq(str(tmp_path / "ffhq-r256.tfrecords"), 10, 256)
    config = load_config(os.path.join(REPO, "configs", "ffhq.yml"), ["data.random_flip=false"])
    train, test = get_dataset(str(tmp_path), config)
    assert (len(train), len(test)) == (9, 1)
    v, _ = train[0]
    want = imgs[train.indices[0]].transpose(1, 2, 0)[None].astype(np.float32) / 255.0
    np.testing.assert_array_equal(v, want)
    with pytest.raises(FileNotFoundError):
        get_dataset(str(tmp_path / "none"), config)


# --------------------------------------------------------------------- SDEs

SDES = {"vp": lambda m: m.VPSDE(beta_min=0.1, beta_max=20.0, N=50),
        "subvp": lambda m: m.subVPSDE(beta_min=0.1, beta_max=20.0, N=50),
        "ve": lambda m: m.VESDE(sigma_min=0.01, sigma_max=50.0, N=40)}


@pytest.mark.parametrize("name", list(SDES))
def test_sde_matches_jax(name):
    js, ps = SDES[name](jsde), SDES[name](sde_lib)
    for attr in ("discrete_betas", "alphas", "alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_1m_alphas_cumprod", "discrete_sigmas"):
        if hasattr(js, attr):
            np.testing.assert_array_equal(getattr(ps, attr), getattr(js, attr))
    assert ps.N == js.N and ps.T == js.T
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 5, 5).astype(np.float32)
    t = np.array([0.0, 0.31, 0.77, 1.0], np.float32)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    for method in ("sde", "marginal_prob", "discretize"):
        got = getattr(ps, method)(tx, tt)
        want = getattr(js, method)(jnp.asarray(x), jnp.asarray(t))
        for g, w in zip(got, want):
            w = np.broadcast_to(np.asarray(w), np.shape(np.asarray(g)))
            np.testing.assert_allclose(np.asarray(g), w, rtol=RTOL, atol=1e-6,
                                       err_msg=method)
    np.testing.assert_allclose(ps.prior_logp(tx).numpy(),
                               np.asarray(js.prior_logp(jnp.asarray(x))), rtol=RTOL)
    z = ps.prior_sampling((2000, 8), generator=torch.Generator().manual_seed(0), device="cpu")
    std = 50.0 if name == "ve" else 1.0
    assert z.shape == (2000, 8) and abs(float(z.std()) / std - 1.0) < 0.05


# ----------------------------------------------------------------- registry

def cfg(**model):
    return jax_dict2namespace({"model": model}), dict2namespace({"model": model})


def test_registry_tables_match_jax():
    jc, pc = cfg(sigma_max=50.0, sigma_min=0.01, num_scales=232, beta_min=0.1, beta_max=20.0)
    np.testing.assert_array_equal(registry.get_sigmas(pc), jreg.get_sigmas(jc))
    want, got = jreg.get_ddpm_params(jc), registry.get_ddpm_params(pc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_register_create_and_flatten():
    @registry.register_model(name="port_test_model")
    class _M(torch.nn.Module):
        def __init__(self, config):
            super().__init__()
            self.config = config

    try:
        assert registry.get_model("port_test_model") is _M
        with pytest.raises(ValueError, match="Already registered"):
            registry.register_model(_M, name="port_test_model")
        _, pc = cfg(name="port_test_model", arch="unetmore")
        assert isinstance(registry.create_model(pc), _M)
    finally:
        del registry._MODELS["port_test_model"]
    for arch in ("unetmore", "unetmore3d", "unetmorepseudo3d"):
        assert registry.get_model(arch) is UNetMoreDDPM
    assert set(registry._MODELS) == set(jreg._MODELS)
    x = torch.arange(6.0).reshape(2, 3)
    flat = registry.to_flattened_numpy(x)
    assert flat.shape == (6,)
    np.testing.assert_array_equal(registry.from_flattened_numpy(flat, (2, 3)).numpy(),
                                  x.numpy())
    np.testing.assert_array_equal(flat, jreg.to_flattened_numpy(jnp.asarray(x.numpy())))


class _Gain(torch.nn.Module):
    """out = gain * x, recording the labels it was called with."""

    def __init__(self):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.tensor(1.0))
        self.seen = None

    def forward(self, x, labels):
        self.seen = labels
        return self.gain * x


class _JaxGain:
    def __init__(self):
        self.seen = None

    def apply(self, params, x, labels, **kw):
        self.seen = labels
        return params["gain"] * x


SCORES = [("vp", False), ("vp", True), ("subvp", False), ("ve", False), ("ve", True)]


@pytest.mark.parametrize("name,continuous", SCORES)
def test_score_fn_matches_jax(name, continuous):
    """The labels each wrapper feeds the model and the scores it returns, on
    weights passed per call (gain 2)."""
    js, ps = SDES[name](jsde), SDES[name](sde_lib)
    jm, pm = _JaxGain(), _Gain()
    want_fn = jreg.get_score_fn(js, jm, {"gain": 2.0}, continuous=continuous)
    got_fn = registry.get_score_fn(ps, pm, {"gain": torch.tensor(2.0)}, continuous=continuous)
    x = np.random.RandomState(1).randn(3, 2, 4, 4).astype(np.float32)
    for t in ([0.0, 0.5, 1.0], [0.013, 0.3, 0.999]):
        t = np.asarray(t, np.float32)
        want = np.asarray(want_fn(jnp.asarray(x), jnp.asarray(t)))
        got = got_fn(torch.from_numpy(x), torch.from_numpy(t))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(pm.seen.numpy(), np.asarray(jm.seen), rtol=RTOL)
    assert float(pm.gain.detach()) == 1.0   # the module's own weight is untouched
    with pytest.raises(NotImplementedError):
        registry.get_score_fn(object(), pm)
