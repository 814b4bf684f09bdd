"""The port's config, data and metric modules against the JAX package on the
same inputs: the YAML subset reader and writer against PyYAML, config mods
and validation, the SMMNIST synthesizer, the loader's order and split, the
device prefetch, and the per-video metrics."""

import glob
import math
import os
import pickle
import threading

import numpy as np
import pytest
import torch
import yaml

from mcvd_tpu import config as jax_config
from mcvd_tpu.data import get_dataset as jax_get_dataset
from mcvd_tpu.data.loader import DataLoader as JaxDataLoader
from mcvd_tpu.eval.metrics import video_metrics_batch as jax_video_metrics_batch
from mcvd_tpu_torch import config as port_config
from mcvd_tpu_torch.compat import yaml_subset
from mcvd_tpu_torch.data import DataLoader, get_dataset, prefetch_to_device
from mcvd_tpu_torch.eval.metrics import video_metrics_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yml")))


def test_the_shipped_configs_are_twenty():
    assert len(CONFIGS) == 20


# ------------------------------------------------------------------ YAML

@pytest.mark.parametrize("name", CONFIGS)
def test_yaml_reader_equals_safe_load(name):
    """Every shipped config reads as `yaml.safe_load` reads it: the same
    nested dict, the same types (`1.0e-08` a float, `InstanceNorm++` a
    string, null, booleans, multi-line flow mappings)."""
    path = os.path.join(REPO, "configs", name)
    with open(path) as f:
        want = yaml.safe_load(f)
    got = yaml_subset.load_file(path)
    assert got == want
    assert repr(got) == repr(want)   # types too: 0.0 is not 0, True is not 1


@pytest.mark.parametrize("name", CONFIGS)
def test_yaml_writer_round_trips_through_safe_load(name, tmp_path):
    """`save_config` of each config, as the CLI writes config.yml, reads back
    through `yaml.safe_load` and the port's reader as the same dict."""
    config = port_config.load_config(os.path.join(REPO, "configs", name))
    path = str(tmp_path / "config.yml")
    port_config.save_config(config, path)
    want = port_config.namespace2dict(config)
    with open(path) as f:
        assert yaml.safe_load(f) == want
    assert yaml_subset.load_file(path) == want


def test_yaml_writer_round_trips_metrics_and_args():
    """What the runner and the CLI write (best_metrics.yml, vid_metrics.yml,
    args.yml): floats of every size, inf and nan, strings that would read
    as other types, paths, empty strings and lists."""
    data = {"mse": {"value": 0.0123, "step": 6}, "ssim": {"value": 1e-30, "step": 9},
            "fvd": float("inf"), "lpips": float("nan"), "tiny": 1e-8, "big": 3.5e21,
            "neg": -0.0, "ckpt": 6.0, "comment": "", "verbose": "info", "t": "true",
            "num": "123", "sci": "1e-8", "colon": "a: b", "hash": "x #y", "quote": "it's",
            "path": "/tmp/exp dir/logs", "dash": "-x", "config_mod": ["a.b=1", "c=[1, 2]"],
            "empty": [], "flag": False, "none": None}
    text = yaml_subset.dump(data)
    for back in (yaml.safe_load(text), yaml_subset.load(text)):
        assert math.isnan(back.pop("lpips"))
        assert back == {k: v for k, v in data.items() if k != "lpips"}


@pytest.mark.parametrize("scalar", ["1e-8", "1.0e-08", "1.", ".5", "010", "0x1F", "0b101",
                                    "-7", "+3", "1_000", "yes", "Off", "NULL", "~", ".inf",
                                    "-.Inf", ".NaN", "InstanceNorm++", "a b"])
def test_yaml_scalars_resolve_as_safe_load(scalar):
    want = yaml.safe_load(f"k: {scalar}")["k"]
    got = yaml_subset.load(f"k: {scalar}")["k"]
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert repr(got) == repr(want)


@pytest.mark.parametrize("text", ["k: &a 1", "k: !!str 1", "k: |\n  x", "- a: 1",
                                  "a: 1\n---\nb: 2", "k: {a: 1"])
def test_yaml_refuses_what_is_outside_the_subset(text):
    with pytest.raises(yaml_subset.YAMLSubsetError):
        yaml_subset.load(text)


# ------------------------------------------------------------------ config

MODS = [
    [],
    ["model.ngf=32", "model.ch_mult=[1,2]", "training.n_iters=6", "sampling.subsample=100"],
    ["optim.eps=1e-8", "optim.lr=2e-4", "model.spade=True", "data.dataset=MovingMNIST"],
    ["new.section.key=hello world", "sampling.fvd=True", "sampling.num_frames_pred=5"],
    ["data.prob_mask_sync=True", "data.prob_mask_cond=0.5", "data.prob_mask_future=0.25"],
    ["model.cond_emb=True"],
    ["model.cond_emb=True", "data.prob_mask_cond=0.5", "sampling.fvd=True",
     "sampling.num_frames_pred=12", "training.L1=None"],
]


@pytest.mark.parametrize("i", range(len(MODS)))
def test_config_mods_and_validation_match_jax(i):
    """`load_config` with the same mods, then `validate_config`: the same
    nested dict as the JAX package's, or both refuse (the JAX package
    asserts, the port raises ValueError)."""
    path = os.path.join(REPO, "configs", "smmnist_DDPM_big5.yml")
    want = jax_config.load_config(path, MODS[i])
    got = port_config.load_config(path, MODS[i])
    assert port_config.namespace2dict(got) == jax_config.namespace2dict(want)
    try:
        jax_config.validate_config(want)
    except AssertionError:
        with pytest.raises(ValueError):
            port_config.validate_config(got)
        return
    port_config.validate_config(got)
    assert port_config.namespace2dict(got) == jax_config.namespace2dict(want)
    assert port_config.getattr_nested(got, "sampling.fvd") == \
        jax_config.getattr_nested(want, "sampling.fvd")
    clone = port_config.clone_config(got)
    clone.model.ngf = -1
    assert got.model.ngf != -1


def test_config_mod_without_equals_is_refused():
    cfg = port_config.dict2namespace({"a": {"b": 1}})
    with pytest.raises(ValueError, match="section.key=value"):
        port_config.apply_config_mods(cfg, ["a.b"])


# ------------------------------------------------------------------ SMMNIST

def data_ns(name="StochasticMovingMNIST", **kw):
    d = {"dataset": name, "image_size": 64, "num_frames": 3, "num_frames_cond": 2,
         "num_frames_future": 0, "step_length": 0.1, "num_digits": 2}
    d.update(kw)
    return port_config.dict2namespace({"data": d})


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("split", ["train", "test"])
def test_smmnist_clips_are_bit_equal_to_jax(split, seed, epoch, tmp_path):
    """The same clips, bit for bit, as the JAX package's `dataset[i]` (the
    per-item path; the procedural digits: no MNIST files here)."""
    config = data_ns()
    jax_ds = jax_get_dataset(str(tmp_path), config, video_frames_pred=4, seed=seed)
    port_ds = get_dataset(str(tmp_path), config, video_frames_pred=4, seed=seed)
    j, p = (ds[0 if split == "train" else 1] for ds in (jax_ds, port_ds))
    assert len(j) == len(p)
    j.set_epoch(epoch)
    p.set_epoch(epoch)
    for i in (0, 1, 7, len(p) - 1):
        xj, yj = j[i]
        xp, yp = p[i]
        assert xp.dtype == np.float32 and xp.shape == (6, 64, 64, 1)
        assert np.array_equal(xp, xj) and yp == yj


def test_moving_mnist_and_subsets_match_jax(tmp_path):
    """The deterministic variant, and `subset` / `test_subset` cut the
    splits as the JAX package cuts them."""
    config = data_ns("MovingMNIST", subset=10, test_subset=5)
    jt, jv = jax_get_dataset(str(tmp_path), config, video_frames_pred=2)
    pt, pv = get_dataset(str(tmp_path), config, video_frames_pred=2)
    assert (len(pt), len(pv)) == (len(jt), len(jv)) == (10, 5)
    for a, b in ((jt, pt), (jv, pv)):
        for i in range(len(a)):
            assert np.array_equal(a[i][0], b[i][0])


@pytest.mark.parametrize("name", ["CelebA", "LSUN", "FFHQ", "ImageNet"])
def test_other_datasets_name_their_roadmap_item(tmp_path, name):
    """The datasets whose images need a decoder the port lacks still raise,
    naming their ROADMAP item; an unknown name is refused."""
    with pytest.raises(NotImplementedError, match="item 9"):
        get_dataset(str(tmp_path), data_ns(name))
    with pytest.raises(ValueError, match="one of"):
        get_dataset(str(tmp_path), data_ns("NoSuchSet"))


# ------------------------------------------------------------------ loader

class Indices:
    """A dataset whose item i is (array filled with i, i), with epochs."""

    def __init__(self, n):
        self.n, self.epochs = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), i

    def set_epoch(self, e):
        self.epochs.append(e)


def take(loader, n):
    out = []
    for xs, ys in loader:
        out.append((xs.copy(), np.asarray(ys).copy()))
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("n_proc,drop_last", [(1, True), (1, False), (2, True), (3, False)])
def test_loader_order_and_split_match_jax(n_proc, drop_last):
    """Every process's batches over three epochs (repeat) in the JAX
    loader's order: the epoch permutation, the per-process split, the last
    partial batch kept or dropped."""
    for rank in range(n_proc):
        kw = dict(batch_size=4, shuffle=True, seed=5, drop_last=drop_last,
                  num_processes=n_proc, process_index=rank, repeat=True)
        jl, pl_ = JaxDataLoader(Indices(23), **kw), DataLoader(Indices(23), **kw)
        assert len(pl_) == len(jl)
        n = 3 * len(jl)
        for (xj, yj), (xp, yp) in zip(take(jl, n), take(pl_, n)):
            assert np.array_equal(xj, xp) and np.array_equal(yj, yp)


def test_loader_drop_last_guard_matches_jax():
    for cls in (JaxDataLoader, DataLoader):
        with pytest.raises(ValueError, match="no batch would ever be yielded"):
            cls(Indices(10), batch_size=8, drop_last=True, num_processes=2)
    unshuffled = DataLoader(Indices(5), batch_size=2, shuffle=False)
    assert [list(y) for _, y in unshuffled] == [[0, 1], [2, 3], [4]]


def test_prefetch_to_device_keeps_order_and_raises_the_producers_error():
    batches = [(np.full((2, 3), i, np.float32), None) for i in range(5)]
    got = list(prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(got) == 5
    for i, (x, y) in enumerate(got):
        assert isinstance(x, torch.Tensor) and y is None
        assert torch.equal(x, torch.full((2, 3), float(i)))

    def broken():
        yield (np.zeros(1),)
        raise RuntimeError("synthesis failed")

    it = prefetch_to_device(broken(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="synthesis failed"):
        next(it)


def test_prefetch_to_device_stops_its_producer_when_closed():
    def endless():
        i = 0
        while True:
            yield (np.full((1,), i),)
            i += 1

    it = prefetch_to_device(endless(), "cpu", size=2)
    assert int(next(it)[0]) == 0 and int(next(it)[0]) == 1
    assert any(t.name == "prefetch_to_device" and t.is_alive()
               for t in threading.enumerate())
    it.close()
    assert not any(t.name == "prefetch_to_device" and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------------------------------------ metrics

@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("is_mnist,calc_ssim", [(False, True), (True, True), (False, False)])
def test_video_metrics_batch_matches_jax(is_mnist, calc_ssim, channels):
    """MSE, PSNR and SSIM per video equal the JAX package's within 1e-12
    (the same float64 numpy arithmetic)."""
    rng = np.random.RandomState(11)
    real = rng.rand(3, 4, 32, 32, channels).astype(np.float32)
    pred = np.clip(real + 0.2 * rng.randn(*real.shape), 0, 1).astype(np.float32)
    want = jax_video_metrics_batch(real, pred, is_mnist=is_mnist, calc_ssim=calc_ssim)
    got = video_metrics_batch(real, pred, is_mnist=is_mnist, calc_ssim=calc_ssim)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


def test_meters_pickle_round_trip(tmp_path):
    from mcvd_tpu.runners import meters as jax_meters
    from mcvd_tpu_torch.runners import meters

    m = meters.init_meters()
    assert sorted(m) == sorted(jax_meters.init_meters())
    m["losses_train"].update(1.5, 3)
    best = meters.update_best(m, {"mse": 0.1, "ssim2": 0.5, "psnr": float("nan")}, 3)
    assert best == jax_meters.update_best(jax_meters.init_meters(),
                                          {"mse": 0.1, "ssim2": 0.5, "psnr": float("nan")}, 3)
    meters.save_meters(m, str(tmp_path))
    back = meters.load_meters(str(tmp_path))
    assert back["losses_train"].vals == [1.5] and back["losses_train"].steps == [3]
    with open(tmp_path / "meters.pkl", "rb") as f:
        assert pickle.load(f)["best"] == best
