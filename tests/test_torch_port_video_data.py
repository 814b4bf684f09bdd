"""The port's KTH, BAIR, Cityscapes, UCF101 and CIFAR10 readers, its
`get_dataset` branches, its loader's worker pool and SMMNIST's batch path,
held bit for bit against the JAX package on shards its converters' makers
wrote (h5py) and on shards the port wrote; then a tiny `--train` on
bair_big.yml through the CLI."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from mcvd_tpu.data import get_dataset as jax_get_dataset
from mcvd_tpu.data import h5 as jax_h5
from mcvd_tpu.data import image_datasets as jax_img
from mcvd_tpu.data import native as jax_native
from mcvd_tpu.data import video_datasets as jax_vd
from mcvd_tpu.data.converters import KTHMaker as JaxKTHMaker
from mcvd_tpu.data.converters import UCFMaker as JaxUCFMaker
from mcvd_tpu.data.loader import DataLoader as JaxDataLoader
from mcvd_tpu_torch import config as port_config
from mcvd_tpu_torch.data import DataLoader, get_dataset, h5, image_datasets, video_datasets
from tests.test_torch_port_h5 import smooth_frames
from tests.test_torch_port_runner import TORCH_THREADS, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_videos(maker_cls, out, items, num_per_shard=100000):
    m = maker_cls(str(out), num_per_shard=num_per_shard, video=True)
    for it in items:
        m.add_data(it, dtype="uint8")
    return m


def write_tree(root, makers):
    """The five datasets' trees under `root`, written by `makers` (the JAX
    package's or the port's (HDF5Maker, KTHMaker, UCFMaker)): KTH 30 videos
    of 32x32 grey frames over persons 1-25 with persons.pkl; BAIR and
    Cityscapes train (2 shards) and test; UCF101 6 train and 20 test videos
    of 64x85 frames with num_train / num_test; CIFAR-10 pickles. Video
    lengths 9-16 frames; a noise frame in each (raw chunks)."""
    plain, kth_maker, ucf_maker = makers
    rng = np.random.default_rng(11)
    persons = {p: [] for p in range(1, 26)}
    kth = []
    for i in range(30):
        kth.append((smooth_frames(rng, 9 + i % 8, (32, 32)), i % 25 + 1, i % 6))
        persons[i % 25 + 1].append(i)
    write_videos(kth_maker, root / "kth", kth).close()
    with open(root / "kth" / "persons.pkl", "wb") as f:
        pickle.dump(persons, f)
    for name in ("bair", "cityscapes"):
        for split, n, per in (("train", 10, 6), ("test", 5, 100)):
            vids = [smooth_frames(rng, 9 + i % 5, (32, 32, 3)) for i in range(n)]
            write_videos(plain, root / name / split, vids, per).close()
    ucf = write_videos(ucf_maker, root / "ucf",
                       [(smooth_frames(rng, 9 + i % 3, (64, 85, 3)), i % 4) for i in range(26)])
    ucf.writer.create_dataset("num_train", data=6)
    ucf.writer.create_dataset("num_test", data=20)
    ucf.close()
    (root / "cifar").mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(root / "cifar" / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                         b"labels": [int(v) for v in rng.integers(0, 10, 4)]}, f)


@pytest.fixture(scope="module", params=["jax", "port"])
def tree(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"data_{request.param}")
    makers = ((jax_h5.HDF5Maker, JaxKTHMaker, JaxUCFMaker) if request.param == "jax"
              else (h5.HDF5Maker, h5.KTHMaker, h5.UCFMaker))
    write_tree(root, makers)
    return root


def readers(tree, name, **kw):
    """(JAX reader, port reader) of `name` with the same arguments."""
    if name == "kth":
        args = (str(tree / "kth"),)
        cls = "KTHDataset"
    elif name in ("bair", "cityscapes"):
        args = (str(tree / name / kw.pop("split")),)
        cls = "BAIRDataset" if name == "bair" else "CityscapesDataset"
    else:
        args = (str(tree / "ucf"),)
        cls = "UCF101Dataset"
    return getattr(jax_vd, cls)(*args, **kw), getattr(video_datasets, cls)(*args, **kw)


def assert_same_clips(j, p, epochs=(0, 2)):
    assert len(j) == len(p)
    for epoch in epochs:
        j.set_epoch(epoch)
        p.set_epoch(epoch)
        for i in range(len(p)):
            (xj, yj), (xp, yp) = j[i], p[i]
            assert xp.dtype == np.float32 and xp.shape == xj.shape
            assert np.array_equal(xj, xp) and yj == yp, (epoch, i)


@pytest.mark.parametrize("cache_mb", [0, 64])
@pytest.mark.parametrize("seed", [0, 5])
def test_kth_clips_are_bit_equal_to_jax(tree, seed, cache_mb):
    """Train and test splits (persons 1-20 / 21-25), flip on and off,
    `start_at` 0 and 3, two epochs, the cache off and on."""
    for train, flip, start_at, total in ((True, True, 0, -1), (True, False, 0, 40),
                                         (False, False, 3, 16), (False, True, 0, -1)):
        j, p = readers(tree, "kth", frames_per_sample=5, train=train,
                       random_horizontal_flip=flip, start_at=start_at, total_videos=total,
                       seed=seed, cache_mb=cache_mb)
        assert_same_clips(j, p)


@pytest.mark.parametrize("cache_mb", [0, 64])
@pytest.mark.parametrize("name", ["bair", "cityscapes"])
def test_bair_and_cityscapes_clips_are_bit_equal_to_jax(tree, name, cache_mb):
    """Both splits (the train split over 2 shards), flip on and off, the hue
    jitter of bair.yml (0.2), two seeds and epochs, the cache off and on."""
    for split, flip, jitter, seed in (("train", True, 0.2, 0), ("train", False, 0.0, 3),
                                      ("test", False, 0.0, 1), ("train", True, 0.0, 7)):
        j, p = readers(tree, name, split=split, frames_per_sample=6,
                       random_horizontal_flip=flip, color_jitter=jitter, seed=seed,
                       cache_mb=cache_mb)
        assert_same_clips(j, p)


@pytest.mark.parametrize("cache_mb", [0, 64])
def test_ucf101_clips_are_bit_equal_to_jax(tree, cache_mb):
    """The random crop of the train split and the centre crop of the test
    split (every 10th video after the train block), flip on and off."""
    for train, flip, seed in ((True, True, 0), (True, False, 2), (False, False, 1),
                              (False, True, 4)):
        j, p = readers(tree, "ucf", frames_per_sample=4, image_size=64, train=train,
                       random_horizontal_flip=flip, seed=seed, cache_mb=cache_mb)
        assert len(p) == (6 if train else 2)
        assert_same_clips(j, p)


def test_cifar10_clips_are_bit_equal_to_jax(tree):
    for train, flip, seed in ((True, True, 0), (False, False, 1), (True, False, 3)):
        j = jax_img.CIFAR10Dataset(str(tree / "cifar"), train=train, random_flip=flip,
                                   seed=seed)
        p = image_datasets.CIFAR10Dataset(str(tree / "cifar"), train=train,
                                          random_flip=flip, seed=seed)
        assert len(p) == (20 if train else 4)
        assert_same_clips(j, p)


CONFIG_DATA = {"bair": "bair", "bair_big": "bair", "cityscapes_big": "cityscapes",
               "kth64_big": "kth", "ucf101": "ucf", "cifar10": "cifar"}


@pytest.mark.parametrize("name", sorted(CONFIG_DATA))
def test_get_dataset_matches_jax_on_the_shipped_configs(tree, name):
    """`get_dataset` on the shipped yml: the train and test splits' lengths
    and first clips, for the clips of training and of the in-training
    video_gen; then with `subset` / `test_subset` cutting them."""
    config = port_config.load_config(os.path.join(REPO, "configs", f"{name}.yml"))
    path = str(tree / CONFIG_DATA[name])
    for pred in (config.data.num_frames, 3):
        j = jax_get_dataset(path, config, video_frames_pred=pred, seed=2)
        p = get_dataset(path, config, video_frames_pred=pred, seed=2)
        for a, b in zip(j, p):
            assert type(a).__name__ == type(b).__name__ and len(a) == len(b)
            for i in (0, len(b) - 1):
                assert np.array_equal(a[i][0], b[i][0]) and a[i][1] == b[i][1]
    config.data.subset, config.data.test_subset = 3, 2
    j, p = jax_get_dataset(path, config, seed=2), get_dataset(path, config, seed=2)
    assert [len(d) for d in j] == [len(d) for d in p] == [3, 2]


def batches(loader, n):
    out = []
    for xs, ys in loader:
        out.append((xs, np.asarray(ys)))
        if len(out) == n:
            return out
    return out


@pytest.mark.parametrize("num_workers", [0, 4])
def test_loader_workers_give_jax_batches(tree, num_workers):
    """The loader with 0 and 4 worker threads: the JAX loader's batches, in
    its order, over three epochs of BAIR (hue jitter) and UCF101."""
    for name, kw in (("bair", dict(split="train", color_jitter=0.2)),
                     ("ucf", dict(image_size=64))):
        j, p = readers(tree, name, frames_per_sample=5, seed=4, **kw)
        lkw = dict(batch_size=4, shuffle=True, seed=9, drop_last=False, repeat=True,
                   num_workers=num_workers)
        jl, pl_ = JaxDataLoader(j, **lkw), DataLoader(p, **lkw)
        n = 3 * len(pl_)
        for (xj, yj), (xp, yp) in zip(batches(jl, n), batches(pl_, n)):
            assert np.array_equal(xj, xp) and np.array_equal(yj, yp)


def smmnist_ns(name):
    return port_config.dict2namespace({"data": {
        "dataset": name, "image_size": 64, "num_frames": 3, "num_frames_cond": 2,
        "num_frames_future": 0, "step_length": 0.1, "num_digits": 2}})


@pytest.mark.parametrize("name", ["StochasticMovingMNIST", "MovingMNIST"])
def test_smmnist_loader_batches_are_jax_native_batches(tmp_path, name):
    """The loader takes SMMNIST's batch path as the JAX loader does: its
    batches are the JAX package's native synthesizer's, bit for bit, over
    two epochs (not the per-item path's clips)."""
    assert jax_native.get_lib() is not None   # the JAX loader takes its native path
    jt, _ = jax_get_dataset(str(tmp_path), smmnist_ns(name), video_frames_pred=3, seed=1)
    pt, _ = get_dataset(str(tmp_path), smmnist_ns(name), video_frames_pred=3, seed=1)
    kw = dict(batch_size=16, shuffle=True, seed=3, drop_last=True, repeat=True)
    jl, pl_ = JaxDataLoader(jt, **kw), DataLoader(pt, **kw)
    got = batches(pl_, 2 * len(pl_))
    for (xj, yj), (xp, yp) in zip(batches(jl, 2 * len(jl)), got):
        assert xp.shape == (16, 5, 64, 64, 1) and xp.dtype == np.float32
        assert np.array_equal(xj, xp) and np.array_equal(yj, yp)
    first = DataLoader(pt, **kw)._epoch_indices()[0]
    assert not np.array_equal(got[0][0][0], pt[int(first)][0])


def test_cli_trains_on_a_synthetic_bair_shard(tmp_path):
    """`python -m mcvd_tpu_torch.main --train` on bair_big.yml (the model cut
    to a tiny size, 2 loader workers) for 3 steps on shards the port's
    `HDF5Maker` wrote, in a process where jax, flax, yaml, h5py, cv2 and the
    JAX package cannot be imported: it finishes, logs its wait on the loader
    and writes its checkpoint."""
    rng = np.random.default_rng(12)
    for split, n in (("train", 8), ("test", 4)):
        write_videos(h5.HDF5Maker, tmp_path / "data" / split,
                     [smooth_frames(rng, 8, (64, 64, 3)) for _ in range(n)]).close()
    fake = tmp_path / "blocked"
    for name in ("jax", "flax", "yaml", "mcvd_tpu", "h5py", "cv2"):
        (fake / name).mkdir(parents=True)
        (fake / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    mods = ["model.ngf=8", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
            "model.attn_resolutions=[32]", "model.n_head_channels=8", "model.num_classes=100",
            "data.num_frames=2", "data.num_workers=2", "training.batch_size=4",
            "training.n_iters=3", "training.checkpoint_freq=3", "training.val_freq=3",
            "training.log_freq=1"]
    env = dict(os.environ, PYTHONPATH=f"{fake}{os.pathsep}{REPO}",
               OMP_NUM_THREADS=str(TORCH_THREADS))
    cmd = [sys.executable, "-m", "mcvd_tpu_torch.main", "--config",
           os.path.join(REPO, "configs", "bair_big.yml"), "--exp", str(tmp_path / "exp"),
           "--data_path", str(tmp_path / "data"), "--ni", "--device", "cpu", "--train",
           "--config_mod", *mods]
    out = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "training done at step 3" in out.stderr
    assert out.stderr.count("ms/step waiting on data") == 3
    assert {"checkpoint", "config.yml"} <= set(os.listdir(tmp_path / "exp" / "logs"))
