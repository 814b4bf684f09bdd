"""The port's image data path held against the JAX package on this host:
the LMDB store both ways (JAX writer to the port's reader, the port's
writer to the JAX reader), the CelebA / LSUN / ImageFolder items and
`get_dataset`'s CELEBA, LSUN and IMAGENET branches with flips on (bit for
bit: the port decodes without PIL), the loader's threads, the BAIR and
Cityscapes converters' shards and their CLI, `fid_pr` (its image loading,
nearest-neighbour grid, FID and precision/recall, and the CLI on the CPU),
and the sample grid's GIF."""

import importlib.util
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
from PIL import Image

from mcvd_tpu.config import dict2namespace as jax_namespace
from mcvd_tpu.data import get_dataset as jax_get_dataset
from mcvd_tpu.data import image_datasets as jax_img
from mcvd_tpu.data import lmdb_io as jax_lmdb
from mcvd_tpu_torch import config as port_config
from mcvd_tpu_torch.data import DataLoader, codecs, get_dataset, image_datasets, lmdb_io
from tests.test_image_datasets import write_celeba, write_lsun
from tests.test_torch_port_images import smooth_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS_ENV = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")


def lmdb_items(seed=0, n=600):
    rng = np.random.RandomState(seed)
    items = [(f"k{i:06d}".encode(),
              rng.randint(0, 255, rng.choice([8, 300, 6000]), np.uint8).tobytes())
             for i in range(n)]
    return items + [(b"empty-value", b""), (b"k" * 180, b"long-key")]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lmdb_across_packages(tmp_path, writer):
    """Inline and overflow values, branch levels, an empty value, a long
    key; keys-only walks; an empty environment."""
    write, Reader = ((jax_lmdb.write_lmdb, lmdb_io.LMDBReader) if writer == "jax"
                     else (lmdb_io.write_lmdb, jax_lmdb.LMDBReader))
    items = lmdb_items()
    write(str(tmp_path / "env"), items)
    with Reader(str(tmp_path / "env")) as r:
        assert len(r) == len(items) and r.depth >= 2
        assert dict(r.items()) == dict(items)
        assert list(r.keys()) == sorted(k for k, _ in items)
        assert r.get(b"k000421") == dict(items)[b"k000421"] and r.get(b"absent") is None
    write(str(tmp_path / "empty"), [])
    with Reader(str(tmp_path / "empty")) as r:
        assert len(r) == 0 and list(r.items()) == []
    # the two writers write the same bytes
    other = jax_lmdb.write_lmdb if writer == "port" else lmdb_io.write_lmdb
    other(str(tmp_path / "env2"), items)
    assert (tmp_path / "env" / "data.mdb").read_bytes() == \
        (tmp_path / "env2" / "data.mdb").read_bytes()


def assert_same_items(j, p, indices=None):
    assert len(j) == len(p)
    for i in indices if indices is not None else range(len(p)):
        (vj, tj), (vp, tp) = j[i], p[i]
        assert vp.dtype == np.float32 and vp.shape == vj.shape
        assert np.array_equal(vj, vp) and tj == tp, i


def test_celeba_items_are_bit_equal_to_jax(tmp_path):
    write_celeba(str(tmp_path), n=6)
    for split, flip, seed in (("train", True, 0), ("test", False, 1), ("train", True, 5)):
        for size in (64, 32):
            j = jax_img.CelebADataset(str(tmp_path), split=split, image_size=size,
                                      random_flip=flip, seed=seed)
            p = image_datasets.CelebADataset(str(tmp_path), split=split, image_size=size,
                                             random_flip=flip, seed=seed)
            assert_same_items(j, p)
            j.set_epoch(3)
            p.set_epoch(3)
            assert_same_items(j, p)


def test_lsun_items_are_bit_equal_to_jax(tmp_path):
    """WebP and PNG values (the JAX package's fixture), and the key cache."""
    write_lsun(str(tmp_path), n=6)
    for size in (32, 64, 128):
        j = jax_img.LSUNDataset(str(tmp_path), "church_outdoor", image_size=size,
                                random_flip=True, seed=size)
        p = image_datasets.LSUNDataset(str(tmp_path), "church_outdoor", image_size=size,
                                       random_flip=True, seed=size)
        assert p.keys == j.keys
        assert_same_items(j, p)
    assert (tmp_path / "church_outdoor_train_lmdb" / "_keys_cache.pkl").exists()


def write_image_folder(root, seed=0):
    """Three classes of png / jpg / bmp / webp files of several sizes."""
    rng = np.random.default_rng(seed)
    fmts = ["PNG", "JPEG", "BMP", "WEBP"]
    for ci, cname in enumerate(("catfish", "dogwood", "eel")):
        os.makedirs(os.path.join(root, cname))
        for i in range(4):
            h, w = (int(v) for v in rng.integers(40, 120, 2))
            img = smooth_image(h, w, seed=10 * ci + i, noise=8.0)
            fmt = fmts[(ci + i) % 4]
            ext = {"JPEG": "jpg"}.get(fmt, fmt.lower())
            Image.fromarray(img).save(os.path.join(root, cname, f"{i}.{ext}"), fmt)
        open(os.path.join(root, cname, "notes.txt"), "w").write("not an image")


def test_image_folder_items_are_bit_equal_to_jax(tmp_path):
    write_image_folder(str(tmp_path / "train"))
    for classes in (None, [0, "eel"]):
        j = jax_img.ImageFolderDataset(str(tmp_path / "train"), image_size=32,
                                       random_flip=True, seed=4, classes=classes)
        p = image_datasets.ImageFolderDataset(str(tmp_path / "train"), image_size=32,
                                              random_flip=True, seed=4, classes=classes)
        assert [s[0] for s in p.samples] == [s[0] for s in j.samples]
        assert_same_items(j, p)
    assert len(p) == 8


def image_config(dataset, size, **extra):
    d = {"data": {"dataset": dataset, "image_size": size, "channels": 3, "num_frames": 1,
                  "num_frames_cond": 0, "num_frames_future": 0, "random_flip": True, **extra}}
    return jax_namespace(d), port_config.dict2namespace(d)


@pytest.mark.parametrize("name", ["CELEBA", "LSUN", "IMAGENET"])
def test_get_dataset_matches_jax(tmp_path, name):
    if name == "CELEBA":
        write_celeba(str(tmp_path), n=6)
        cj, cp = image_config("CELEBA", 64)
    elif name == "LSUN":
        write_lsun(str(tmp_path), split="train", n=5)
        write_lsun(str(tmp_path), split="val", n=3)
        cj, cp = image_config("LSUN", 32, category="church_outdoor")
    else:
        write_image_folder(str(tmp_path / "train"), seed=1)
        write_image_folder(str(tmp_path / "val"), seed=2)
        cj, cp = image_config("IMAGENET", 32, classes=[1, 2])
    for subset in (-1, 3):
        cj.data.subset = cp.data.subset = subset
        j = jax_get_dataset(str(tmp_path), cj, video_frames_pred=1, seed=2)
        p = get_dataset(str(tmp_path), cp, video_frames_pred=1, seed=2)
        for a, b in zip(j, p):
            assert type(a).__name__ == type(b).__name__
            assert_same_items(a, b)


def test_shipped_image_configs_build_their_datasets(tmp_path):
    """celeba.yml and church/bedroom/tower.yml reach their readers (the
    image configs no longer raise)."""
    write_celeba(str(tmp_path / "celeba_root"), n=6)
    for cat in ("church_outdoor", "bedroom", "tower"):
        for split in ("train", "val"):
            write_lsun(str(tmp_path / "lsun_root"), category=cat, split=split, n=2)
    for yml, root in (("celeba", "celeba_root"), ("church", "lsun_root"),
                      ("bedroom", "lsun_root"), ("tower", "lsun_root")):
        config = port_config.load_config(os.path.join(REPO, "configs", f"{yml}.yml"))
        train, test = get_dataset(str(tmp_path / root), config)
        size = config.data.image_size
        assert train[0][0].shape == (1, size, size, 3) and len(test) > 0


def test_loader_threads_give_the_same_batches(tmp_path):
    write_celeba(str(tmp_path), n=6)
    ds = image_datasets.CelebADataset(str(tmp_path), image_size=32, random_flip=True)
    got = []
    for workers in (0, 4):
        loader = DataLoader(ds, batch_size=3, shuffle=True, seed=1, num_workers=workers)
        got.append([np.asarray(x) for x, _ in loader])
    assert len(got[0]) == 2 and all(np.array_equal(a, b) for a, b in zip(*got))


# ------------------------------------------------------------------ converters

def h5_contents(root):
    out = {}
    for shard in sorted(os.listdir(root)):
        with h5py.File(os.path.join(root, shard), "r") as f:
            f.visititems(lambda name, obj: out.__setitem__(
                f"{shard}/{name}", obj[()]) if isinstance(obj, h5py.Dataset) else None)
    return out


def assert_same_shards(a, b):
    ca, cb = h5_contents(a), h5_contents(b)
    assert sorted(ca) == sorted(cb) and ca
    for k in ca:
        assert np.array_equal(ca[k], cb[k]), k


def write_bair(root, split="train"):
    """JPEG frames (the JAX package's synthetic BAIR tool), plus a record of
    PNG frames and one of raw 64x64x3 bytes."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synth_bair import write_split

    from mcvd_tpu.data.tfrecord import write_examples

    write_split(str(root), split, n_videos=3, frames=5, seed=0, per_record=2)
    frames = [smooth_image(64, 64, seed=t) for t in range(4)]
    png = {f"{t}/image_main/encoded": [codecs.encode_png(f)] for t, f in enumerate(frames)}
    raw = {f"{t}/image_aux1/encoded": [f.tobytes()] for t, f in enumerate(frames)}
    write_examples(os.path.join(root, split, "z_extra.tfrecords"), [png, raw])


def write_cityscapes(root, split="train"):
    for city, seqs in (("aachen", ("000001", "000002")), ("bochum", ("000010",))):
        d = os.path.join(root, "leftImg8bit_sequence", split, city)
        os.makedirs(d)
        for seq in seqs:
            for fr in range(3):
                h = 1024 if (city, seq, fr) == ("aachen", "000001", 0) else 256
                Image.fromarray(smooth_image(h, 2 * h, seed=fr, noise=10.0)).save(
                    os.path.join(d, f"{city}_{seq}_{fr:06d}_leftImg8bit.png"))


def test_converters_write_the_jax_converters_shards(tmp_path):
    from mcvd_tpu.data import converters as jax_conv
    from mcvd_tpu_torch.data import converters

    write_bair(tmp_path / "bair")
    assert jax_conv.bair_convert(str(tmp_path / "bair"), str(tmp_path / "jb")) == 5
    assert converters.bair_convert(str(tmp_path / "bair"), str(tmp_path / "pb")) == 5
    assert_same_shards(tmp_path / "jb" / "train", tmp_path / "pb" / "train")
    write_cityscapes(tmp_path / "cs")
    assert jax_conv.cityscapes_convert(str(tmp_path / "cs"), str(tmp_path / "jc")) == 3
    assert converters.cityscapes_convert(str(tmp_path / "cs"), str(tmp_path / "pc")) == 3
    assert_same_shards(tmp_path / "jc" / "train", tmp_path / "pc" / "train")


def test_convert_dataset_cli(tmp_path):
    write_bair(tmp_path / "bair", split="test")
    write_cityscapes(tmp_path / "cs", split="val")
    for args, n in ((["bair", "--in", str(tmp_path / "bair"), "--split", "test"], 5),
                    (["cityscapes", "--in", str(tmp_path / "cs"), "--split", "val"], 3)):
        out = subprocess.run([sys.executable, "-m", "mcvd_tpu_torch.tools.convert_dataset",
                              *args, "--out", str(tmp_path / f"out_{args[0]}")], cwd=REPO,
                             capture_output=True, text=True, env=THREADS_ENV, timeout=300)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == f"converted: {n}"
    from mcvd_tpu_torch.data.video_datasets import CityscapesDataset

    ds = CityscapesDataset(str(tmp_path / "out_cityscapes" / "val"), frames_per_sample=2)
    assert ds[0][0].shape == (2, 128, 128, 3)


# ------------------------------------------------------------------ fid_pr

def jax_fid_tool():
    spec = importlib.util.spec_from_file_location("jax_fid_pr", os.path.join(REPO, "tools",
                                                                            "fid_pr.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_sample_dir(d, n=6, seed=0):
    os.makedirs(d)
    for i in range(n):
        fmt = ("PNG", "JPEG", "BMP")[i % 3]
        Image.fromarray(smooth_image(24, 24, seed=seed + i, noise=10.0)).save(
            os.path.join(d, f"{i:03d}.{'jpg' if fmt == 'JPEG' else fmt.lower()}"), fmt)


def test_fid_pr_load_images_and_grid_match_jax(tmp_path):
    from mcvd_tpu_torch.eval.fid import get_fid_pr
    from mcvd_tpu_torch.tools import fid_pr

    jtool = jax_fid_tool()
    write_sample_dir(str(tmp_path / "imgs"))
    np.testing.assert_array_equal(fid_pr.load_images(str(tmp_path / "imgs")),
                                  jtool.load_images(str(tmp_path / "imgs")))
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (5, 8, 8, 3)).astype(np.float32)
    np.savez(tmp_path / "a.npz", x=arr)
    np.testing.assert_array_equal(fid_pr.load_images(str(tmp_path / "a.npz")),
                                  jtool.load_images(str(tmp_path / "a.npz")))
    real, gen = rng.random((12, 8, 8, 1), np.float32), rng.random((6, 8, 8, 1), np.float32)
    fr, fg, ff = (rng.normal(size=(n, 16)) for n in (12, 6, 6))
    a = fid_pr.nearest_neighbor_grid(real, gen, fr, fg, ff, 3, 4, str(tmp_path / "p.png"))
    b = jtool.nearest_neighbor_grid(real, gen, fr, fg, ff, 3, 4, str(tmp_path / "j.png"))
    assert np.array_equal(a, b)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                          np.asarray(Image.open(tmp_path / "j.png")))
    from mcvd_tpu.eval import fid as jax_fid

    fr, fg = rng.normal(size=(40, 8)), rng.normal(0.3, 1.1, size=(30, 8))
    got = get_fid_pr(fr, fg, k=3)
    want_fid = jax_fid.calculate_frechet_distance(*jax_fid.activation_statistics(fr),
                                                  *jax_fid.activation_statistics(fg))
    want_pr = jax_fid.calculate_precision_recall(fr, fg, k=3)
    np.testing.assert_allclose(got["fid"], want_fid, rtol=1e-6)
    np.testing.assert_allclose([got["precision"], got["recall"]], want_pr, rtol=1e-6)


def test_fid_pr_cli_on_the_cpu(tmp_path):
    from mcvd_tpu_torch.eval.fid import get_fid_pr, make_inception_embedder
    from mcvd_tpu_torch.eval.standins import write_standins

    paths = write_standins(str(tmp_path / "w"))
    write_sample_dir(str(tmp_path / "gen"), n=8, seed=50)
    real = np.random.default_rng(1).random((10, 24, 24, 3)).astype(np.float32)
    np.savez(tmp_path / "real.npz", real)
    cmd = [sys.executable, "-m", "mcvd_tpu_torch.tools.fid_pr", str(tmp_path / "real.npz"),
           str(tmp_path / "gen"), "--weights", paths["inception"], "--device", "cpu",
           "--batch", "4", "--nn", "2", "--nn-samples", "3", "--nn-out",
           str(tmp_path / "nn.png")]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, env=THREADS_ENV,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n_real"] == 10 and res["n_gen"] == 8 and res["k"] == 3
    embed = make_inception_embedder(paths["inception"], device="cpu", batch_size=4)
    from mcvd_tpu_torch.tools.fid_pr import load_images

    want = get_fid_pr(embed(real), embed(load_images(str(tmp_path / "gen"))), k=3)
    assert res["fid"] == round(float(want["fid"]), 4) and np.isfinite(res["fid"])
    assert res["precision"] == round(want["precision"], 4)
    assert res["recall"] == round(want["recall"], 4)
    grid = codecs.decode_image((tmp_path / "nn.png").read_bytes())
    assert grid.shape == (3 * 24, 3 * 24, 3)
    out = subprocess.run(cmd[:-6] + ["--no-pr"], cwd=REPO, capture_output=True, text=True,
                         env=THREADS_ENV, timeout=300)
    assert out.returncode == 0 and "precision" not in json.loads(out.stdout.splitlines()[-1])


# ------------------------------------------------------------------ plots

def test_video_grid_gif_frames_within_the_palette_step(tmp_path):
    """The GIF's frames are real over pred, videos side by side, each frame
    250 ms, looping; its colours within half the palette's step."""
    from mcvd_tpu_torch.runners import plots

    rng = np.random.RandomState(2)
    pred, real = (rng.rand(3, 5, 8, 8, 3).astype(np.float32) for _ in range(2))
    plots.save_video_grid(str(tmp_path / "g"), pred=pred, real=real)
    gif = Image.open(tmp_path / "g.gif")
    assert gif.n_frames == 5 and gif.info["duration"] == 250 and gif.info["loop"] == 0
    to8 = plots._to_uint8
    for t in range(5):
        gif.seek(t)
        want = np.concatenate([np.concatenate([to8(real[b, t]), to8(pred[b, t])], 0)
                               for b in range(3)], 1)
        err = np.abs(np.asarray(gif.convert("RGB")).astype(float) - want).max(axis=(0, 1))
        assert (err <= np.asarray(codecs.GIF_STEP) / 2 + 0.5).all(), err
    png = codecs.decode_image((tmp_path / "g.png").read_bytes())
    np.testing.assert_array_equal(png, plots.video_grid(pred=pred, real=real))
