"""The port's LZF codec and its numpy HDF5 reader and writer
(`mcvd_tpu_torch/data/{lzf,h5,native}.py`) against h5py and the JAX
package's `HDF5Maker`, `KTHMaker`, `UCFMaker` and `HDF5Dataset`."""

import os
import struct
import sys
import threading

import h5py
import numpy as np
import pytest

from mcvd_tpu.data import h5 as jax_h5
from mcvd_tpu.data.converters import KTHMaker as JaxKTHMaker
from mcvd_tpu.data.converters import UCFMaker as JaxUCFMaker
from mcvd_tpu_torch.data import h5, lzf, native
from tests.test_torch_port_runner import TORCH_THREADS, torch_threads  # noqa: F401


def smooth_frames(rng, n, shape, noisy=(3,)):
    """`n` uint8 frames of smooth waves (LZF shrinks them) with the frames
    in `noisy` uniform noise (LZF does not: stored raw, filter mask 1)."""
    y, x = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    ph = rng.uniform(0, 6, 3)
    out = []
    for t in range(n):
        f = (np.sin(x / 7.0 + ph[0] + 0.3 * t) + np.cos(y / 5.0 + ph[1])) * 60 + 128
        f = f.astype(np.uint8)
        if len(shape) == 3:
            f = np.stack([np.roll(f, c, axis=1) for c in range(shape[2])], -1)
        if t in noisy:
            f = rng.integers(0, 256, shape, dtype=np.uint8)
        out.append(f)
    return out


# ------------------------------------------------------------------ LZF

def lzf_cases():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:64, 0:85]
    wave = ((np.sin(x / 7.0) + np.cos(y / 5.0)) * 60 + 128).astype(np.uint8)
    return {"empty": b"", "short": b"ab", "run": b"\0" * 5000, "period3": b"abc" * 400,
            "noise": rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
            "steps": np.repeat(rng.integers(0, 256, 700, dtype=np.uint8), 5).tobytes(),
            "wave_rgb": np.stack([wave] * 3, -1).tobytes(),
            "far_refs": (rng.integers(0, 256, 6000, dtype=np.uint8).tobytes() * 3)}


@pytest.mark.parametrize("name", sorted(lzf_cases()))
def test_lzf_native_and_plain_agree_both_ways(name):
    """The native encoder and the plain one give the same bytes (or both
    None where the encoding would not shrink), and each decoder decodes
    both to the input."""
    data = lzf_cases()[name]
    enc, enc_plain = lzf.compress(data), lzf.compress_plain(data)
    assert enc == enc_plain
    if name in ("empty", "short", "noise"):
        assert enc is None
        return
    assert len(enc) < len(data)
    for dec in (lzf.decompress, lzf.decompress_plain):
        out = dec(enc, len(data))
        assert out.dtype == np.uint8 and out.tobytes() == data
        assert out.flags.writeable


def test_lzf_decoders_read_h5pys_chunks(tmp_path):
    """The chunks h5py's LZF filter (liblzf) wrote, read raw with
    `read_direct_chunk`, decode to the frame in both decoders."""
    rng = np.random.default_rng(1)
    frames = smooth_frames(rng, 4, (64, 64, 3), noisy=())
    with h5py.File(tmp_path / "f.h5", "w") as f:
        for i, fr in enumerate(frames):
            f.create_dataset(str(i), data=fr, compression="lzf", chunks=(64, 64, 3))
    with h5py.File(tmp_path / "f.h5", "r") as f:
        for i, fr in enumerate(frames):
            mask, raw = f[str(i)].id.read_direct_chunk((0, 0, 0))
            assert mask == 0 and len(raw) < fr.nbytes
            for dec in (lzf.decompress, lzf.decompress_plain):
                assert np.array_equal(dec(raw, fr.nbytes).reshape(fr.shape), fr)


@pytest.mark.parametrize("dec", [lzf.decompress, lzf.decompress_plain])
def test_lzf_decoders_refuse_broken_streams(dec):
    enc = lzf.compress(b"abc" * 400)
    with pytest.raises(ValueError, match="LZF"):
        dec(enc[:-1], 1200)               # the input ends inside a command
    with pytest.raises(ValueError, match="LZF"):
        dec(enc, 1199)                    # more bytes than asked for
    with pytest.raises(ValueError, match="LZF"):
        dec(bytes([0x20, 0x05]), 8)       # a reference before the start


def test_host_library_raises_without_gxx(monkeypatch):
    """No silent fallback: without g++ the host library names what it
    needs."""
    monkeypatch.setattr(native, "_LIB", [None])
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        lzf.compress(b"abc" * 10)


# ------------------------------------------------------------------ reader

def write_jax_videos(out, videos, num_per_shard, maker=jax_h5.HDF5Maker):
    m = maker(str(out), num_per_shard=num_per_shard, force=True, video=True)
    for v in videos:
        m.add_data(v, dtype="uint8")
    m.close()
    return m.shard_paths


def group_depth(path, group="/"):
    """The level of a group's B-tree root in the file."""
    s = h5._Shard(path)
    addr = s.root_addr
    for part in (p for p in group.split("/") if p):
        addr = s.obj(addr).links[part]
    msg = next(d for t, _, d in s._messages(addr) if t == h5.MSG_SYMBOL_TABLE)
    btree, _ = struct.unpack_from("<QQ", msg)
    return s.read(btree, 8)[5]


def assert_same_tree(path):
    """Every group's keys and every dataset's bytes, dtype and shape, read by
    the port and by h5py."""
    with h5py.File(path, "r") as fj, h5.open_shard(path) as fp:
        def walk(gj, gp, name):
            assert list(gj.keys()) == gp.keys(), name
            for k in gj.keys():
                if isinstance(gj[k], h5py.Group):
                    walk(gj[k], gp[k], f"{name}/{k}")
                else:
                    a, b = gj[k][()], gp[k][()]
                    assert type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == \
                        np.shape(b), f"{name}/{k}"
                    assert np.array_equal(a, b), f"{name}/{k}"
        walk(fj, fp, "")


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    """Shards the JAX `HDF5Maker` wrote: 170 videos in shards of 160 (the
    first shard's root and `len` groups two B-tree levels deep), 64x64x3
    frames in h5py's 2 chunks each, frame 3 noise (raw chunks)."""
    rng = np.random.default_rng(2)
    videos = [smooth_frames(rng, 5, (64, 64, 3)) for _ in range(170)]
    paths = write_jax_videos(tmp_path_factory.mktemp("jax") / "s", videos, 160)
    return videos, paths


def test_reader_reads_jax_shards_bit_equal_to_h5py(jax_shards):
    """170 videos over 2 shards: every frame equal to what was written and to
    h5py's read, compressible and raw chunks, multi-level group B-trees."""
    videos, paths = jax_shards
    assert len(paths) == 2 and group_depth(paths[0]) >= 1 and group_depth(paths[0], "len") >= 1
    ds = h5.HDF5Dataset(os.path.dirname(paths[0]))
    assert ds.shard_lengths == jax_h5.HDF5Dataset(os.path.dirname(paths[0])).shard_lengths \
        == [160, 10]
    masks = set()
    for i, v in enumerate(videos):
        s, k = ds.get_indices(i)
        with h5.open_shard(ds.shard_paths[s]) as f:
            n = f["len"][k][()]
            assert isinstance(n, np.int64) and n == len(v)
            for t, fr in enumerate(v):
                d = f[k][str(t)]
                assert d.chunks == (32, 64, 3) and d.filters == [h5.FILTER_LZF]
                masks |= {m for _, m, _ in d.raw_chunks()}
                got = d[()]
                assert got.dtype == np.uint8 and np.array_equal(got, fr)
    assert masks == {0, 1}
    assert_same_tree(paths[1])


def test_reader_reads_the_converters_layouts(tmp_path):
    """KTHMaker's `person` / `target` (uint8) groups and UCFMaker's int64
    targets and root scalars `num_train` / `num_test`, with UCF's 64x85
    frames, the way h5py reads them."""
    rng = np.random.default_rng(3)
    kth = JaxKTHMaker(str(tmp_path / "kth"), force=True, video=True)
    for i in range(6):
        kth.add_data((smooth_frames(rng, 4, (64, 64)), i + 1, i % 6), dtype="uint8")
    kth.close()
    ucf = JaxUCFMaker(str(tmp_path / "ucf"), force=True, video=True)
    for i in range(5):
        ucf.add_data((smooth_frames(rng, 4, (64, 85, 3)), 100 + i), dtype="uint8")
    ucf.writer.create_dataset("num_train", data=3)
    ucf.writer.create_dataset("num_test", data=2)
    ucf.close()
    for p in kth.shard_paths + ucf.shard_paths:
        assert_same_tree(p)
    with h5.open_shard(kth.shard_paths[0]) as f:
        assert f["target"]["5"].dtype == np.uint8 and int(f["person"]["5"][()]) == 6
    with h5.open_shard(ucf.shard_paths[0]) as f:
        assert int(f["num_train"][()]) == 3 and f["target"]["4"][()] == 104


def test_reader_cuts_edge_chunks_and_reads_deflate(tmp_path):
    """Chunks that do not divide the frame (cut at its edges), deflate, an
    unwritten chunk (the fill value), compact and contiguous layouts, int
    and float types."""
    rng = np.random.default_rng(4)
    fr = smooth_frames(rng, 1, (64, 85, 3), noisy=())[0]
    noise = rng.integers(0, 256, (64, 85, 3), dtype=np.uint8)
    with h5py.File(tmp_path / "e.h5", "w", libver="earliest") as f:
        f.create_dataset("edge_lzf", data=fr, chunks=(24, 40, 3), compression="lzf")
        f.create_dataset("edge_raw", data=noise, chunks=(24, 40, 2), compression="lzf")
        f.create_dataset("deflate", data=fr, chunks=(30, 50, 3), compression="gzip",
                         compression_opts=4)
        part = f.create_dataset("partial", shape=(50, 7), dtype="<i4", chunks=(20, 7),
                                fillvalue=-3)
        part[:20] = np.arange(140).reshape(20, 7)
        f.create_dataset("compact", data=np.arange(6, dtype="<f8"),
                         dcpl=_compact_dcpl())
        f.create_dataset("f32", data=rng.standard_normal((5, 3)).astype("<f4"))
        f.create_dataset("u16", data=np.arange(9, dtype="<u2"))
        f.create_dataset("i8", data=np.int64(-7))
    assert_same_tree(str(tmp_path / "e.h5"))
    with h5.open_shard(str(tmp_path / "e.h5")) as f:
        assert len(f["edge_lzf"].raw_chunks()) == 9
        # noise does not shrink; its edge chunks, padded with zeros, do
        assert {m for _, m, _ in f["edge_raw"].raw_chunks()} == {0, 1}
        assert (f["partial"][()][20:] == -3).all()


def _compact_dcpl():
    from h5py import h5p, h5d

    dcpl = h5p.create(h5p.DATASET_CREATE)
    dcpl.set_layout(h5d.COMPACT)
    return dcpl


def test_reader_refuses_what_it_does_not_parse(tmp_path):
    """Superblock 2+, version-2 object headers (a group that tracks its
    order), other filters and other types
    raise `FormatError` naming what was found; a file that is not HDF5
    too."""
    cases = {}
    with h5py.File(tmp_path / "latest.h5", "w", libver="latest") as f:
        f.create_dataset("x", data=np.zeros(3))
    cases["latest.h5"] = ("x", "superblock version")
    with h5py.File(tmp_path / "ordered.h5", "w") as f:
        f.create_group("g", track_order=True).create_dataset("x", data=1)
    cases["ordered.h5"] = ("g", "version-2 object header")
    with h5py.File(tmp_path / "shuffle.h5", "w") as f:
        f.create_dataset("x", data=np.zeros((4, 4)), chunks=(2, 2), shuffle=True,
                         compression="lzf")
    cases["shuffle.h5"] = ("x", "filter 2")
    with h5py.File(tmp_path / "str.h5", "w") as f:
        f.create_dataset("x", data=np.array([b"ab", b"cd"]))
    cases["str.h5"] = ("x", "datatype class 3")
    with h5py.File(tmp_path / "big.h5", "w") as f:
        f.create_dataset("x", data=np.arange(3, dtype=">i4"))
    cases["big.h5"] = ("x", "big-endian")
    (tmp_path / "not.h5").write_bytes(b"\0" * 600)
    cases["not.h5"] = (None, "no HDF5 signature")
    for name, (key, why) in cases.items():
        with pytest.raises(h5.FormatError, match=why):
            with h5.open_shard(str(tmp_path / name)) as f:
                f[key][()]


def test_reader_parses_once_per_mtime_and_reads_from_threads(tmp_path, jax_shards):
    """Two opens of one shard share one parse; a rewritten shard is parsed
    again; 16 threads reading one shard get the frames written."""
    videos, _ = jax_shards
    paths = write_jax_videos(tmp_path / "a", videos[:40], 100)
    a, b = h5.open_shard(paths[0]), h5.open_shard(paths[0])
    assert a._shard is b._shard
    os.utime(paths[0], ns=(1, 1))
    assert h5.open_shard(paths[0])._shard is not a._shard
    errors = []

    def work(k):
        try:
            for i in range(k % 8, 40, 8):
                with h5.open_shard(paths[0]) as f:
                    for t in range(5):
                        if not np.array_equal(f[str(i)][str(t)][()], videos[i][t]):
                            errors.append((i, t))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # switch threads often: a race shows sooner
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and errors == []


def test_plain_decoder_reads_what_the_native_one_reads(jax_shards):
    _, paths = jax_shards
    with h5.open_shard(paths[1]) as fn, \
            h5.open_shard(paths[1], decompress=lzf.decompress_plain) as fp:
        for k in ("0", "9"):
            for t in range(5):
                assert np.array_equal(fn[k][str(t)][()], fp[k][str(t)][()])


# ------------------------------------------------------------------ writer

def test_writer_shards_read_bit_equal_by_h5py_and_jax(tmp_path):
    """The port's `HDF5Maker`: 300 videos in shards of 280 (group B-trees two
    levels deep), smooth and noise frames, 64x85x3; h5py reads every
    object as the port wrote it, and the JAX `HDF5Dataset` (h5py) sees the
    same shards and lengths."""
    rng = np.random.default_rng(5)
    videos = [smooth_frames(rng, 2, (64, 85, 3), noisy=(1,)) if i % 50 == 0
              else [np.full((64, 85, 3), i % 256, np.uint8)] for i in range(300)]
    m = h5.HDF5Maker(str(tmp_path / "s"), num_per_shard=280, video=True)
    for v in videos:
        m.add_data(v, dtype="uint8")
    m.close()
    assert [os.path.basename(p) for p in m.shard_paths] == ["shard_0001.hdf5",
                                                            "shard_0002.hdf5"]
    assert group_depth(m.shard_paths[0]) == 1
    jd = jax_h5.HDF5Dataset(str(tmp_path / "s"))
    assert jd.shard_lengths == h5.HDF5Dataset(str(tmp_path / "s")).shard_lengths == [280, 20]
    for p in m.shard_paths:
        assert_same_tree(p)
    with h5py.File(m.shard_paths[0], "r") as f:
        for i in (0, 50, 100, 250):
            for t, fr in enumerate(videos[i]):
                assert np.array_equal(f[str(i)][str(t)][()], fr)
                assert f[str(i)][str(t)].compression == "lzf"   # h5py's view
        masks = [f["0"]["1"].id.get_chunk_info(0).filter_mask,
                 f["0"]["0"].id.get_chunk_info(0).filter_mask]
        assert masks == [1, 0]
        assert f["len"]["299" if "299" in f["len"] else "279"][()] >= 1


def test_writer_writes_the_converters_layouts_for_h5py(tmp_path):
    """`KTHMaker` and `UCFMaker` of the port, with UCF's root scalars, and a
    non-video `add_data` of float and int arrays: h5py reads them as
    written."""
    rng = np.random.default_rng(6)
    kth = h5.KTHMaker(str(tmp_path / "kth"), video=True)
    for i in range(3):
        kth.add_data((smooth_frames(rng, 3, (64, 64)), i + 21, i), dtype="uint8")
    kth.close()
    ucf = h5.UCFMaker(str(tmp_path / "ucf"), video=True)
    ucf.add_data((smooth_frames(rng, 3, (64, 85, 3)), 7), dtype="uint8")
    ucf.writer.create_dataset("num_train", data=1)
    ucf.writer.create_dataset("num_test", data=0)
    ucf.close()
    flat = h5.HDF5Maker(str(tmp_path / "flat.hdf5"))
    items = [rng.standard_normal((4, 5)).astype(np.float32), np.arange(7, dtype=np.int16)]
    for it in items:
        flat.add_data(it)
    flat.close()
    for p in (kth.shard_paths[0], ucf.shard_paths[0], str(tmp_path / "flat.hdf5")):
        assert_same_tree(p)
    with h5py.File(kth.shard_paths[0], "r") as f:
        assert f["target"]["2"].dtype == np.uint8 and f["person"]["2"][()] == 23
    with h5py.File(ucf.shard_paths[0], "r") as f:
        assert f["num_train"][()] == 1 and f["target"]["0"].dtype == np.int64
    with h5py.File(tmp_path / "flat.hdf5", "r") as f:
        for i, it in enumerate(items):
            assert np.array_equal(f[str(i)][()], it) and f[str(i)].dtype == it.dtype
    with pytest.raises(ValueError, match="already exists"):
        h5.HDF5Maker(str(tmp_path / "kth"), video=True)
