"""The sharded HDF5 video store in numpy: a reader and a writer of the subset
of HDF5 that the store uses (counterpart of `mcvd_tpu/data/h5.py`, which
sits on h5py; upstream datasets/h5.py).

A shard (`shard_%04d.hdf5`) holds a `len` group (each video's frame count,
an int64 scalar), one group per video with one dataset per frame
(LZF-compressed uint8), and the converters' extras: `target` and `person`
groups of scalars, root scalars `num_train` / `num_test`. The JAX package's
shards are read as they are.

What the reader parses: superblock versions 0 and 1; version-1 object headers
with continuation messages; the dataspace, datatype (little-endian
fixed-point and IEEE float), fill value, data layout (version 3: compact,
contiguous, chunked) and filter pipeline messages; symbol-table groups
through v1 group B-trees of any depth (symbol nodes, local heaps); chunked
datasets through v1 chunk B-trees, each chunk's filter mask honoured (a chunk
whose filter failed is stored raw) and edge chunks cut to the dataset's
shape; the LZF (32000) and deflate (1) filters. Anything else raises a
`FormatError` that names what it found. A shard's parse is cached per
(path, mtime, size) and shared by every `HDF5File` of it; reads are
thread-safe (an `mmap` read with slices).

The writer (`HDF5Maker`, with `KTHMaker` and `UCFMaker` for the converters'
layouts) writes superblock-0 files that h5py reads: one chunk a frame,
LZF-compressed by `lzf.compress`, or raw with filter mask 1 where LZF does
not shrink it, as h5py's filter stores it.
"""

from __future__ import annotations

import collections
import glob
import mmap
import os
import struct
import threading
import zlib
from typing import List, Optional

import numpy as np

from . import lzf

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
FILTER_DEFLATE, FILTER_LZF = 1, 32000
# message types
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_LAYOUT, MSG_GROUP_INFO = 0x4, 0x5, 0x6, 0x8, 0xA
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11
_SKIPPED = {MSG_NIL, MSG_FILL_OLD, 0x0C, 0x0D, 0x0E, 0x12, 0x15, 0x16}  # attributes, times
_SHARD_CACHE_SIZE = 64


class FormatError(ValueError):
    """The file is not HDF5, or uses a part of it this reader does not parse."""


# ------------------------------------------------------------------ reader

class _Shard:
    """One file's bytes (mmap) and the objects parsed from them, by address."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self.objects = {}   # object header address -> _GroupInfo | _DatasetInfo
        self._superblock()

    def read(self, addr: int, n: int) -> bytes:
        addr += self.base
        if addr + n > len(self.buf):
            raise FormatError(f"{self.path}: read of {n} bytes at {addr} passes the end "
                              f"({len(self.buf)} bytes)")
        return self.buf[addr:addr + n]

    def _superblock(self):
        for at in (0, 512, 1024, 2048, 4096):
            if self.buf[at:at + 8] == SIGNATURE:
                break
        else:
            raise FormatError(f"{self.path}: no HDF5 signature")
        version = self.buf[at + 8]
        if version not in (0, 1):
            raise FormatError(f"{self.path}: superblock version {version} (0 and 1 are read)")
        size_off, size_len = self.buf[at + 13], self.buf[at + 14]
        if (size_off, size_len) != (8, 8):
            raise FormatError(f"{self.path}: offsets of {size_off} and lengths of {size_len} "
                              "bytes (8 and 8 are read)")
        p = at + 24 + (4 if version == 1 else 0)
        self.base, = struct.unpack_from("<Q", self.buf, p)
        # the root group's symbol table entry follows the four addresses
        self.root_addr, = struct.unpack_from("<Q", self.buf, p + 40)

    def obj(self, addr: int):
        o = self.objects.get(addr)
        if o is None:   # a race parses twice and keeps one: both are the same
            o = self.objects.setdefault(addr, self._parse_object(addr))
        return o

    def _messages(self, addr: int):
        """(type, flags, data) of a version-1 object header and its
        continuations."""
        head = self.read(addr, 16)
        if head[:4] == b"OHDR":
            raise FormatError(f"{self.path}: a version-2 object header (OHDR) at {addr}; "
                              "version 1 is read")
        version, _, n_msgs, _, size = struct.unpack_from("<BBHII", head)
        if version != 1:
            raise FormatError(f"{self.path}: object header version {version} at {addr} "
                              "(version 1 is read)")
        blocks = collections.deque([(addr + 16, size)])
        out = []
        while blocks:
            start, size = blocks.popleft()
            raw = self.read(start, size)
            p = 0
            while p + 8 <= size:
                mtype, msize, flags = struct.unpack_from("<HHB", raw, p)
                data = raw[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                    continue
                if flags & 2:
                    raise FormatError(f"{self.path}: shared message of type {mtype:#x} at "
                                      f"{addr}")
                out.append((mtype, flags, data))
        if len(out) > n_msgs:
            raise FormatError(f"{self.path}: object header at {addr} holds {len(out)} "
                              f"messages, its prefix says {n_msgs}")
        return out

    def _parse_object(self, addr: int):
        msgs = {}
        for mtype, _, data in self._messages(addr):
            if mtype not in _SKIPPED:
                msgs.setdefault(mtype, data)
        if MSG_SYMBOL_TABLE in msgs:
            return _GroupInfo(self, *struct.unpack_from("<QQ", msgs[MSG_SYMBOL_TABLE]))
        if MSG_LINK in msgs or MSG_LINK_INFO in msgs or MSG_GROUP_INFO in msgs:
            raise FormatError(f"{self.path}: a link-message (new-style) group at {addr}; "
                              "symbol-table groups are read")
        if MSG_DATASPACE in msgs and MSG_DATATYPE in msgs and MSG_LAYOUT in msgs:
            return _DatasetInfo(self, f"{self.path}: dataset at {addr}", msgs)
        raise FormatError(f"{self.path}: object at {addr} is neither a symbol-table group "
                          f"nor a dataset (messages {sorted(hex(m) for m in msgs)})")

    def btree(self, addr: int, node_type: int, key_size: int):
        """(key, child address) of every leaf entry of a v1 B-tree, in order."""
        head = self.read(addr, 24)
        if head[:4] != b"TREE":
            raise FormatError(f"{self.path}: no B-tree node at {addr}")
        ntype, level, used = head[4], head[5], struct.unpack_from("<H", head, 6)[0]
        if ntype != node_type:
            raise FormatError(f"{self.path}: B-tree node of type {ntype} at {addr}, "
                              f"want {node_type}")
        step = key_size + 8
        raw = self.read(addr + 24, used * step + key_size)
        for i in range(used):
            child, = struct.unpack_from("<Q", raw, i * step + key_size)
            if level == 0:
                yield raw[i * step:i * step + key_size], child
            else:
                yield from self.btree(child, node_type, key_size)

    def heap(self, addr: int) -> bytes:
        head = self.read(addr, 32)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise FormatError(f"{self.path}: no version-0 local heap at {addr}")
        size, _, data = struct.unpack_from("<QQQ", head, 8)
        return self.read(data, size)


class _GroupInfo:
    """A symbol-table group's links, name -> object header address, in the
    file's (strcmp) order."""

    def __init__(self, shard: _Shard, btree: int, heap_addr: int):
        heap = shard.heap(heap_addr)
        self.links = {}
        for _, snod in shard.btree(btree, 0, 8):
            head = shard.read(snod, 8)
            if head[:4] != b"SNOD":
                raise FormatError(f"{shard.path}: no symbol node at {snod}")
            n, = struct.unpack_from("<H", head, 6)
            raw = shard.read(snod + 8, 40 * n)
            for i in range(n):
                name_off, obj = struct.unpack_from("<QQ", raw, 40 * i)
                self.links[heap[name_off:heap.index(b"\0", name_off)].decode()] = obj


def _dtype(data: bytes, where: str) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    size, = struct.unpack_from("<I", data, 4)
    if cls in (0, 1) and data[1] & 1:
        raise FormatError(f"{where}: big-endian datatype")
    if cls == 0:   # fixed-point
        return np.dtype(f"<{'i' if data[1] & 8 else 'u'}{size}")
    if cls == 1 and size in (2, 4, 8):   # IEEE float
        return np.dtype(f"<f{size}")
    raise FormatError(f"{where}: datatype class {cls} (version {version}, {size} bytes); "
                      "fixed-point and IEEE float are read")


def _dataspace(data: bytes, where: str):
    version, rank = data[0], data[1]
    if version == 1:
        p = 8
    elif version == 2:
        if data[3] == 2:
            raise FormatError(f"{where}: null dataspace")
        p = 4
    else:
        raise FormatError(f"{where}: dataspace version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", data, p))


def _filters(data: bytes, where: str):
    """The filter ids of a filter pipeline message, in the writer's order."""
    version, n = data[0], data[1]
    if version not in (1, 2):
        raise FormatError(f"{where}: filter pipeline version {version}")
    out = []
    p = 8 if version == 1 else 2
    for _ in range(n):
        fid, = struct.unpack_from("<H", data, p)
        if version == 1 or fid >= 256:
            name_len, _, n_cd = struct.unpack_from("<HHH", data, p + 2)
            p += 8 + name_len
        else:
            name_len, (_, n_cd) = 0, struct.unpack_from("<HH", data, p + 2)
            p += 6
        p += 4 * n_cd + (4 if version == 1 and n_cd % 2 else 0)
        if fid not in (FILTER_LZF, FILTER_DEFLATE):
            raise FormatError(f"{where}: filter {fid}; LZF ({FILTER_LZF}) and deflate "
                              f"({FILTER_DEFLATE}) are read")
        out.append(fid)
    return out


def _fill(data: Optional[bytes], dt: np.dtype, where: str):
    """The fill value where the dataset defines one, else 0."""
    if data is None:
        return 0
    version = data[0]
    if version in (1, 2):
        if not data[3] or len(data) < 8:
            return 0
        size, = struct.unpack_from("<I", data, 4)
        p = 8
    elif version == 3:
        if not data[1] & 0x20:
            return 0
        size, = struct.unpack_from("<I", data, 2)
        p = 6
    else:
        raise FormatError(f"{where}: fill value message version {version}")
    return np.frombuffer(data[p:p + size], dt)[0] if size == dt.itemsize else 0


class _DatasetInfo:
    """A dataset's shape, type, layout and (chunked) chunk index."""

    def __init__(self, shard: _Shard, where: str, msgs: dict):
        self.shard, self.where = shard, where
        self.shape = _dataspace(msgs[MSG_DATASPACE], where)
        self.dtype = _dtype(msgs[MSG_DATATYPE], where)
        self.filters = _filters(msgs[MSG_FILTERS], where) if MSG_FILTERS in msgs else []
        self.fill = _fill(msgs.get(MSG_FILL), self.dtype, where)
        lay = msgs[MSG_LAYOUT]
        if lay[0] != 3:
            raise FormatError(f"{where}: data layout version {lay[0]} (version 3 is read)")
        self.layout, self.chunks, self.index = lay[1], None, None
        if self.layout == 0:     # compact
            n, = struct.unpack_from("<H", lay, 2)
            self.compact = lay[4:4 + n]
        elif self.layout == 1:   # contiguous
            self.data_addr, _ = struct.unpack_from("<QQ", lay, 2)
        elif self.layout == 2:   # chunked: rank + 1 dims, the last the element size
            ndims = lay[2]
            btree, = struct.unpack_from("<Q", lay, 3)
            self.chunks = tuple(struct.unpack_from(f"<{ndims}I", lay, 11)[:-1])
            ksize = 8 + 8 * ndims
            self.index = []   # (offsets, stored bytes, filter mask, address)
            for key, child in shard.btree(btree, 1, ksize):
                nbytes, mask = struct.unpack_from("<II", key)
                self.index.append((struct.unpack_from(f"<{ndims - 1}Q", key, 8), nbytes, mask,
                                   child))
        else:
            raise FormatError(f"{where}: data layout class {self.layout}")


class Dataset:
    """A dataset: `shape`, `dtype`, `chunks`, `filters` (HDF5 filter ids);
    `d[()]` reads it whole (a numpy scalar where the dataspace is a
    scalar)."""

    def __init__(self, info: _DatasetInfo, decompress):
        self._info, self._decompress = info, decompress
        self.shape, self.dtype, self.chunks = info.shape, info.dtype, info.chunks
        self.filters = info.filters

    def _chunk(self, nbytes: int, mask: int, addr: int, out_nbytes: int) -> np.ndarray:
        """One chunk's bytes through the pipeline, last filter first; a filter
        whose bit is set in `mask` was skipped when the chunk was written."""
        info = self._info
        data = info.shard.read(addr, nbytes)
        for i in reversed(range(len(info.filters))):
            if not mask & (1 << i):
                data = (self._decompress(data, out_nbytes) if info.filters[i] == FILTER_LZF
                        else zlib.decompress(data))
        arr = np.frombuffer(data, np.uint8)
        if arr.size != out_nbytes:
            raise FormatError(f"{info.where}: chunk of {arr.size} bytes, want {out_nbytes}")
        return arr

    def read(self) -> np.ndarray:
        """The whole dataset, a writable array."""
        info, dt = self._info, self.dtype
        n_elem = int(np.prod(self.shape, dtype=np.int64))
        if info.layout == 0:
            return np.frombuffer(info.compact, dt, count=n_elem).reshape(self.shape).copy()
        if info.layout == 1:
            if info.data_addr == UNDEF:
                return np.full(self.shape, info.fill, dt)
            raw = info.shard.read(info.data_addr, n_elem * dt.itemsize)
            return np.frombuffer(raw, dt).reshape(self.shape).copy()
        chunk_nbytes = int(np.prod(self.chunks)) * dt.itemsize
        if len(info.index) == 1 and self.chunks == self.shape:
            # one chunk the size of the dataset: no copy into place
            out = self._chunk(*info.index[0][1:], chunk_nbytes).view(dt).reshape(self.shape)
            return out if out.flags.writeable else out.copy()
        out = np.full(self.shape, info.fill, dt)
        for offs, *where in info.index:
            chunk = self._chunk(*where, chunk_nbytes).view(dt).reshape(self.chunks)
            dst = tuple(slice(o, min(o + c, d)) for o, c, d in zip(offs, self.chunks, self.shape))
            out[dst] = chunk[tuple(slice(0, s.stop - s.start) for s in dst)]
        return out

    def raw_chunks(self):
        """[(offsets, filter mask, stored bytes)] of a chunked dataset."""
        return [(offs, mask, self._info.shard.read(addr, nbytes))
                for offs, nbytes, mask, addr in self._info.index]

    def __getitem__(self, key):
        arr = self.read()
        return arr[()] if key == () and arr.ndim == 0 else arr[key]


class Group:
    """A symbol-table group: `keys()` in the file's (strcmp) order, `g[name]`
    (or `g["a/b"]`) a Group or a Dataset."""

    def __init__(self, shard: _Shard, info: _GroupInfo, decompress):
        self._shard, self._info, self._decompress = shard, info, decompress

    def keys(self) -> List[str]:
        return list(self._info.links)

    def __getitem__(self, name: str):
        info = self._info
        for part in (p for p in name.split("/") if p):
            if not isinstance(info, _GroupInfo) or part not in info.links:
                raise KeyError(f"{name!r} not in {self._shard.path}")
            info = self._shard.obj(info.links[part])
        if isinstance(info, _GroupInfo):
            return Group(self._shard, info, self._decompress)
        return Dataset(info, self._decompress)


_SHARDS: "collections.OrderedDict[tuple, _Shard]" = collections.OrderedDict()
_SHARDS_LOCK = threading.Lock()


def _shard(path: str) -> _Shard:
    st = os.stat(path)
    key = (os.path.realpath(path), st.st_mtime_ns, st.st_size)
    with _SHARDS_LOCK:
        s = _SHARDS.get(key)
        if s is not None:
            _SHARDS.move_to_end(key)
            return s
    s = _Shard(path)   # outside the lock: parsing one shard blocks no other
    with _SHARDS_LOCK:
        s = _SHARDS.setdefault(key, s)
        while len(_SHARDS) > _SHARD_CACHE_SIZE:
            _SHARDS.popitem(last=False)   # a reader still holding it keeps its mmap
    return s


class HDF5File(Group):
    """A shard opened for reading, indexed as h5py's File (`f["len"]["3"][()]`,
    `f["3"]["0"][()]`) and a context manager. Its structure is parsed once
    per (path, mtime, size) and shared. `decompress` replaces the native LZF
    decoder (the tests' plain one)."""

    def __init__(self, path: str, decompress=None):
        s = _shard(path)
        super().__init__(s, s.obj(s.root_addr), decompress or lzf.decompress)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass   # the shard's mmap is shared and closes with its last reference


def open_shard(path: str, decompress=None) -> HDF5File:
    return HDF5File(path, decompress)


class HDF5Dataset:
    """Flat reader: __getitem__(i) returns the i-th top-level dataset
    (non-video mode); the video datasets use the group API through `opener`."""

    def __init__(self, data_path: str, shuffle_shards: bool = False, opener=open_shard,
                 seed: int = 29):
        self.data_path = data_path
        self.opener = opener
        if os.path.splitext(data_path)[-1] in (".hdf5", ".h5"):
            self.data_dir = os.path.dirname(data_path)
            self.shard_paths = [data_path]
        else:
            self.data_dir = data_path
            self.shard_paths = sorted(
                glob.glob(os.path.join(data_path, "*.hdf5"))
                + glob.glob(os.path.join(data_path, "*.h5")))
        if not self.shard_paths:
            raise FileNotFoundError(f"h5: no .hdf5 files in {self.data_dir}")

        self.shard_lengths = []
        for p in self.shard_paths:
            try:
                with opener(p) as f:
                    self.shard_lengths.append(len(f["len"].keys()))
            except Exception:
                self.shard_lengths.append(-1)
        self.num_per_shard = self.shard_lengths[0]
        self.total_num = sum(self.shard_lengths)
        self.num_of_shards = len(self.shard_paths)
        if shuffle_shards:
            rng = np.random.RandomState(seed)
            rng.shuffle(self.shard_paths)

    def __len__(self):
        return self.total_num

    def get_indices(self, idx):
        shard_idx = int(np.digitize(idx, np.cumsum(self.shard_lengths)))
        idx_in_shard = str(idx - sum(self.shard_lengths[:shard_idx]))
        return shard_idx, idx_in_shard

    def __getitem__(self, index):
        idx = index % self.total_num
        shard_idx, idx_in_shard = self.get_indices(idx)
        with self.opener(self.shard_paths[shard_idx]) as f:
            return f[idx_in_shard][()]


# ------------------------------------------------------------------ writer

_LEAF_K, _NODE_K = 4, 16     # h5py's (the library's) group B-tree K values
_ISTORE_K = 32               # the chunk B-tree's K (superblock 0 does not store it)
_LZF_VERSION = (4, 0x0105)   # h5py's filter client data: its filter and liblzf versions


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _dtype_message(dt: np.dtype) -> bytes:
    if dt.byteorder == ">" or dt.kind not in "uif":
        raise TypeError(f"h5: dtype {dt} is not written (little-endian ints and floats are)")
    if dt.kind in "ui":
        head = bytes([0x10, 0x08 if dt.kind == "i" else 0, 0, 0])
        return head + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize)
    exp, man = {2: (5, 10), 4: (8, 23), 8: (11, 52)}[dt.itemsize]
    bits = 8 * dt.itemsize
    head = bytes([0x11, 0x20, bits - 1, 0])
    return head + struct.pack("<IHHBBBBI", dt.itemsize, 0, bits, man, exp, 0, man,
                              (1 << (exp - 1)) - 1)


def _dataspace_message(shape) -> bytes:
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + struct.pack(f"<{len(shape)}Q", *shape)


def _header(messages) -> bytes:
    """A version-1 object header: [(type, flags, data)]."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), f) + _pad8(d)
                    for t, f, d in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _WGroup:
    """A group being written: h5py's `create_group` / `create_dataset` /
    `g[name]` on the writer's side."""

    def __init__(self, file: "_ShardWriter"):
        self._file, self.children = file, {}

    def create_group(self, name: str) -> "_WGroup":
        parent, leaf = self._parent(name)
        if leaf in parent.children:
            raise ValueError(f"h5: {name!r} already exists")
        parent.children[leaf] = _WGroup(self._file)
        return parent.children[leaf]

    def create_dataset(self, name: str, data=None, dtype=None, compression=None):
        parent, leaf = self._parent(name)
        if leaf in parent.children:
            raise ValueError(f"h5: {name!r} already exists")
        arr = np.asarray(data, dtype=dtype)
        parent.children[leaf] = self._file.write_dataset(arr, compression)

    def _parent(self, name: str):
        parts = [p for p in name.split("/") if p]
        node = self
        for p in parts[:-1]:
            node = node.children[p]
        return node, parts[-1]

    def __getitem__(self, name: str):
        node = self
        for p in (p for p in name.split("/") if p):
            node = node.children[p]
        return node

    def keys(self):
        return sorted(self.children, key=str.encode)


class _ShardWriter(_WGroup):
    """One shard being written: the data and each dataset's metadata go to
    the file as they come, the groups' symbol tables at `close()`, the
    superblock last."""

    def __init__(self, path: str):
        super().__init__(self)
        self.path = path
        self._f = open(path, "wb")
        self._f.write(b"\0" * 96)   # the superblock, written at close
        self._pos = 96

    def _append(self, data: bytes) -> int:
        addr = self._pos
        self._f.write(data)
        self._pos += len(data)
        return addr

    def write_dataset(self, arr: np.ndarray, compression) -> int:
        """Writes the data and the object header; returns the header's
        address."""
        dt = arr.dtype
        dt_msg = _dtype_message(dt)
        msgs = [(MSG_DATASPACE, 0, _dataspace_message(arr.shape)), (MSG_DATATYPE, 1, dt_msg)]
        raw = np.ascontiguousarray(arr).tobytes()
        if compression is None:
            # fill value 2: space allocated late, written if set, the default
            msgs.append((MSG_FILL, 1, bytes([2, 2, 2, 1, 0, 0, 0, 0])))
            addr = self._append(raw) if raw else UNDEF
            msgs.append((MSG_LAYOUT, 0, struct.pack("<BBQQ", 3, 1, addr, len(raw))))
        elif compression == "lzf":
            if arr.ndim == 0:
                raise TypeError("h5: a scalar dataset cannot be chunked")
            # one chunk, the whole array: LZF, or raw with the filter's bit set
            enc = lzf.compress(raw)
            stored, mask = (enc, 0) if enc is not None else (raw, 1)
            chunk_addr = self._append(stored)
            rank = arr.ndim
            # keys: (stored bytes, filter mask, offsets and the element size's);
            # the right key is the chunk's far corner, as the library writes it
            keys = struct.pack(f"<II{rank + 1}Q", len(stored), mask, *[0] * (rank + 1)), \
                struct.pack(f"<II{rank + 1}Q", 0, 0, *arr.shape, dt.itemsize)
            node = (b"TREE" + struct.pack("<BBHQQ", 1, 0, 1, UNDEF, UNDEF) + keys[0]
                    + struct.pack("<Q", chunk_addr) + keys[1])
            size = 24 + (2 * _ISTORE_K + 1) * (8 + 8 * (rank + 1)) + 2 * _ISTORE_K * 8
            btree = self._append(node + b"\0" * (size - len(node)))
            msgs.append((MSG_FILL, 1, bytes([2, 3, 2, 1, 0, 0, 0, 0])))   # incrementally
            msgs.append((MSG_LAYOUT, 0, struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1, btree,
                                                    *arr.shape, dt.itemsize)))
            name = _pad8(b"lzf\0")
            cd = (*_LZF_VERSION, len(raw))
            filt = struct.pack("<HHHH", FILTER_LZF, len(name), 1, len(cd)) + name \
                + struct.pack(f"<{len(cd)}I", *cd) + b"\0" * (4 * (len(cd) % 2))
            msgs.append((MSG_FILTERS, 1, struct.pack("<BB6x", 1, 1) + filt))
        else:
            raise ValueError(f"h5: compression {compression!r} is not written ('lzf' is)")
        return self._append(_header(msgs))

    def _write_group(self, group: _WGroup) -> int:
        """The group's children first, then its local heap, symbol nodes,
        B-tree and object header; returns the header's address."""
        entries = []
        for name in group.keys():
            child = group.children[name]
            addr = self._write_group(child)[0] if isinstance(child, _WGroup) else child
            entries.append((name.encode(), addr))
        btree, heap = self._symbol_table(entries)
        return self._append(_header([(MSG_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap))])), \
            btree, heap

    def _symbol_table(self, entries):
        """(B-tree address, heap address) of a group's sorted entries."""
        names = bytearray(b"\0" * 8)   # offset 0: the empty name
        offs = []
        for name, _ in entries:
            offs.append(len(names))
            names += _pad8(name + b"\0")
        # one free block at the end, as the library leaves it
        free = len(names)
        names += struct.pack("<QQ", 1, 16)
        data = self._append(bytes(names))
        heap = self._append(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(names), free, data))
        snod_size = 8 + 2 * _LEAF_K * 40
        level = []   # (child address, heap offset of its last name)
        for i in range(0, len(entries), 2 * _LEAF_K):
            part = range(i, min(i + 2 * _LEAF_K, len(entries)))
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + b"".join(
                struct.pack("<QQII16x", offs[j], entries[j][1], 0, 0) for j in part)
            level.append((self._append(node + b"\0" * (snod_size - len(node))),
                          offs[part[-1]]))
        node_size = 24 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8
        depth = 0
        while True:
            nodes = []
            for i in range(0, max(len(level), 1), 2 * _NODE_K):
                part = level[i:i + 2 * _NODE_K]
                body = struct.pack("<Q", 0) + b"".join(struct.pack("<QQ", a, k) for a, k in part)
                node = b"TREE" + struct.pack("<BBHQQ", 0, depth, len(part), UNDEF, UNDEF) + body
                nodes.append((self._append(node + b"\0" * (node_size - len(node))),
                              part[-1][1] if part else 0))
            if len(nodes) == 1:
                return nodes[0][0], heap
            level, depth = nodes, depth + 1

    def close(self):
        root, btree, heap = self._write_group(self)
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack(
            "<HHI", _LEAF_K, _NODE_K, 0) + struct.pack(
            "<QQQQ", 0, UNDEF, self._pos, UNDEF) + struct.pack(
            "<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap)
        self._f.seek(0)
        self._f.write(sb)
        self._f.close()


class HDF5Maker:
    """Shard writer, the JAX package's API (upstream datasets/h5.py:97-208):
    `add_data` of a video (a list of frames, `video=True`) or of an array;
    a new shard every `num_per_shard` items."""

    def __init__(self, out_path, num_per_shard=100000, max_shards=None, name=None,
                 name_fmt="shard_{:04d}.hdf5", force=False, video=False):
        self.out_path = out_path
        self.num_per_shard = num_per_shard
        self.max_shards = max_shards
        self.name = name
        self.name_fmt = name_fmt
        self.force = force
        self.video = video

        if os.path.splitext(out_path)[-1] in (".hdf5", ".h5"):
            if os.path.isfile(out_path):
                if not self.force:
                    raise ValueError(f"{out_path} already exists.")
                os.remove(out_path)
            self.out_dir = os.path.dirname(out_path)
            os.makedirs(self.out_dir, exist_ok=True)
            self.name = os.path.basename(out_path)
        else:
            self.out_dir = out_path
            if os.path.isdir(self.out_dir):
                if not self.force:
                    raise ValueError(f"{self.out_dir} already exists.")
                for f in glob.glob(os.path.join(self.out_dir, "*.hdf5")) + glob.glob(
                        os.path.join(self.out_dir, "*.h5")):
                    os.remove(f)
            else:
                os.makedirs(self.out_dir)

        self.writer: Optional[_ShardWriter] = None
        self.shard_paths: List[str] = []
        self.shard_number = 0
        self.create_new_shard()

    def create_new_shard(self):
        if self.writer:
            self.writer.close()
        self.shard_number += 1
        if self.max_shards is not None and self.shard_number == self.max_shards + 1:
            return
        self.shard_p = os.path.join(
            self.out_dir,
            self.name_fmt.format(self.shard_number) if self.name is None else self.name)
        if os.path.exists(self.shard_p):
            raise FileExistsError(f"Record already exists! {self.shard_p}")
        self.shard_paths.append(self.shard_p)
        self.writer = _ShardWriter(self.shard_p)
        if self.video:
            self.create_video_groups()
        self.count = 0

    def create_video_groups(self):
        self.writer.create_group("len")
        self.writer.create_group("videos")

    def add_video_data(self, data, dtype=None):
        self.writer["len"].create_dataset(str(self.count), data=len(data))
        self.writer.create_group(str(self.count))
        for i, frame in enumerate(data):
            self.writer[str(self.count)].create_dataset(
                str(i), data=frame, dtype=dtype, compression="lzf")

    def add_data(self, data, dtype=None, return_curr_count=False):
        if self.video:
            self.add_video_data(data, dtype)
        else:
            self.writer.create_dataset(str(self.count), data=data, dtype=dtype,
                                       compression="lzf")
        curr_count = self.count
        self.count += 1
        if self.count == self.num_per_shard:
            self.create_new_shard()
        if return_curr_count:
            return curr_count

    def close(self):
        self.writer.close()
        if not self.shard_paths:
            raise RuntimeError("h5: no shard was written")


class KTHMaker(HDF5Maker):
    """Shards with len / person / target groups (the JAX converters' layout,
    upstream kth_convert.py): `add_data((frames, person, target))`."""

    def create_video_groups(self):
        self.writer.create_group("len")
        self.writer.create_group("person")
        self.writer.create_group("target")

    def add_video_data(self, data, dtype=None):
        frames, person, target = data
        self.writer["len"].create_dataset(str(self.count), data=len(frames))
        self.writer["person"].create_dataset(str(self.count), data=person, dtype="uint8")
        self.writer["target"].create_dataset(str(self.count), data=target, dtype="uint8")
        self.writer.create_group(str(self.count))
        for i, frame in enumerate(frames):
            self.writer[str(self.count)].create_dataset(
                str(i), data=frame, dtype=dtype, compression="lzf")


class UCFMaker(HDF5Maker):
    """Shards with len / target groups (upstream ucf101_convert.py); the
    caller adds the root scalars `num_train` and `num_test` through
    `writer.create_dataset` before `close()`."""

    def create_video_groups(self):
        self.writer.create_group("len")
        self.writer.create_group("target")

    def add_video_data(self, data, dtype=None):
        frames, target = data
        self.writer["len"].create_dataset(str(self.count), data=len(frames))
        self.writer["target"].create_dataset(str(self.count), data=target)
        self.writer.create_group(str(self.count))
        for i, frame in enumerate(frames):
            self.writer[str(self.count)].create_dataset(
                str(i), data=frame, dtype=dtype, compression="lzf")
