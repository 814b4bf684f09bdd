"""Pure-Python LMDB (Lightning Memory-Mapped Database) reader and bulk
writer (counterpart of `mcvd_tpu/data/lmdb_io.py`, the same format code).

LSUN's LMDB environments (upstream torchvision `datasets.LSUN`) are read
here without the `lmdb` C extension. The read side covers the main database
(inline and overflow values, branch pages, keys-only walks); the write side
is a single-transaction bulk loader, enough to build LSUN-layout
environments.

Format facts encoded here (from the LMDB file format, ``mdb.c``):

- The file is an array of ``psize``-byte pages (default 4096).  Pages 0 and
  1 are meta pages; the live one is the one with the larger ``mm_txnid``.
- Page header (16 bytes): u64 pgno | u16 pad | u16 flags | u16 lower |
  u16 upper (the last two overlay a u32 page-count for OVERFLOW pages).
  Flags: BRANCH=0x01 LEAF=0x02 OVERFLOW=0x04 META=0x08 LEAF2=0x20.
- Meta page payload: u32 magic=0xBEEFC0DE | u32 version=1 | u64 address |
  u64 mapsize | MDB_db[2] (free db, main db) | u64 last_pg | u64 txnid.
  ``MDB_db`` (48 bytes): u32 pad | u16 flags | u16 depth | u64 branch_pages
  | u64 leaf_pages | u64 overflow_pages | u64 entries | u64 root.  The
  free-db ``pad`` field stores the page size.
- Node: u16 lo | u16 hi | u16 flags | u16 ksize | key bytes | data.  The
  per-page node-offset array (u16 each) sits right after the page header.
  Leaf: datasize = lo | hi<<16; flag BIGDATA=0x01 means the "data" is a u64
  overflow pgno and the value lives in OVERFLOW pages (16-byte header on
  the first page, then contiguous bytes).  Branch: child pgno = lo |
  hi<<16 | flags<<32 and the first node's key is empty.
- Keys compare as length-aware memcmp — exactly python ``bytes`` ordering.

Sub-databases (named DBs) and DUPSORT are not used by any dataset we read
and are rejected explicitly.
"""

import os
import struct

PAGE_HEADER = 16
MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

P_INVALID = 0xFFFFFFFFFFFFFFFF

_DB = struct.Struct("<IHHQQQQQ")          # pad flags depth branch leaf ovf entries root
_NODE = struct.Struct("<HHHH")            # lo hi flags ksize
_META_HEAD = struct.Struct("<IIQQ")       # magic version address mapsize


def _data_file(path):
    """``path`` may be the environment directory or the data file itself."""
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class LMDBReader:
    """Read-only view of an LMDB environment's main database.

    Supports ``len()``, ``get(key)``, ``items()`` / ``keys()`` iteration in
    key order, and context-manager close.  Thread-safe for reads (operates
    on an immutable bytes snapshot via mmap).
    """

    def __init__(self, path):
        import mmap

        self.path = _data_file(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        m = self._mm

        # Pick the live meta page: the larger txnid of the two wins.
        metas = []
        for pgno in (0, 1):
            off = pgno * 4096 + PAGE_HEADER  # meta pages are at file offsets
            magic, version, _addr, _mapsize = _META_HEAD.unpack_from(m, off)
            if magic != MAGIC:
                raise IOError(f"{self.path}: not an LMDB file (bad magic on meta {pgno})")
            if version != VERSION:
                raise IOError(f"{self.path}: unsupported LMDB data version {version}")
            free_db = _DB.unpack_from(m, off + _META_HEAD.size)
            main_db = _DB.unpack_from(m, off + _META_HEAD.size + _DB.size)
            (last_pg, txnid) = struct.unpack_from("<QQ", m, off + _META_HEAD.size + 2 * _DB.size)
            metas.append((txnid, free_db, main_db, last_pg))
        meta = max(metas, key=lambda t: t[0])
        _txnid, free_db, main_db, _last_pg = meta

        self.psize = free_db[0] or 4096
        (_pad, md_flags, self.depth, _br, _lf, _ovf, self.entries, self.root) = main_db
        if md_flags & 0x04:  # MDB_DUPSORT on the main DB
            raise NotImplementedError("DUPSORT main databases are not supported")

    # -- page access ---------------------------------------------------

    def _page(self, pgno):
        off = pgno * self.psize
        (p_pgno,) = struct.unpack_from("<Q", self._mm, off)
        pad, flags, lower, upper = struct.unpack_from("<HHHH", self._mm, off + 8)
        return off, flags, lower, upper

    def _page_nodes(self, off, lower):
        n = (lower - PAGE_HEADER) // 2
        return [struct.unpack_from("<H", self._mm, off + PAGE_HEADER + 2 * i)[0]
                for i in range(n)]

    def _node(self, page_off, ptr):
        lo, hi, flags, ksize = _NODE.unpack_from(self._mm, page_off + ptr)
        key = bytes(self._mm[page_off + ptr + 8: page_off + ptr + 8 + ksize])
        return lo, hi, flags, ksize, key

    def _leaf_value(self, page_off, ptr):
        lo, hi, flags, ksize, _key = self._node(page_off, ptr)
        if flags & (F_SUBDATA | F_DUPDATA):
            raise NotImplementedError("sub-database / dupsort nodes not supported")
        dsize = lo | (hi << 16)
        dpos = page_off + ptr + 8 + ksize
        if flags & F_BIGDATA:
            (ovf_pgno,) = struct.unpack_from("<Q", self._mm, dpos)
            start = ovf_pgno * self.psize + PAGE_HEADER
            return bytes(self._mm[start: start + dsize])
        return bytes(self._mm[dpos: dpos + dsize])

    def _branch_child(self, page_off, ptr):
        lo, hi, flags, _ksize, key = self._node(page_off, ptr)
        return (lo | (hi << 16) | (flags << 32)), key

    # -- public API ----------------------------------------------------

    def __len__(self):
        return self.entries

    def _walk_leaves(self):
        """Yield (page_off, node_ptr) for every leaf node in key order."""
        if self.root == P_INVALID:
            return
        stack = [self.root]
        while stack:
            pgno = stack.pop()
            off, flags, lower, upper = self._page(pgno)
            ptrs = self._page_nodes(off, lower)
            if flags & P_BRANCH:
                children = [self._branch_child(off, p)[0] for p in ptrs]
                stack.extend(reversed(children))
            elif flags & P_LEAF:
                if flags & P_LEAF2:
                    raise NotImplementedError("LEAF2 (fixed-size dupsort) pages")
                for p in ptrs:
                    yield off, p
            else:
                raise IOError(f"unexpected page flags {flags:#x} at pgno {pgno}")

    def items(self):
        """Yield (key, value) in key order."""
        for off, p in self._walk_leaves():
            _lo, _hi, _fl, _ksize, key = self._node(off, p)
            yield key, self._leaf_value(off, p)

    def keys(self):
        """Yield keys in key order WITHOUT materializing values (cheap even
        when values are large image blobs on overflow pages)."""
        for off, p in self._walk_leaves():
            yield self._node(off, p)[4]

    def get(self, key, default=None):
        """Point lookup by binary search down the B+tree."""
        if self.root == P_INVALID:
            return default
        pgno = self.root
        while True:
            off, flags, lower, upper = self._page(pgno)
            ptrs = self._page_nodes(off, lower)
            if flags & P_BRANCH:
                # First branch key is empty; find last child whose key <= key.
                lo_i, hi_i = 1, len(ptrs)  # child 0 always qualifies
                while lo_i < hi_i:
                    mid = (lo_i + hi_i) // 2
                    _c, mkey = self._branch_child(off, ptrs[mid])
                    if mkey <= key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid
                pgno, _ = self._branch_child(off, ptrs[lo_i - 1])
            elif flags & P_LEAF:
                lo_i, hi_i = 0, len(ptrs)
                while lo_i < hi_i:
                    mid = (lo_i + hi_i) // 2
                    _l, _h, _f, ksz, mkey = self._node(off, ptrs[mid])
                    if mkey < key:
                        lo_i = mid + 1
                    elif mkey > key:
                        hi_i = mid
                    else:
                        return self._leaf_value(off, ptrs[mid])
                return default
            else:
                raise IOError(f"unexpected page flags {flags:#x} at pgno {pgno}")

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_lmdb(path, items, psize=4096, mapsize=None):
    """Single-transaction bulk load: write ``items`` (iterable of
    ``(key, value)`` bytes pairs) as a fresh LMDB environment at ``path``
    (a directory; ``data.mdb`` is created inside).  Keys are sorted and
    deduplicated (last write wins), values larger than half a page go to
    OVERFLOW pages, and branch levels are built bottom-up — the same shape
    ``mdb_load`` produces.
    """
    kv = {}
    for k, v in items:
        kv[bytes(k)] = bytes(v)
    pairs = sorted(kv.items())

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "data.mdb")

    pages = {}          # pgno -> bytes/bytearray of length psize
    next_pg = [2]       # pages 0,1 are the metas

    def alloc(n=1):
        pg = next_pg[0]
        next_pg[0] += n
        return pg

    # Matches LMDB's node-size cutoff: values that would push a node past
    # ~half a page are spilled to overflow pages.
    nodemax = (psize - PAGE_HEADER) // 2

    n_overflow = 0

    def write_overflow(data):
        nonlocal n_overflow
        npages = (PAGE_HEADER + len(data) + psize - 1) // psize
        first = alloc(npages)
        hdr = struct.pack("<QHHI", first, 0, P_OVERFLOW, npages)
        blob = hdr + data
        blob += bytes(npages * psize - len(blob))
        for i in range(npages):
            pages[first + i] = blob[i * psize:(i + 1) * psize]
        n_overflow += npages
        return first

    def materialize(pg, node_blobs, leaf):
        buf = bytearray(psize)
        struct.pack_into("<Q", buf, 0, pg)
        upper = psize
        ptrs = []
        for blob in node_blobs:
            upper -= len(blob)
            buf[upper:upper + len(blob)] = blob
            ptrs.append(upper)
        struct.pack_into("<HHHH", buf, 8, 0, P_LEAF if leaf else P_BRANCH,
                         PAGE_HEADER + 2 * len(ptrs), upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGE_HEADER + 2 * i, p)
        pages[pg] = buf

    def build_level(nodes, leaf):
        """``nodes``: list of (key, node_blob).  Packs nodes into pages in
        order and returns [(first_key, pgno)] for the level above."""
        # chunk by size: each node costs len(blob) + 2 (its offset slot)
        chunks, cur, used = [], [], PAGE_HEADER
        for key, blob in nodes:
            need = len(blob) + 2
            if cur and used + need > psize:
                chunks.append(cur)
                cur, used = [], PAGE_HEADER
            cur.append((key, blob))
            used += need
        chunks.append(cur)
        level = []
        for chunk in chunks:
            pg = alloc()
            materialize(pg, [b for _k, b in chunk], leaf)
            level.append((chunk[0][0], pg))
        return level

    def leaf_node(key, value):
        if 8 + len(key) + len(value) > nodemax:
            first = write_overflow(value)
            blob = _NODE.pack(len(value) & 0xFFFF, len(value) >> 16,
                              F_BIGDATA, len(key)) + key + struct.pack("<Q", first)
        else:
            blob = _NODE.pack(len(value) & 0xFFFF, len(value) >> 16,
                              0, len(key)) + key + value
        return blob + b"\x00" * (len(blob) & 1)  # even alignment

    def branch_node(key, child):
        blob = _NODE.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                          (child >> 32) & 0xFFFF, len(key)) + key
        return blob + b"\x00" * (len(blob) & 1)

    n_leaf = n_branch = 0
    depth = 0
    if pairs:
        level = build_level([(k, leaf_node(k, v)) for k, v in pairs], leaf=True)
        n_leaf = len(level)
        depth = 1
        while len(level) > 1:
            level = build_level(
                [(k, branch_node(k, pg)) for k, pg in level], leaf=False)
            n_branch += len(level)
            depth += 1
        root = level[0][1]
    else:
        root = P_INVALID

    last_pg = next_pg[0] - 1
    if mapsize is None:
        mapsize = max((last_pg + 16) * psize, 1 << 20)

    # meta pages (both written; txnid 1 on meta 1 makes it the live one)
    for mpg, txnid in ((0, 0), (1, 1)):
        pages[mpg] = bytearray(psize)
        struct.pack_into("<Q", pages[mpg], 0, mpg)
        struct.pack_into("<HHHH", pages[mpg], 8, 0, P_META, 0, 0)
        off = PAGE_HEADER
        _META_HEAD.pack_into(pages[mpg], off, MAGIC, VERSION, 0, mapsize)
        off += _META_HEAD.size
        # free DB: empty; pad field carries the page size
        _DB.pack_into(pages[mpg], off, psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        off += _DB.size
        # main DB
        _DB.pack_into(pages[mpg], off, 0, 0, depth, n_branch, n_leaf,
                      n_overflow, len(pairs), root)
        off += _DB.size
        struct.pack_into("<QQ", pages[mpg], off, last_pg, txnid)

    with open(out, "wb") as f:
        for pg in range(last_pg + 1):
            f.write(bytes(pages.get(pg, bytearray(psize))))
    return out
