"""LZF, the codec of the HDF5 store's frame chunks (HDF5 filter 32000, as
h5py registers it).

`decompress` and `compress` run the host C++ (`csrc/host/lzf.cpp`, through
`native`), which releases the GIL. `decompress_plain` and `compress_plain`
are the same algorithms in Python: the tests' yardstick, never the readers'
route. `compress` returns None where the encoding would not be shorter than
its input, as h5py's filter then stores the chunk raw.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import native

_ERRORS = {-1: "the input ends inside a command", -2: "the output passes its size",
           -3: "a back reference points before the start"}
_HASH_LOG = 14
_MAX_OFF = 1 << 13
_MAX_LEN = 264
_MAX_LIT = 32


def _as_u8(buf) -> np.ndarray:
    return np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else \
        np.ascontiguousarray(buf).reshape(-1).view(np.uint8)


def decompress(buf, out_nbytes: int) -> np.ndarray:
    """The `out_nbytes` bytes that `buf` encodes, as a writable uint8 array.
    Raises ValueError if `buf` is not an LZF stream of exactly that size."""
    src = _as_u8(buf)
    out = np.empty(out_nbytes, np.uint8)
    n = native.load_library().lzf_decompress(src.ctypes.data, src.size, out.ctypes.data,
                                             out_nbytes)
    if n != out_nbytes:
        raise ValueError(f"LZF: {_ERRORS.get(n, f'{n} bytes decoded')}, "
                         f"want {out_nbytes} bytes")
    return out


def compress(buf) -> Optional[bytes]:
    """The LZF encoding of `buf`, or None if it is not shorter than `buf`."""
    src = _as_u8(buf)
    if src.size == 0:
        return None
    out = np.empty(src.size, np.uint8)
    n = native.load_library().lzf_compress(src.ctypes.data, src.size, out.ctypes.data,
                                           src.size - 1)
    return out[:n].tobytes() if n > 0 else None


def decompress_plain(buf, out_nbytes: int) -> np.ndarray:
    """`decompress` in Python."""
    src = bytes(_as_u8(buf))
    out = bytearray(out_nbytes)
    ip = op = 0
    n = len(src)
    while ip < n:
        ctrl = src[ip]
        ip += 1
        if ctrl < 32:
            k = ctrl + 1
            if ip + k > n:
                raise ValueError(f"LZF: {_ERRORS[-1]}")
            if op + k > out_nbytes:
                raise ValueError(f"LZF: {_ERRORS[-2]}")
            out[op:op + k] = src[ip:ip + k]
            ip += k
            op += k
            continue
        length = ctrl >> 5
        if length == 7:
            if ip >= n:
                raise ValueError(f"LZF: {_ERRORS[-1]}")
            length += src[ip]
            ip += 1
        if ip >= n:
            raise ValueError(f"LZF: {_ERRORS[-1]}")
        ref = op - ((ctrl & 31) << 8) - 1 - src[ip]
        ip += 1
        length += 2
        if ref < 0:
            raise ValueError(f"LZF: {_ERRORS[-3]}")
        if op + length > out_nbytes:
            raise ValueError(f"LZF: {_ERRORS[-2]}")
        dist = op - ref
        if dist >= length:
            out[op:op + length] = out[ref:ref + length]
        else:   # the reference overlaps what it writes: its period repeats
            out[op:op + length] = (out[ref:op] * (length // dist + 1))[:length]
        op += length
    if op != out_nbytes:
        raise ValueError(f"LZF: {op} bytes decoded, want {out_nbytes} bytes")
    return np.frombuffer(out, np.uint8)


def compress_plain(buf) -> Optional[bytes]:
    """`compress` in Python."""
    src = bytes(_as_u8(buf))
    n = len(src)
    table = [0] * (1 << _HASH_LOG)
    out = bytearray()
    ip = lit = 0

    def flush(end):
        nonlocal lit
        while lit < end:
            k = min(end - lit, _MAX_LIT)
            out.append(k - 1)
            out.extend(src[lit:lit + k])
            lit += k

    while ip + 2 < n:
        v = (src[ip] << 16) | (src[ip + 1] << 8) | src[ip + 2]
        h = ((v * 2654435761) & 0xFFFFFFFF) >> (32 - _HASH_LOG)
        ref = table[h] - 1
        table[h] = ip + 1
        if ref >= 0 and ip - ref - 1 < _MAX_OFF and src[ref:ref + 3] == src[ip:ip + 3]:
            max_len = min(n - ip, _MAX_LEN)
            length = 3
            while length < max_len and src[ref + length] == src[ip + length]:
                length += 1
            flush(ip)
            off, code = ip - ref - 1, length - 2
            if code < 7:
                out.append((code << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(code - 7)
            out.append(off & 255)
            ip += length
            lit = ip
        else:
            ip += 1
    flush(n)
    return bytes(out) if 0 < len(out) < n else None
