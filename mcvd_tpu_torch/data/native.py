"""The data path's host C++ (`mcvd_tpu_torch/csrc/host/*.cpp`): the SMMNIST
batch synthesizer and the LZF codec of the HDF5 store, bound with ctypes.

The library is built with g++ at first use into `build/mcvd_tpu_torch_host/`
at the repo root, with the JAX package's flags (`-O3 -march=native -shared
-fPIC`), under a name keyed by a hash of the sources, the flags and the CPU
that `-march=native` expands to, so a changed source or another host
rebuilds and an unchanged one loads. A missing g++ or a failed build raises:
there is no silent fallback. ctypes releases the GIL for the length of each
call, so the loader's worker threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = HOST_SRC.parent.parent.parent / "build" / "mcvd_tpu_torch_host"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LIB = [None]
_LOCK = threading.Lock()


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the data readers' host library "
                           "(SMMNIST batches, LZF) is built from csrc/host with g++")
    return gxx


def _native_target(gxx: str) -> str:
    """The flags `-march=native` expands to on this host (g++ -###)."""
    out = subprocess.run([gxx, "-march=native", "-###", "-E", "-x", "c++", "-"],
                         input="", capture_output=True, text=True)
    return "\n".join(line for line in out.stderr.splitlines() if "cc1plus" in line)


def load_library() -> ctypes.CDLL:
    """Build (once per key) and load the host library."""
    with _LOCK:
        if _LIB[0] is not None:
            return _LIB[0]
        gxx = _gxx()
        sources = sorted(HOST_SRC.glob("*.cpp"))
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        h.update(_native_target(gxx).encode())
        for src in sources:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libmcvd_host_{h.hexdigest()[:16]}.so"
        if not so.exists():
            # build in a temp dir, then rename: a concurrent loader never sees
            # a half-written library
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                out = Path(tmp) / "lib.so"
                cmd = [gxx, *GXX_FLAGS, *map(str, sources), "-o", str(out)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                                       f"{proc.stdout}{proc.stderr}")
                out.replace(so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _LIB[0] = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    # digits, n_avail, ds, seed, epoch, indices, B, T, sz, num_digits,
    # deterministic, out
    lib.smmnist_synthesize.argtypes = [p, i64, i32, ctypes.c_uint64, i64, p, i64, i32, i32,
                                       i32, i32, p]
    lib.smmnist_synthesize.restype = None
    for name in ("lzf_decompress", "lzf_compress"):
        fn = getattr(lib, name)
        fn.argtypes = [p, i64, p, i64]   # in, n, out, cap
        fn.restype = i64


def smmnist_synthesize_batch(digits: np.ndarray, indices, *, seed: int, epoch: int,
                             seq_len: int, image_size: int, num_digits: int,
                             deterministic: bool) -> np.ndarray:
    """(B, T, sz, sz, 1) float32 clips of the dataset items `indices`, the
    JAX package's `native.smmnist_synthesize_batch` draws."""
    lib = load_library()
    digits = np.ascontiguousarray(digits, np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    out = np.empty((len(indices), seq_len, image_size, image_size), np.float32)
    lib.smmnist_synthesize(digits.ctypes.data, len(digits), digits.shape[1], seed, epoch,
                           indices.ctypes.data, len(indices), seq_len, image_size,
                           num_digits, int(deterministic), out.ctypes.data)
    return out[..., None]
