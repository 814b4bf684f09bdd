"""nvcc build of `mcvd_tpu_torch/csrc/*.cu` into a shared library with a
plain C interface, loaded with ctypes.

The library is built at first use into `build/mcvd_tpu_torch_kernels/` at the
repo root, under a name keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads. A missing nvcc or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIB = [None]
BUILD_SECONDS = [0.0]


BUILD_DIR = CSRC.parent.parent / "build" / "mcvd_tpu_torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
                       "of mcvd_tpu_torch are built from csrc/ at first use")


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    if _LIB[0] is not None:
        return _LIB[0]
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libmcvd_tpu_torch_{h.hexdigest()[:16]}.so"
    if not so.exists():
        t0 = time.perf_counter()
        # build to a temp name, then rename: a concurrent loader never sees a
        # half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        BUILD_SECONDS[0] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _LIB[0] = lib
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    for name in ("attention_fwd_f32", "attention_fwd_bf16"):
        fn = getattr(lib, name)
        # q, k, v, o, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale, stream
        fn.argtypes = [p, p, p, p, i, i, i, i, i64, i64, i64, i64, i64, i64, f, p]
        fn.restype = i
    lib.mcvd_cuda_error_string.argtypes = [i]
    lib.mcvd_cuda_error_string.restype = ctypes.c_char_p
