"""nvcc build of `mcvd_tpu_torch/csrc/*.cu` into a shared library with a
plain C interface, loaded with ctypes. Each source compiles in its own nvcc
process, all started together, then one nvcc links them.

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = [None]
BUILD_SECONDS = [0.0]
BUILD_LOG = [""]   # nvcc's output of the last build (ptxas: registers, spills)


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
        # build in a temp dir, then rename: a concurrent loader never sees a
        # half-written library
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            nvcc = _nvcc()
            objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
            procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
                     for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                                 for src, obj in zip(sources, objs))]
            results = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
            if all(rc == 0 for *_, rc in results):
                proc = subprocess.run(link, capture_output=True, text=True)
                results.append((link, proc.stdout + proc.stderr, proc.returncode))
            for cmd, out, rc in results:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
            BUILD_LOG[0] = "\n".join(out for _, out, _ in results)
            os.replace(os.path.join(tmp, "lib.so"), so)
        BUILD_SECONDS[0] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _LIB[0] = lib
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.mcvd_cuda_error_string(err).decode()} ({err})")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    for name in ("attention_fwd_f32", "attention_fwd_bf16"):
        fn = getattr(lib, name)
        # q, k, v, o, lse, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale,
        # stream
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i64, i64, i64, i64, i64, i64, f, p]
        fn.restype = i
    for name in ("attention_bwd_f32", "attention_bwd_bf16"):
        fn = getattr(lib, name)
        # q, k, v, o, do, lse, dq, dk, dv, delta, B, H, T, D, qkv_bs, qkv_ts, o_bs,
        # o_ts, scale, stream
        fn.argtypes = [p] * 10 + [i, i, i, i, i64, i64, i64, i64, f, p]
        fn.restype = i
    # x, y, n, n_blocks, stream
    lib.gn_copy_bf16.argtypes = [p, p, i64, i, p]
    lib.gn_copy_bf16.restype = i
    for name in ("gn_variant_f32", "gn_variant_bf16"):
        fn = getattr(lib, name)
        # x, gamma, beta, scale, shift, y, B, hsplit, rows, CN, G, n_per_group,
        # eps, stats_bf16, stream
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f, i, p]
        fn.restype = i
    # x, y, gamma, beta, scale, shift, stats, ss_stride, gb_bf16, ss_bf16, bf16, B,
    # S, CN, G, N, rows, cluster, threads, smem, eps, n_per_group, act, stream
    lib.gn_fused.argtypes = [p, p, p, p, p, p, p, i64, *[i] * 12, f, f, i, p]
    lib.gn_fused.restype = i
    # x, dy, dx, stats, gamma, beta, scale, shift, ss_stride, gb_bf16, ss_bf16,
    # bf16, B, S, CN, G, N, rows, blocks, threads, smem, split, n_per_group, act,
    # ws, C, stream
    lib.gn_fused_bwd.argtypes = [p] * 8 + [i64, *[i] * 13, f, i, p, i, p]
    lib.gn_fused_bwd.restype = i
    # bf16, B, S, CN, G, N, rows, cluster, threads, smem, out
    lib.gn_fused_max_active_clusters.argtypes = [*[i] * 10, ctypes.POINTER(i)]
    lib.gn_fused_max_active_clusters.restype = i
    lib.mcvd_cuda_error_string.argtypes = [i]
    lib.mcvd_cuda_error_string.restype = ctypes.c_char_p
