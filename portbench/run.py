#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds `mcvd_tpu_torch` beside
`portbench/`. The cell is `portbench/workloads/<cell>.json`. The last line
of standard output is the result (one JSON object); the numbers compared
with the reference, each beside its limit, end standard error. Exits
non-zero with no result without the card(s) the cell asks for, and when
JAX, its libraries or the JAX package were loaded.

Build and kernel caches stay inside the checkout (`build/`), at fixed
paths, so only the first run of a checkout compiles.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_jit")):
    os.environ[var] = os.path.join(CHECKOUT, "build", "portbench_cache", sub)
os.environ["USE_FLAX"] = "0"
# one process, few threads: the host's cores are shared, and the port's host
# work (dispatch, the loader's producer thread) is single-threaded
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

from portbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
