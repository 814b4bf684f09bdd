"""Start a command as the P ranks of one group on this host, as the tests and
`chip_smoke.py` run the port's ranks (a user on one host may run the same
with torchrun).

Each rank is a process with MCVD_DIST=1, a free local port as
MCVD_COORDINATOR, MCVD_NUM_PROCESSES and its MCVD_PROCESS_ID, in a session
of its own, its output in files (a full pipe would stall a rank inside a
collective, and its peers with it). Past the timeout every rank's session
is killed.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence, Tuple


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(cmd: Sequence[str], n: int, *, timeout: float, env: Optional[dict] = None,
                cwd: Optional[str] = None) -> Tuple[List[Tuple[int, str, str]], float]:
    """`cmd` as n ranks: ([(exit code, stdout, stderr)] in rank order, wall
    seconds). Raises `subprocess.TimeoutExpired` after killing them all when
    a rank outlives `timeout` seconds. `env` (default os.environ) takes the
    MCVD_* variables on top."""
    base = dict(os.environ if env is None else env, MCVD_DIST="1",
                MCVD_COORDINATOR=f"localhost:{free_port()}", MCVD_NUM_PROCESSES=str(n))
    with tempfile.TemporaryDirectory(prefix="mcvd_ranks_") as d:
        paths = [(os.path.join(d, f"{r}.out"), os.path.join(d, f"{r}.err")) for r in range(n)]
        procs = []
        t0 = time.monotonic()
        try:
            for r, (po, pe) in enumerate(paths):
                with open(po, "w") as o, open(pe, "w") as e:
                    procs.append(subprocess.Popen(list(cmd), cwd=cwd, stdout=o, stderr=e,
                                                  env=dict(base, MCVD_PROCESS_ID=str(r)),
                                                  start_new_session=True))
            for p in procs:
                p.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        wall_s = time.monotonic() - t0
        outs = []
        for p, (po, pe) in zip(procs, paths):
            with open(po) as o, open(pe) as e:
                outs.append((p.returncode, o.read(), e.read()))
    return outs, wall_s
