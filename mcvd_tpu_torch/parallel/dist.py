"""The port's multi-process launch (counterpart of
`mcvd_tpu/utils.maybe_init_distributed`; the JAX README's "Multi-host").

`MCVD_DIST=1` makes each process one rank of a `torch.distributed` group.
The JAX package's variables name the group:

    MCVD_COORDINATOR    host:port of rank 0's TCP store
    MCVD_NUM_PROCESSES  the world size
    MCVD_PROCESS_ID     this process's rank
    MCVD_DIST_INIT_TIMEOUT  seconds to wait for the peers at start (300)
    MCVD_BARRIER_TIMEOUT    seconds a barrier or a vote waits (900)

Without MCVD_COORDINATOR they come from torchrun's MASTER_ADDR,
MASTER_PORT, RANK and WORLD_SIZE, the counterpart of the JAX package's
autodetection. A rank's device is `cuda:LOCAL_RANK` (LOCAL_RANK, else the
rank modulo the visible cards) unless the caller names one (`cuda:N` or
`cpu`). The backend is NCCL on a card and gloo on the CPU;
`MCVD_DIST_BACKEND=gloo` asks for gloo on the card, which lets several ranks
share one card. NCCL refuses two ranks on one device: `init_from_env`
raises rather than share it.

Beside the default group (the data: gradients, batches, weights) each rank
joins a gloo group on the CPU for the control collectives (barriers, votes,
broadcasts of host values; `parallel.collectives`), whose waits
MCVD_BARRIER_TIMEOUT bounds on either backend.

Without MCVD_DIST nothing here starts a group: `rank()` is 0, `world()` 1,
`is_main()` True, and every collective is a no-op, so a single-process run
takes none of this code.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger(__name__)

# the CPU group of the control collectives; process-wide, as the default
# group it sits beside
_CONTROL: dict = {"group": None}


def enabled() -> bool:
    """Whether the environment asks for a multi-process launch."""
    return os.environ.get("MCVD_DIST", "") in ("1", "true")


def active() -> bool:
    """Whether this process is a rank of an initialised group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    return rank() == 0


def control_group():
    """The gloo group of the control collectives (None without a group)."""
    return _CONTROL["group"]


def barrier_timeout_s() -> float:
    return float(os.environ.get("MCVD_BARRIER_TIMEOUT", "900"))


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return None


def launch_spec() -> dict:
    """{coordinator, world, rank, local_rank} from the MCVD_* variables, else
    from torchrun's; raises naming what is missing."""
    coord = os.environ.get("MCVD_COORDINATOR")
    if not coord and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    n = _env_int("MCVD_NUM_PROCESSES", "WORLD_SIZE")
    r = _env_int("MCVD_PROCESS_ID", "RANK")
    missing = [what for what, v in (("MCVD_COORDINATOR (or MASTER_ADDR and MASTER_PORT)",
                                      coord),
                                     ("MCVD_NUM_PROCESSES (or WORLD_SIZE)", n),
                                     ("MCVD_PROCESS_ID (or RANK)", r)) if v is None]
    if missing:
        raise RuntimeError(f"MCVD_DIST=1 without {', '.join(missing)}")
    if not 0 <= r < n:
        raise RuntimeError(f"rank {r} outside a world of {n}")
    return {"coordinator": coord, "world": n, "rank": r,
            "local_rank": _env_int("LOCAL_RANK")}


def rank_device(device: str, local_rank: Optional[int], rank_: int) -> torch.device:
    """The rank's device: `device` where it names one (`cpu`, `cuda:N`);
    plain `cuda` is `cuda:LOCAL_RANK`, else the rank modulo the visible
    cards. Raises without a card where it names CUDA."""
    d = resolve_device(device, "init_from_env")
    if d.type != "cuda" or d.index is not None:
        return d
    idx = local_rank if local_rank is not None else rank_ % torch.cuda.device_count()
    return torch.device("cuda", idx)


def init_from_env(device: str = "cuda") -> torch.device:
    """Join the group the environment names (see the module's docstring)
    and return this rank's device; without MCVD_DIST, only the device."""
    if not enabled():
        return resolve_device(device, "init_from_env")
    spec = launch_spec()
    d = rank_device(device, spec["local_rank"], spec["rank"])
    backend = os.environ.get("MCVD_DIST_BACKEND") or ("nccl" if d.type == "cuda" else "gloo")
    if backend == "nccl" and d.type != "cuda":
        raise RuntimeError(f"MCVD_DIST_BACKEND=nccl needs a card; the rank's device is {d}")
    if d.type == "cuda":
        torch.cuda.set_device(d)   # before the first collective (NCCL, object broadcasts)
    init_s = float(os.environ.get("MCVD_DIST_INIT_TIMEOUT", "300"))
    dist.init_process_group(backend, init_method=f"tcp://{spec['coordinator']}",
                            world_size=spec["world"], rank=spec["rank"],
                            timeout=datetime.timedelta(seconds=init_s))
    _CONTROL["group"] = dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=barrier_timeout_s()))
    where = [None] * spec["world"]
    dist.all_gather_object(where, (socket.gethostname(), str(d)), group=_CONTROL["group"])
    if backend == "nccl" and d.type == "cuda" and len(set(where)) < len(where):
        shutdown()
        raise RuntimeError(f"NCCL with two ranks on one device ({where}); set "
                           "MCVD_DIST_BACKEND=gloo to share a card")
    logger.info("distributed: backend %s, rank %d of %d, device %s (coordinator %s)",
                backend, spec["rank"], spec["world"], d, spec["coordinator"])
    return d


def shutdown() -> None:
    """Leave the group (no-op without one)."""
    if active():
        dist.destroy_process_group()
    _CONTROL["group"] = None
