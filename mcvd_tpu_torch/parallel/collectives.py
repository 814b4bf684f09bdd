"""The collectives of the port's data parallelism (counterpart of
`mcvd_tpu/parallel/mesh.py`), plain functions over `torch.distributed`.

Each is a no-op without a process group (`parallel.dist`), so a
single-process run takes none of them; in a group of one rank they run
(cheaply), so a one-rank launch exercises the same calls as a wider one.
Every rank must call each function at the same point of the same host code,
in the same order: a collective that one rank skips waits for it until the
timeout. Filesystem decisions go through `all_processes_true` or
`broadcast_from_primary` for that reason, as in the JAX runner.

Control collectives (`barrier`, `all_processes_true`,
`broadcast_from_primary`) run on the CPU gloo group of `parallel.dist`,
bounded by MCVD_BARRIER_TIMEOUT. Data collectives run on the default group
(NCCL, or gloo, on the tensors' device) and use only `all_reduce`,
`broadcast` and `all_gather`, which both backends take on CUDA tensors.

The JAX package's `lockstep` and `prime_collectives` (barriers against
XLA:CPU's compile skew) and its 'tensor' mesh axis are not ported (ROADMAP
"Don't port", item 15).

Row order: a batch of B rows split over P ranks gives rank r the contiguous
rows [r B/P, (r+1) B/P), as `put_global_batch` lays out the processes'
local batches in the JAX package's global array; `gather_rows` puts them
back in rank order.
"""

from __future__ import annotations

import datetime
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from . import dist as pdist

BUCKET_BYTES = 25 * 2 ** 20   # DDP's default bucket


def barrier(name: str = "") -> None:
    """Every rank waits here for the others, at most MCVD_BARRIER_TIMEOUT
    seconds; the error names the barrier."""
    if not pdist.active():
        return
    try:
        dist.monitored_barrier(group=pdist.control_group(),
                               timeout=datetime.timedelta(seconds=pdist.barrier_timeout_s()),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def all_processes_true(flag) -> bool:
    """The AND of a per-rank predicate, the same on every rank (an
    all-reduce MIN of one int)."""
    if not pdist.active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=pdist.control_group())
    return bool(t.item())


def broadcast_from_primary(value, name: str = ""):
    """Rank 0's `value` (any picklable) on every rank."""
    if not pdist.active():
        return value
    box = [value if pdist.is_main() else None]
    try:
        dist.broadcast_object_list(box, src=0, group=pdist.control_group())
    except RuntimeError as e:
        raise RuntimeError(f"broadcast {name!r}: {e}") from e
    return box[0]


def rows(n: int) -> slice:
    """This rank's contiguous rows of n (raises unless the world divides n)."""
    p, r = pdist.world(), pdist.rank()
    if n % p:
        raise ValueError(f"{n} rows do not split over {p} ranks")
    return slice(r * n // p, (r + 1) * n // p)


def shard_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a full batch (counterpart of `put_full_batch`)."""
    if not pdist.active():
        return x
    s = rows(x.shape[dim])
    return x.narrow(dim, s.start, s.stop - s.start)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' rows concatenated in rank order, on every rank
    (counterpart of `host_value`). Every rank gives the same shape."""
    if not pdist.active():
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(pdist.world())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=0)


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int) -> List[List[int]]:
    """Indices of `tensors` in runs of one dtype and device, each about
    `bucket_bytes`."""
    out, cur, size, key = [], [], 0, None
    for i, t in enumerate(tensors):
        k = (t.dtype, t.device)
        nb = t.numel() * t.element_size()
        if cur and (k != key or size + nb > bucket_bytes):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nb
        key = k
    if cur:
        out.append(cur)
    return out


def _bucketed(tensors: Sequence[torch.Tensor], bucket_bytes: int,
              op: Callable[[torch.Tensor], None]) -> None:
    """op on each bucket flattened, the result copied back into the tensors
    (any strides)."""
    for idx in _buckets(tensors, bucket_bytes):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        op(flat)
        o = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[o:o + n].view(tensors[i].shape))
            o += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     bucket_bytes: int = BUCKET_BYTES) -> Sequence[torch.Tensor]:
    """Each tensor replaced in place by its mean over the ranks, in flat
    buckets of about `bucket_bytes`; every rank receives the same bits.
    Returns `tensors`."""
    if not pdist.active():
        return tensors
    p = pdist.world()

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(p)

    _bucketed(tensors, bucket_bytes, mean)
    return tensors


def broadcast_(tensors: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES) -> None:
    """Rank 0's values of `tensors` copied into every rank's, in place."""
    if not pdist.active():
        return
    _bucketed(tensors, bucket_bytes, lambda flat: dist.broadcast(flat, src=0))


def clamp_batch(bs: int, n_avail: int, what: str) -> int:
    """An evaluation batch clamped to the split and rounded down to a
    multiple of the world (the JAX runner's `_eval_batch_size`): drop_last
    with an oversize batch yields no batch, and the ranks split the batch
    evenly."""
    p = pdist.world()
    out = (min(int(bs), int(n_avail)) // p) * p
    if out <= 0:
        raise ValueError(f"{what}: batch_size={bs} with only {n_avail} available samples "
                         f"cannot fill one multiple of the {p} ranks")
    return out


def wrap_chain(fn: Callable) -> Callable:
    """`fn(params, *batch, generator=None, **draws)` as a collective
    (counterpart of `wrap_chain_collective` / `wrap_block_collective`).

    Every rank calls the wrapped function with the full batch and the full
    batch's draws; it runs `fn` on this rank's rows and returns the full
    output, gathered in rank order, on every rank. Positional tensors are
    cut on their first axis (each holds a multiple of the world's rows; None
    passes), the keyword tensors (the explicit draws: `inj_noise`,
    `step_noise`, `cond_noise`) on their batch axis, the fourth from the
    last (a draw of the folded (B, H, W, F*C), a cond in NCHW, or a stack
    of them), and `generator`'s draws are made for the full batch and cut
    (`draws.RowDraws`), so the output is the one-process output on the same
    draws, and the generator ends in the same state on every rank."""
    from .draws import RowDraws

    def wrapped(params, *batch, generator=None, **draws):
        local = [None if a is None else shard_rows(a) for a in batch]
        cut = {k: None if v is None else shard_rows(v, dim=v.ndim - 4)
               for k, v in draws.items()}
        g = None if generator is None else RowDraws(generator)
        return gather_rows(fn(params, *local, generator=g, **cut))

    return wrapped
