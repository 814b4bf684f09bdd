"""Multi-process data parallelism (counterpart of `mcvd_tpu/parallel/` and
`mcvd_tpu/utils.maybe_init_distributed`): the launch (`dist`), the
collectives and the collective chain (`collectives`), and draws that do not
depend on the number of ranks (`draws`).

`training.batch_size` is the global batch: each of P ranks reads a disjoint
1/P of the data (`data.DataLoader(num_processes, process_index)`), its
gradients are averaged over the ranks before the clip, and every
evaluation's sampler runs each rank's rows of the full batch. For the same
global batch and seed a P-rank run gives the one-process result, within
fp32 rounding.
"""

from . import collectives, dist, draws
from .collectives import (all_processes_true, all_reduce_mean_, barrier, broadcast_,
                          broadcast_from_primary, clamp_batch, gather_rows, shard_rows,
                          wrap_chain)
from .dist import init_from_env, is_main, rank, shutdown, world
from .draws import RowDraws, row_draws

__all__ = ["RowDraws", "all_processes_true", "all_reduce_mean_", "barrier", "broadcast_",
           "broadcast_from_primary", "clamp_batch", "collectives", "dist", "draws",
           "gather_rows", "init_from_env", "is_main", "rank", "row_draws", "shard_rows",
           "shutdown", "world", "wrap_chain"]
