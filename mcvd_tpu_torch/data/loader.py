"""Batch loader and device prefetch (counterpart of `mcvd_tpu/data/loader.py`;
upstream ncsn_runner.py:251-259 uses torch's DataLoader).

`DataLoader` keeps the JAX package's epoch order (a permutation drawn from
`SeedSequence([seed, epoch])`), its per-process split, its drop_last guard,
its batch path (a dataset's `get_batch(indices)`, SMMNIST's host
synthesizer, where the dataset has one) and its `num_workers` thread pool,
which reads the items of a batch in parallel and keeps their order (the
HDF5 readers' LZF decode releases the GIL); so the port and the JAX package
see the same clips in the same batches. `prefetch_to_device` assembles the
next batches on a producer thread into pinned host tensors and copies each
to the card with `non_blocking=True` on the consumer's side, so the copy
overlaps the device's work; the consumer's wait for the producer is the
span `data.wait` and the counters `data.batches` and `data.wait_ns`
(`tracing`). The JAX package's wire dtypes work around its TPU host link
and are not carried over.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from .. import tracing

_DATA = tracing.family("data", ("batches", "wait_ns"))


class DataLoader:
    """Map-style dataset -> numpy batches (xs, ys), shuffled per epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, num_processes: int = 1, process_index: int = 0,
                 repeat: bool = False, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.repeat = repeat
        self.num_workers = num_workers
        per_host = len(dataset) // max(1, num_processes)
        if drop_last and per_host < batch_size:
            # with drop_last the epoch would yield no batch; with repeat=True
            # the loop would never yield at all
            raise ValueError(
                f"batch_size={batch_size} exceeds the per-host split size "
                f"{per_host} with drop_last=True (dataset {len(dataset)} / "
                f"{num_processes} processes) — no batch would ever be yielded")
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.num_processes
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch]))
            rng.shuffle(idx)
        return idx[self.process_index::self.num_processes]

    def __iter__(self) -> Iterator:
        # the pool lives as long as the iteration: closing the generator
        # stops its threads
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 0 else None
        try:
            while True:
                if hasattr(self.dataset, "set_epoch"):
                    self.dataset.set_epoch(self._epoch)
                idx = self._epoch_indices()
                for i in range(0, len(idx), self.batch_size):
                    chunk = idx[i:i + self.batch_size]
                    if self.drop_last and len(chunk) < self.batch_size:
                        break
                    if hasattr(self.dataset, "get_batch"):
                        yield self.dataset.get_batch(chunk)
                        continue
                    if pool is not None:
                        items = list(pool.map(lambda j: self.dataset[int(j)], chunk))
                    else:
                        items = [self.dataset[int(j)] for j in chunk]
                    if isinstance(items[0], tuple):
                        yield (np.stack([it[0] for it in items]),
                               np.asarray([it[1] for it in items]))
                    else:
                        yield np.stack(items), None
                self._epoch += 1
                if not self.repeat:
                    return
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)


def prefetch_to_device(iterator, device, size: int = 2):
    """Yield the items of `iterator` (tuples of numpy arrays or None) as
    tensors on `device`, `size` items ahead: a producer thread turns each
    array into a host tensor (pinned when `device` is CUDA), and the consumer
    copies it with `non_blocking=True`, on the current stream. An error on
    the producer's side is raised here; closing the generator stops the
    producer."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = threading.Event()
    done = object()

    def host(x):
        if not isinstance(x, np.ndarray):
            return x
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory() if pin else t

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue_mod.Full:
                continue

    def producer():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                put(tuple(host(x) for x in item))
            put(done)
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=producer, daemon=True, name="prefetch_to_device")
    thread.start()
    try:
        while True:
            t0 = time.perf_counter_ns()
            with tracing.span("data.wait"):
                item = q.get()
            _DATA["wait_ns"] += time.perf_counter_ns() - t0
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            _DATA["batches"] += 1
            yield tuple(x.to(device, non_blocking=True) if isinstance(x, torch.Tensor) else x
                        for x in item)
    finally:
        stop.set()
        thread.join(timeout=5)
