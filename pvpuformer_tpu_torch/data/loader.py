"""Batch loader: multi-worker prefetch + per-host sharding (a copy of
pvpuformer_tpu/data/loader.py: the same batches for a (seed, epoch)).

Replaces torch DataLoader + DistributedSampler (`trainer.py:138-147`,
`isegm/utils/distributed.py:50-57`): each process loads its own shard of
every global batch (global index space is strided by process_index), records
are assembled by a thread pool and prefetched ahead of the device step.
The data package imports numpy and scipy only, never torch: a "process"
worker forks from a trainer that may hold a CUDA context, and touches
neither torch nor the card.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


def _collate(records) -> Dict[str, np.ndarray]:
    return {k: np.stack([r[k] for r in records]) for k in records[0]}


# worker-process state: the dataset is shipped ONCE per worker via the pool
# initializer (torch DataLoader inherits it the same way under fork /
# forkserver, trainer.py:182 + exp.py:32) — submitting it per record would
# re-pickle the annotation tables on every task.
_WORKER_DATASET = None


def _init_worker(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(i: int):
    return _WORKER_DATASET[i]


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True, process_index: int = 0,
                 process_count: int = 1, worker_type: str = "thread"):
        """worker_type: "thread" (default; decode/augment libs that release
        the GIL) or "process" (a fork ProcessPoolExecutor — the reference's
        multi-process DataLoader equivalent, for GIL-bound pipelines;
        both timed in chip_smoke.py phase 13b)."""
        assert batch_size % process_count == 0
        assert worker_type in ("thread", "process"), worker_type
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.pidx = process_index
        self.pcount = process_count
        self.worker_type = worker_type
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.global_batch if self.drop_last \
            else -(-n // self.global_batch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        nb = len(self)

        def local_idxs(bi: int):
            lo = bi * self.global_batch
            idxs = order[lo:lo + self.global_batch]
            return idxs[self.pidx::self.pcount][:self.local_batch]

        if self.num_workers <= 1:
            for bi in range(nb):
                yield _collate([self.dataset[int(i)]
                                for i in local_idxs(bi)])
            return

        # fan records out individually (not one task per batch) so a single
        # slow decode doesn't serialize its whole batch; batches still arrive
        # in order, `prefetch` batches ahead.
        if self.worker_type == "process":
            ctx = multiprocessing.get_context("fork")
            pool = ProcessPoolExecutor(self.num_workers, mp_context=ctx,
                                       initializer=_init_worker,
                                       initargs=(self.dataset,))
            get = _worker_get
        else:
            pool = ThreadPoolExecutor(self.num_workers)
            get = self.dataset.__getitem__
        with pool:
            def submit(bi: int):
                return [pool.submit(get, int(i)) for i in local_idxs(bi)]

            pending = [submit(bi) for bi in range(min(self.prefetch, nb))]
            nxt = len(pending)
            for _ in range(nb):
                futs = pending.pop(0)
                if nxt < nb:
                    pending.append(submit(nxt))
                    nxt += 1
                yield _collate([f.result() for f in futs])
