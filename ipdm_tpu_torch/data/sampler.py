"""Deterministic, resumable, shard-aware index sampler and a batching
loader (port of ipdm_tpu/data/sampler.py; host-side numpy, the same
indices).

Replaces the reference RandomSampler (Utils/sampler.py:6-49): per-epoch seeded
permutations (seed+epoch), drop-last to a batch multiple, exact resume via
`indices[restore + rank :: num_replicas]`. Where the reference reads
rank/world-size from torch.distributed (never initialised in practice —
sampler.py:10-16), here sharding is explicit: pass num_replicas/rank, or
leave the defaults for one replica on one card.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class RandomSampler:
    def __init__(self, dataset_len: int, batch_size: int = 0,
                 num_iter: Optional[int] = None, restore_iter: int = 0,
                 weights: Optional[np.ndarray] = None,
                 replacement: bool = True, seed: int = 0,
                 num_replicas: int = 1, rank: int = 0):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.batch_size = batch_size * num_replicas
        self.num_samples = num_iter * self.batch_size
        self.restore = restore_iter * self.batch_size
        self.weights = weights
        self.replacement = replacement
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        if self.weights is None:
            n = self.dataset_len - self.dataset_len % self.batch_size
            epochs = self.num_samples // n + 1
            indices = []
            for e in range(epochs):
                g = np.random.default_rng(self.seed + e)
                indices.extend(g.permutation(n).tolist())
            indices = indices[:self.num_samples]
        else:
            g = np.random.default_rng(self.seed)
            p = np.asarray(self.weights, dtype=np.float64)
            p = p / p.sum()
            indices = g.choice(len(p), size=self.num_samples,
                               replace=self.replacement, p=p).tolist()
        indices = indices[self.restore + self.rank:self.num_samples:
                          self.num_replicas]
        return iter(indices)

    def __len__(self) -> int:
        return self.num_samples - self.restore


class DataLoader:
    """Minimal batching loader over (dataset, sampler) with collate.

    The reference wraps torch DataLoader with num_workers commented out
    (train_test_utils.py:366-375) — effectively a synchronous loader; this is
    the same, over numpy batches. The native prefetching loader is layered
    above in the engine (utils/native.py)."""

    def __init__(self, dataset, batch_size: int, sampler=None, collate=None,
                 shuffle: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.collate = collate or dataset.collate

    def __iter__(self):
        if self.sampler is not None:
            idx_iter = iter(self.sampler)
            batch = []
            for idx in idx_iter:
                batch.append(self.dataset[idx])
                if len(batch) == self.batch_size:
                    yield self.collate(batch)
                    batch = []
            if batch:
                yield self.collate(batch)
        else:
            for start in range(0, len(self.dataset), self.batch_size):
                batch = [self.dataset[i] for i in
                         range(start, min(start + self.batch_size,
                                          len(self.dataset)))]
                yield self.collate(batch)
