"""The port's RandomSampler and DataLoader (ipdm_tpu_torch/data/sampler.py)
against the JAX package's (ipdm_tpu/data/sampler.py): the same indices
for the same (length, batch, num_iter, restore_iter, weights,
num_replicas, rank), and the same batches over one dataset."""

import numpy as np
import pytest

from ipdm_tpu.data import sampler as jsampler
from ipdm_tpu_torch.data import sampler

CASES = [
    # length, batch, num_iter, restore_iter, weights, num_replicas, rank
    (10, 2, 7, 0, None, 1, 0),       # less than two epochs, drop-last 10
    (11, 3, 20, 0, None, 1, 0),      # several epochs, drop-last to 9
    (11, 3, 20, 6, None, 1, 0),      # resumed at iteration 6
    (16, 2, 9, 3, None, 2, 1),       # two replicas, the second, resumed
    (16, 2, 9, 0, None, 2, 0),       # two replicas, the first
    (6, 1, 30, 5, [1, 2, 3, 1, 1, 4], 1, 0),   # weighted, with replacement
    (5, 2, 4, 1, [0.5, 0, 1, 1, 2], 3, 2),     # weighted, three replicas
]


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in
                                             range(len(CASES))])
def test_random_sampler_indices_equal_jax(case):
    length, batch, num_iter, restore, weights, reps, rank = case
    kw = dict(batch_size=batch, num_iter=num_iter, restore_iter=restore,
              weights=None if weights is None else np.asarray(weights),
              seed=3, num_replicas=reps, rank=rank)
    got = list(sampler.RandomSampler(length, **kw))
    want = list(jsampler.RandomSampler(length, **kw))
    assert got == want
    assert len(sampler.RandomSampler(length, **kw)) == len(
        jsampler.RandomSampler(length, **kw))
    assert all(0 <= i < length for i in got)


class _Data:
    """A dataset of four-stream items, one stream absent."""

    def __init__(self, n):
        rng = np.random.default_rng(0)
        self.items = [(None, rng.random((3, 2, 1), np.float32),
                       rng.random((4, 4, 1), np.float32), None)
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    @staticmethod
    def collate(batch):
        return tuple(None if batch[0][i] is None else
                     np.stack([b[i] for b in batch]) for i in range(4))


@pytest.mark.parametrize("with_sampler", [True, False])
def test_data_loader_batches_equal_jax(with_sampler):
    data = _Data(7)
    kw = dict(batch_size=2, num_iter=5, restore_iter=1, seed=1)
    port = sampler.DataLoader(
        data, 2, sampler=sampler.RandomSampler(7, **kw) if with_sampler
        else None)
    ref = jsampler.DataLoader(
        data, 2, sampler=jsampler.RandomSampler(7, **kw) if with_sampler
        else None)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
