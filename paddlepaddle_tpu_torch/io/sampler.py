"""Samplers (counterpart of ``paddlepaddle_tpu/io/sampler.py`` :1-157;
reference python/paddle/io/dataloader/{sampler,batch_sampler}.py).

``SequenceSampler``, ``BatchSampler`` and ``DistributedBatchSampler`` (numpy
``default_rng(epoch)``) give the JAX package's index streams bit for bit.
``RandomSampler``, ``SubsetRandomSampler`` and ``WeightedRandomSampler``
draw from the port's generator (:mod:`..core.random`, reproducible under
``seed(s)``) where the JAX package draws from JAX keys: a permutation, or
draws with the given weights, either way, but not the same stream (ROADMAP,
the sixth reference divergence).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import random as prandom


def _gen() -> torch.Generator:
    return prandom.torch_generator("cpu")


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            idx = torch.randint(0, n, (self.num_samples,), generator=_gen())
        else:
            idx = torch.randperm(n, generator=_gen())[:self.num_samples]
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        perm = torch.randperm(len(self.indices), generator=_gen())
        return iter([self.indices[i] for i in perm.tolist()])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = torch.multinomial(torch.from_numpy(p), self.num_samples,
                                replacement=self.replacement,
                                generator=_gen())
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards samples across data-parallel ranks (reference
    python/paddle/io/dataloader/batch_sampler.py DistributedBatchSampler):
    rank ``r`` of ``n`` takes every n-th index of the (shuffled, padded)
    order from ``r``. ``num_replicas`` / ``rank`` default to the live world
    (:mod:`..distributed.env`)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed.env import get_rank, get_world_size

        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else get_world_size())
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            rng.shuffle(indices)
            self.epoch += 1
        indices = np.concatenate([indices, indices[:self.total_size - n]])
        local = indices[self.local_rank::self.nranks]
        batch = []
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
