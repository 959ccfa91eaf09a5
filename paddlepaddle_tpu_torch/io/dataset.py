"""Dataset types (counterpart of ``paddlepaddle_tpu/io/dataset.py`` :1-111;
reference python/paddle/io/dataloader/dataset.py).

``random_split`` draws its permutation from the port's generator
(:mod:`..core.random`, reproducible under ``seed(s)``), where the JAX
package draws from a JAX key: the split is a permutation either way, but
not the same one (ROADMAP, the sixth reference divergence).
"""

from __future__ import annotations

import bisect

import numpy as np
import torch


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long arrays or tensors (numpy arrays pickle into
    worker processes without touching a device)."""

    def __init__(self, tensors):
        lengths = {t.shape[0] for t in tensors}
        assert len(lengths) == 1, "all tensors must share dim 0"
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = (idx if ds_idx == 0
                      else idx - self.cumulative_sizes[ds_idx - 1])
        return self.datasets[ds_idx][sample_idx]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    from ..core import random as prandom

    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        counts = [int(np.floor(n * f)) for f in lengths]
        counts[-1] += n - sum(counts)
        lengths = counts
    assert sum(lengths) == len(dataset)
    perm = torch.randperm(len(dataset),
                          generator=prandom.torch_generator("cpu")).tolist()
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l]))
        offset += l
    return out
