"""Datasets for the DataLoader tests of both packages
(``tests/test_torch_io.py``, ``tests/test_torch_io_card.py``). Importing
this module imports no JAX, so a port worker that unpickles one of them
stays JAX-free; ``RefStream`` (the JAX package's iterable dataset class)
is built on first use only (module ``__getattr__``)."""

import os

import numpy as np


class Rows:
    """Map-style: sample ``i`` is ``(row i of a seeded int64 table, a
    seeded f32 vector, i)`` (the int64 / float32 / int leaves every
    collate keeps)."""

    def __init__(self, n=20, width=6, seed=0):
        rng = np.random.default_rng(seed)
        self.tokens = rng.integers(0, 1000, (n, width)).astype(np.int64)
        self.feats = rng.standard_normal((n, 3)).astype(np.float32)

    def __getitem__(self, i):
        return self.tokens[i], self.feats[i], int(i)

    def __len__(self):
        return len(self.tokens)


class Stream:
    """Iterable (mixed into each package's ``IterableDataset``): yields ``[i]`` for i in 0..n, split between workers by
    ``get_worker_info`` (the reference pattern); the loader module that
    provides ``get_worker_info`` is passed in."""

    def __init__(self, info_module, n=16):
        self.info_module = info_module
        self.n = n

    def __iter__(self):
        import importlib

        info = importlib.import_module(self.info_module).get_worker_info()
        lo, hi = 0, self.n
        if info is not None:
            per = (hi - lo) // info.num_workers
            lo = info.id * per
            hi = lo + per
        for i in range(lo, hi):
            yield np.array([i], np.int64)


class Arange:
    """Sample ``i`` is ``[i]``; inside a worker it checks its WorkerInfo."""

    def __init__(self, info_module, n=10):
        self.info_module = info_module
        self.n = n

    def __getitem__(self, i):
        import importlib

        info = importlib.import_module(self.info_module).get_worker_info()
        assert info is not None and 0 <= info.id < 2
        return np.array([i], np.int64)

    def __len__(self):
        return self.n


class Pid:
    def __getitem__(self, i):
        return np.array([os.getpid(), i], np.int64)

    def __len__(self):
        return 8


class Plain:
    def __init__(self, n=16):
        self.n = n

    def __getitem__(self, i):
        return np.array([i], np.int64)

    def __len__(self):
        return self.n


class Bad:
    def __getitem__(self, i):
        if i == 3:
            raise RuntimeError("boom")
        return np.array([i], np.int64)

    def __len__(self):
        return 8


class Slow:
    """A python-heavy ``__getitem__`` (keeps a worker busy)."""

    def __init__(self, n=64, work=2_000_000):
        self.n = n
        self.work = work

    def __getitem__(self, i):
        acc = 0
        for j in range(self.work):
            acc += (i * j) % 7
        return np.array([i, acc % 97], np.float32)

    def __len__(self):
        return self.n


init_calls = []


def record_init(worker_id):
    init_calls.append(worker_id)  # runs in the child; the parent's stays []


def _port_iterable():
    from paddlepaddle_tpu_torch.io import IterableDataset

    return IterableDataset


class PortStream(Stream, _port_iterable()):
    pass


def __getattr__(name):
    if name == "RefStream":
        from paddlepaddle_tpu.io import IterableDataset

        cls = type("RefStream", (Stream, IterableDataset),
                   {"__module__": __name__})
        globals()["RefStream"] = cls
        return cls
    raise AttributeError(name)
