"""``io`` — Dataset, samplers and DataLoader (counterpart of
``paddlepaddle_tpu/io/__init__.py``; reference python/paddle/io/reader.py:262,
io/dataloader/). The host-side input pipeline that feeds the card: batches
are assembled on the host (in worker processes, threads or the calling
thread) and copied to the card by the loader, overlapped with the step
(:mod:`.dataloader`)."""

from .dataloader import (  # noqa: F401
    DataLoader,
    DataLoaderWorkerError,
    WorkerInfo,
    default_collate_fn,
    get_worker_info,
    np_collate_fn,
)
from .dataset import (  # noqa: F401
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
    SubsetRandomSampler,
    WeightedRandomSampler,
)
