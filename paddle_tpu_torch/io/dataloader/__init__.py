"""paddle.io.dataloader of the port (counterpart of
paddle_tpu/io/dataloader; reference: python/paddle/io/dataloader) — the
module layout, re-exported from the io package."""
from .. import (  # noqa: F401
    BatchSampler,
    ChainDataset,
    ConcatDataset,
    Dataset,
    DistributedBatchSampler,
    IterableDataset,
    RandomSampler,
    Sampler,
    SequenceSampler,
    Subset,
    SubsetRandomSampler,
    TensorDataset,
    WeightedRandomSampler,
    get_worker_info,
    random_split,
)
from . import collate  # noqa: F401
