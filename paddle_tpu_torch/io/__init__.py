"""paddle.io of the port: Dataset / DataLoader / samplers (counterpart of
paddle_tpu/io; reference: python/paddle/io/reader.py:266).

The host input pipeline yields CPU torch tensors: `default_collate_fn`
stacks samples with ``torch.stack`` (numpy samples through
``np.stack``), and the trainer moves each batch onto its device.
`DataLoader(num_workers=N)` runs N spawned worker processes that hand
batches back through the port's shared-memory ring
(``use_shared_memory=True``, the default; `multiprocess.py`), or a thread
prefetch pool with ``use_shared_memory=False`` (sample decode in numpy
or torch releases the GIL). A ring that cannot be built or opened
raises: there is no thread fallback.

Shuffling draws from a ``torch.Generator`` (`RandomSampler`,
`SubsetRandomSampler`, `WeightedRandomSampler`, `random_split`, and
`DistributedBatchSampler(shuffle=True)` seeded with its epoch), so a
shuffled order differs from the JAX package's numpy one; the
unshuffled orders are the same.
"""
from __future__ import annotations

import bisect
import itertools
import math
import threading

import numpy as np
import torch

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "ConcatDataset", "random_split", "DataLoader",
    "BatchSampler", "Sampler", "SequenceSampler", "RandomSampler",
    "WeightedRandomSampler", "DistributedBatchSampler", "SubsetRandomSampler",
    "get_worker_info", "default_collate_fn",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long tensors (torch tensors or numpy arrays)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        i = bisect.bisect_right(self.cum, idx)
        prev = self.cum[i - 1] if i > 0 else 0
        return self.datasets[i][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint random `Subset`s of the given lengths (or fractions
    summing to 1), drawn with ``torch.randperm(generator=)``."""
    n = len(dataset)
    if all(isinstance(l, float) for l in lengths) \
            and abs(sum(lengths) - 1.0) < 1e-6:
        lengths = [int(math.floor(n * l)) for l in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    perm = torch.randperm(n, generator=generator).tolist()
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off: off + l]))
        off += l
    return out


# ------------------------- samplers -------------------------


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
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(torch.randint(0, n, (self.num_samples,),
                                      generator=self.generator).tolist())
        return iter(torch.randperm(n, generator=self.generator)
                    [: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        perm = torch.randperm(len(self.indices), generator=self.generator)
        return iter([self.indices[i] for i in perm.tolist()])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        self.weights = torch.as_tensor([float(w) for w in weights],
                                       dtype=torch.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        return iter(torch.multinomial(self.weights, self.num_samples,
                                      self.replacement,
                                      generator=self.generator).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Reference: python/paddle/io/dataloader/batch_sampler.py."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

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
        return n // self.batch_size if self.drop_last \
            else (n + self.batch_size - 1) // self.batch_size


def _dist_rank_world():
    """(rank, world size) of an initialized torch.distributed group,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatchSampler(BatchSampler):
    """Shards indices across data-parallel ranks (reference:
    python/paddle/io/dataloader/batch_sampler.py:DistributedBatchSampler).
    rank / num_replicas default to an initialized torch.distributed
    group's, else 0 of 1. The index list is padded (from its head) to a
    multiple of the ranks and strided by rank; shuffle=True permutes it
    first with a ``torch.Generator`` seeded with the epoch
    (`set_epoch`)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        d_rank, d_world = _dist_rank_world()
        self.nranks = num_replicas if num_replicas is not None else d_world
        self.local_rank = rank if rank is not None else d_rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            gen = torch.Generator().manual_seed(int(self.epoch))
            indices = torch.randperm(n, generator=gen).tolist()
        else:
            indices = list(range(n))
        # pad to evenly divisible
        pad = self.total_size - n
        if pad > 0:
            indices = indices + indices[:pad]
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        return self.num_samples // self.batch_size if self.drop_last \
            else (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# ------------------------- collate & worker info -------------------------


_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, "info", None)


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def default_collate_fn(batch):
    """Stack samples into CPU torch tensors (reference:
    python/paddle/io/dataloader/collate.py); the JAX package stacks into
    its own Tensors. Strings and bytes stay lists; dicts, lists and
    tuples collate field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack([b.detach().cpu() for b in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.generic)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items)) for items in zip(*batch))
    return batch


def _fetch(dataset, collate_fn, retry_policy, indices):
    """Read and collate one batch: each sample through `retry_policy` and
    the ``dataloader.fetch`` chaos seam (the loader's threads and worker
    processes alike)."""
    from ..resilience import chaos

    injector = chaos.get_chaos()  # resolved once per batch, not per sample

    def read_one(i):
        if injector is not None:
            injector.maybe_io_error("dataloader.fetch")
        return dataset[i]

    # per-sample retry: one flaky read must not re-run the whole
    # batch's (potentially expensive) decode/augment work
    samples = [retry_policy.call(read_one, i) for i in indices]
    return collate_fn(samples)


class DataLoader:
    """paddle.io.DataLoader (reference: python/paddle/io/reader.py:266).

    num_workers=0 fetches on the calling thread; num_workers>0 prefetches
    batches in order, at most ``num_workers * prefetch_factor`` ahead:
    from spawned worker processes over the shared-memory ring with
    ``use_shared_memory=True`` (the default; the dataset, collate_fn and
    worker_init_fn must pickle), or on a thread pool with
    ``use_shared_memory=False``. Every sample read goes through
    `retry_policy` (transient IOErrors) and the ``dataloader.fetch``
    chaos seam.
    """

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, retry_policy=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        # transient-IOError retry around sample fetch (disk/NFS/object
        # stores flake under load); default sizes from
        # FLAGS_io_retry_attempts — see resilience/retry.py
        if retry_policy is None:
            from ..resilience.retry import default_io_policy

            retry_policy = default_io_policy()
        self.retry_policy = retry_policy
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif not self._iterable_mode and batch_size is not None:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_sampler = None
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _fetch(self, indices):
        return _fetch(self.dataset, self.collate_fn, self.retry_policy,
                      indices)

    def _iter_single(self):
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                if self.batch_size is None:
                    yield sample
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last and self.batch_size is not None:
                yield self.collate_fn(batch)
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        for indices in self.batch_sampler:
            yield self._fetch(indices)

    def _iter_workers(self):
        """Thread-pool prefetch with bounded queue (ordered)."""
        from concurrent.futures import ThreadPoolExecutor

        max_pending = self.num_workers * self.prefetch_factor
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            it = iter(self.batch_sampler)
            try:
                for _ in range(max_pending):
                    pending.append(pool.submit(self._fetch, next(it)))
            except StopIteration:
                pass
            try:
                while pending:
                    fut = pending.pop(0)
                    yield fut.result()
                    try:
                        pending.append(pool.submit(self._fetch, next(it)))
                    except StopIteration:
                        pass
            finally:
                # a consumer that stops early (num_iters) must not wait
                # on fetches nobody will read
                for fut in pending:
                    fut.cancel()

    def __iter__(self):
        if self.num_workers > 0 and not self._iterable_mode \
                and self.batch_sampler is not None:
            if self.use_shared_memory:
                from .multiprocess import MultiprocessIter

                return MultiprocessIter(self)
            return self._iter_workers()
        return self._iter_single()
