"""The DataLoader's worker processes over the shared-memory ring
(counterpart of paddle_tpu/io/multiprocess.py; reference:
python/paddle/io/dataloader/dataloader_iter.py
``_DataLoaderIterMultiProcess`` and worker.py).

Worker processes take index batches from a queue, read and collate the
samples, and return each batch through the ring (``native/shm_ring.cpp``);
the parent reorders them by batch index.

Transport: a batch that is a (nested) tuple / list / dict of torch tensors
and numpy arrays travels as raw bytes, each array under its dtype's name
(a bf16 tensor as its bytes: numpy has no bf16 without ``ml_dtypes``), its
payload aligned to 64 bytes. Any other structure, and a batch larger than
a slot, travels pickled (the JAX package's ``_MODE_PICKLE``): that is
transport, not a fallback. The parent decodes with ``torch.frombuffer``
into the bytearray each pop hands it, so no tensor points into a slot a
worker may reuse.

Workers are spawned, never forked (a forked child of a process holding a
CUDA context cannot use CUDA), and start with ``CUDA_VISIBLE_DEVICES=""``:
a worker never creates a context, nor builds or loads a kernel.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as pyqueue
import struct

import numpy as np
import torch

from ._native import ShmRing

_MAGIC = 0x5044
_MODE_ARRAYS = 0
_MODE_PICKLE = 1
_HEAD = "<HBQ"
_ALIGN = 64


def _flatten_batch(batch):
    """(structure, [arrays]) of a (nested) tuple / list / dict of torch
    tensors and numpy arrays; (None, None) for anything else."""
    arrays = []

    def rec(x):
        if isinstance(x, torch.Tensor):
            arrays.append(x)
            return ("t", len(arrays) - 1)
        if isinstance(x, np.ndarray) and x.dtype != object:
            arrays.append(x)
            return ("a", len(arrays) - 1)
        if isinstance(x, (list, tuple)):
            return ("l" if isinstance(x, list) else "u",
                    [rec(v) for v in x])
        if isinstance(x, dict):
            return ("d", {k: rec(v) for k, v in x.items()})
        raise TypeError

    try:
        return rec(batch), arrays
    except TypeError:
        return None, None


def _rebuild(node, arrays):
    kind, payload = node
    if kind in ("t", "a"):
        return arrays[payload]
    if kind == "l":
        return [_rebuild(v, arrays) for v in payload]
    if kind == "u":
        return tuple(_rebuild(v, arrays) for v in payload)
    if kind == "d":
        return {k: _rebuild(v, arrays) for k, v in payload.items()}
    raise ValueError(kind)


def _raw(a):
    """(dtype name, shape, bytes-like payload) of a tensor or an array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        name = str(t.dtype).replace("torch.", "")
        flat = t.reshape(-1)
        data = flat.view(torch.uint8).numpy() if flat.numel() else b""
        return "torch." + name, tuple(t.shape), data
    a = np.ascontiguousarray(a)
    return a.dtype.str, a.shape, a.reshape(-1).view(np.uint8)


def encode_batch(batch_idx: int, batch) -> bytes:
    """One message: header, then the raw arrays (or the pickle)."""
    structure, arrays = _flatten_batch(batch)
    if structure is None:
        body = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
        return struct.pack(_HEAD, _MAGIC, _MODE_PICKLE, batch_idx) + body
    sbytes = pickle.dumps(structure, protocol=pickle.HIGHEST_PROTOCOL)
    parts = [struct.pack(_HEAD, _MAGIC, _MODE_ARRAYS, batch_idx),
             struct.pack("<I", len(sbytes)), sbytes,
             struct.pack("<I", len(arrays))]
    size = sum(len(p) for p in parts)
    for a in arrays:
        dt, shape, data = _raw(a)
        nb = len(data) if isinstance(data, bytes) else data.nbytes
        meta = (struct.pack("<B", len(dt)) + dt.encode()
                + struct.pack("<B", len(shape))
                + struct.pack(f"<{len(shape)}q", *shape)
                + struct.pack("<Q", nb))
        size += len(meta)
        pad = -(size + 2) % _ALIGN
        parts += [meta, struct.pack("<H", pad), b"\0" * pad, data]
        size += 2 + pad + nb
    return b"".join(parts)


def decode_batch(data):
    """(batch index, batch) of one message. Arrays are views of `data`,
    which the caller must own (a bytearray from `ShmRing.pop`)."""
    magic, mode, batch_idx = struct.unpack_from(_HEAD, data, 0)
    off = struct.calcsize(_HEAD)
    if magic != _MAGIC:
        raise ValueError("corrupt batch message")
    if mode == _MODE_PICKLE:
        return batch_idx, pickle.loads(memoryview(data)[off:])
    (slen,) = struct.unpack_from("<I", data, off)
    off += 4
    structure = pickle.loads(memoryview(data)[off:off + slen])
    off += slen
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    arrays = []
    for _ in range(n):
        (dl,) = struct.unpack_from("<B", data, off)
        off += 1
        dt = bytes(data[off:off + dl]).decode()
        off += dl
        (nd,) = struct.unpack_from("<B", data, off)
        off += 1
        shape = struct.unpack_from(f"<{nd}q", data, off)
        off += 8 * nd
        (nb,) = struct.unpack_from("<Q", data, off)
        off += 8
        (pad,) = struct.unpack_from("<H", data, off)
        off += 2 + pad
        if dt.startswith("torch."):
            dtype = getattr(torch, dt[len("torch."):])
            if nb:
                t = torch.frombuffer(data, dtype=torch.uint8, count=nb,
                                     offset=off).view(dtype)
            else:
                t = torch.empty((0,), dtype=dtype)
            arrays.append(t.reshape(shape))
        else:
            d = np.dtype(dt)
            arrays.append(np.frombuffer(data, dtype=d, count=nb // d.itemsize,
                                        offset=off).reshape(shape))
        off += nb
    return batch_idx, _rebuild(structure, arrays)


def _worker_loop(dataset, collate_fn, retry_policy, index_queue, ring_name,
                 pickle_queue, worker_id, num_workers, worker_init_fn, seed):
    """A worker process (reference: io/dataloader/worker.py
    _worker_loop)."""
    from . import WorkerInfo, _fetch, _worker_info

    # one intra-op thread a worker: N workers' thread pools would spin on
    # the cores the trainer's host thread needs
    torch.set_num_threads(1)
    _worker_info.info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    np.random.seed((seed + worker_id) % (2 ** 31))
    torch.manual_seed(seed + worker_id)
    ring = ShmRing.open(ring_name)
    try:
        while True:
            item = index_queue.get()
            if item is None:
                break
            batch_idx, indices = item
            try:
                batch = _fetch(dataset, collate_fn, retry_policy, indices)
                msg = encode_batch(batch_idx, batch)
                if len(msg) <= ring.slot_size:
                    ring.push(msg, timeout_ms=-1)
                else:
                    pickle_queue.put((batch_idx, pickle.dumps(batch)))
            except Exception as e:  # the parent raises it
                pickle_queue.put((batch_idx, e))
    finally:
        ring.close()


class MultiprocessIter:
    """Batches in order from `loader.num_workers` worker processes, at
    most ``num_workers * prefetch_factor`` ahead."""

    def __init__(self, loader, slot_mb: int = 64):
        self.workers = []
        self.ring = None
        self.num_workers = loader.num_workers
        ctx = mp.get_context("spawn")
        self.index_queue = ctx.Queue()
        self.pickle_queue = ctx.Queue()
        self.batches = list(loader.batch_sampler)
        self.n_batches = len(self.batches)
        self.next_submit = 0
        self.next_yield = 0
        self.reorder = {}
        self.ring = ShmRing.create(f"/ptt_ring_{os.getpid()}_{id(self)}",
                                   slot_mb << 20,
                                   max(2, 2 * self.num_workers))
        seed = int.from_bytes(os.urandom(4), "little")
        args = (loader.dataset, loader.collate_fn, loader.retry_policy)
        try:
            pickle.dumps(args + (loader.worker_init_fn,))
        except Exception as e:
            self.shutdown()
            raise TypeError(
                "DataLoader(num_workers>0, use_shared_memory=True) spawns "
                "worker processes: the dataset, collate_fn, retry_policy "
                f"and worker_init_fn must pickle ({type(e).__name__}: {e})"
            ) from e
        # children inherit the environment at spawn: hide the card from
        # them, so no worker creates a CUDA context
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for w in range(self.num_workers):
                p = ctx.Process(
                    target=_worker_loop,
                    args=args + (self.index_queue, self.ring.name,
                                 self.pickle_queue, w, self.num_workers,
                                 loader.worker_init_fn, seed),
                    daemon=True)
                p.start()
                self.workers.append(p)
        except Exception:
            self.shutdown()
            raise
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        for _ in range(self.num_workers * loader.prefetch_factor):
            self._submit()

    def _submit(self):
        if self.next_submit < self.n_batches:
            self.index_queue.put((self.next_submit,
                                  self.batches[self.next_submit]))
            self.next_submit += 1

    def _take(self, idx, payload):
        if isinstance(payload, BaseException):
            self.shutdown()
            raise payload
        self.reorder[idx] = pickle.loads(payload)

    def _drain_pickled(self):
        while True:
            try:
                idx, payload = self.pickle_queue.get_nowait()
            except pyqueue.Empty:
                return
            self._take(idx, payload)

    def __iter__(self):
        return self

    def __next__(self):
        if self.next_yield >= self.n_batches:
            self.shutdown()
            raise StopIteration
        while self.next_yield not in self.reorder:
            self._drain_pickled()
            if self.next_yield in self.reorder:
                break
            msg = self.ring.pop(timeout_ms=100)
            if msg is not None:
                idx, batch = decode_batch(msg)
                self.reorder[idx] = batch
                continue
            if not any(w.is_alive() for w in self.workers):
                self._drain_pickled()
                if self.next_yield not in self.reorder:
                    self.shutdown()
                    raise RuntimeError("DataLoader workers exited "
                                       "unexpectedly")
        batch = self.reorder.pop(self.next_yield)
        self.next_yield += 1
        self._submit()
        return batch

    def shutdown(self):
        """Stop and reap the workers and unlink the ring; idempotent."""
        for _ in self.workers:
            try:
                self.index_queue.put(None)
            except Exception:
                pass
        for w in self.workers:
            w.join(timeout=2)
            if w.is_alive():
                w.terminate()
                w.join(timeout=2)
        self.workers = []
        if self.ring is not None:
            self.ring.close()
            self.ring = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass
