"""The port's shared-memory DataLoader (paddle_tpu_torch/io/multiprocess.py
over native/shm_ring.cpp) against the JAX package's (twins of
tests/test_io_native.py).

Datasets live at module level so spawned workers unpickle them by
reference. Samples are float32 / int32 (the JAX package truncates int64
to int32), so the two packages' batches compare byte for byte.
"""
import gc
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.io import DataLoader, get_worker_info
from paddle_tpu_torch.io import _native
from paddle_tpu_torch.io._native import ShmRing
from paddle_tpu_torch.io.multiprocess import (MultiprocessIter, decode_batch,
                                              encode_batch)


class RangeDS:
    """60 samples: a (3, 4, 4) float32 image of a seeded pattern, and an
    int32 label."""

    def __init__(self, n=60):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.standard_normal((3, 4, 4)).astype(np.float32),
                np.int32(i % 7))


class WorkerIdDS:
    """Each sample names the worker that read it and the value
    worker_init_fn left in that process."""

    def __len__(self):
        return 16

    def __getitem__(self, i):
        info = get_worker_info()
        return np.array([i, info.id, info.num_workers, _INIT.get("id", -1)],
                        np.int64)


_INIT = {}


def _init_fn(worker_id):
    _INIT["id"] = 100 + worker_id


class FailingDS(RangeDS):
    def __getitem__(self, i):
        if i == 13:
            raise KeyError("sample 13 is unreadable")
        return super().__getitem__(i)


class BigDS:
    """Two samples of 1 MiB each: a batch of two exceeds a 1 MiB slot."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return torch.full((1 << 18,), float(i))


class StringDS:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return f"sample-{i}"


def _rings():
    """This process's loader rings in /dev/shm (other test processes run
    loaders beside it)."""
    return sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(f"ptt_ring_{os.getpid()}_"))


def _assert_clean(rings_before):
    assert mp.active_children() == []
    assert _rings() == rings_before


def _bytes(batch):
    return [np.ascontiguousarray(np.asarray(t)).tobytes() for t in batch]


def test_ring_push_pop_round_trip():
    ring = ShmRing.create(f"/ptt_test_ring_{os.getpid()}", 1 << 16, 4)
    msgs = [bytes([i]) * (100 + i) for i in range(8)]
    out = []
    for i in range(4):
        assert ring.push(msgs[i]) == 0
    for i in range(4, 8):
        out.append(bytes(ring.pop(timeout_ms=1000)))
        assert ring.push(msgs[i]) == 0
    for _ in range(4):
        out.append(bytes(ring.pop(timeout_ms=1000)))
    assert out == msgs
    assert ring.pop(timeout_ms=50) is None          # timeout on empty
    assert ring.push(b"x" * (1 << 17)) == -2        # larger than a slot
    ring.close()


@pytest.mark.parametrize("case", ["f32", "int64", "bf16", "nested",
                                  "pickle"])
def test_encode_decode_batch(case):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    batches = {
        "f32": (x, np.arange(4, dtype=np.float32)),
        "int64": (torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
                  np.arange(5, dtype=np.int64)),
        "bf16": (x.to(torch.bfloat16), torch.tensor(2.5,
                                                    dtype=torch.bfloat16)),
        "nested": {"a": (x, [np.int32(7) * np.ones(3, np.int32)]),
                   "b": {"c": torch.empty((0, 2))}},
        "pickle": ("strings", [1, "two"], x),
    }
    batch = batches[case]
    idx, got = decode_batch(bytearray(encode_batch(7, batch)))
    assert idx == 7

    def same(a, b):
        if isinstance(a, torch.Tensor):
            assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
            assert a.shape == b.shape and torch.equal(a, b)
        elif isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for u, v in zip(a, b):
                same(u, v)
        else:
            assert a == b

    same(batch, got)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_order_and_values_equal_threads_and_jax(workers):
    """Batches in order, byte-identical to the port's thread loader's
    (and, at 2 workers, to the JAX MultiprocessIter's); drop_last; two
    epochs at 4 workers."""
    before = _rings()
    ds = RangeDS()
    kw = dict(batch_size=8, drop_last=True, shuffle=False)
    want = [_bytes(b) for b in DataLoader(ds, num_workers=2,
                                          use_shared_memory=False, **kw)]
    assert len(want) == 7
    loader = DataLoader(ds, num_workers=workers, **kw)
    for _ in range(2 if workers == 4 else 1):
        got = list(loader)
        assert all(isinstance(t, torch.Tensor) for b in got for t in b)
        assert [_bytes(b) for b in got] == want
    if workers == 2:
        import paddle_tpu.io as jio

        jl = jio.DataLoader(ds, num_workers=2, **kw)
        it = iter(jl)
        assert type(it).__name__ == "MultiprocessIter"
        assert [_bytes([t.numpy() for t in b]) for b in it] == want
    _assert_clean(before)


def test_worker_init_fn_and_worker_info():
    before = _rings()
    loader = DataLoader(WorkerIdDS(), batch_size=4, num_workers=2,
                        worker_init_fn=_init_fn)
    rows = torch.cat(list(loader)).numpy()
    np.testing.assert_array_equal(rows[:, 0], np.arange(16))
    assert set(rows[:, 1]) <= {0, 1}
    assert (rows[:, 2] == 2).all()
    np.testing.assert_array_equal(rows[:, 3], 100 + rows[:, 1])
    assert get_worker_info() is None            # the parent is no worker
    _assert_clean(before)


def test_oversized_and_non_array_batches_travel_pickled():
    before = _rings()
    big = DataLoader(BigDS(), batch_size=2, num_workers=1)
    got = list(MultiprocessIter(big, slot_mb=1))
    assert [b.shape for b in got] == [(2, 1 << 18)] * 2
    assert float(got[1][1, 0]) == 3.0
    strings = list(DataLoader(StringDS(), batch_size=4, num_workers=1))
    assert strings == [[f"sample-{i}" for i in range(4)],
                       ["sample-4", "sample-5"]]
    _assert_clean(before)


@pytest.mark.parametrize("how", ["break", "num_iters", "exception", "gc"])
def test_no_segment_or_child_left(how):
    """An early break, fit's num_iters, a worker's exception and garbage
    collection each leave no ring segment and no live worker."""
    before = _rings()
    if how == "exception":
        with pytest.raises(KeyError, match="sample 13"):
            list(DataLoader(FailingDS(), batch_size=4, num_workers=2))
    elif how == "break":
        for i, _ in enumerate(DataLoader(RangeDS(), batch_size=4,
                                         num_workers=2)):
            if i == 1:
                break
    elif how == "gc":
        it = iter(DataLoader(RangeDS(), batch_size=4, num_workers=2))
        next(it)
        assert len(_rings()) == len(before) + 1
        del it
        gc.collect()
    else:
        from paddle_tpu_torch import hapi
        from paddle_tpu_torch.io import TensorDataset
        from paddle_tpu_torch.optimizer import AdamW

        net = torch.nn.Linear(4, 2)
        model = hapi.Model(net, device="cpu")
        model.prepare(AdamW(0.1, parameters=net.named_parameters()),
                      torch.nn.MSELoss())
        rng = np.random.default_rng(0)
        data = TensorDataset([rng.standard_normal((32, 4)).astype(np.float32),
                              rng.standard_normal((32, 2)).astype(np.float32)])
        model.fit(DataLoader(data, batch_size=4, num_workers=2), epochs=1,
                  num_iters=2, verbose=0)
    _assert_clean(before)


def test_unpicklable_dataset_raises_naming_pickle():
    before = _rings()
    ds = RangeDS()
    ds.lock = __import__("threading").Lock()
    with pytest.raises(TypeError, match="must pickle"):
        list(DataLoader(ds, batch_size=4, num_workers=2))
    _assert_clean(before)


def test_ring_that_will_not_build_raises(monkeypatch, tmp_path):
    """No thread fallback: the compiler's failure reaches the caller."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="shared-memory ring failed"):
        list(DataLoader(RangeDS(), batch_size=4, num_workers=2))
    assert mp.active_children() == []
