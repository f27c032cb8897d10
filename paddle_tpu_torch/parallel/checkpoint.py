"""The distributed sharded checkpoint with reshard-on-load (counterpart of
paddle_tpu/parallel/checkpoint.py; Paddle's
``paddle.distributed.checkpoint`` save_state_dict / load_state_dict).

The JAX package's files, so a directory crosses between the packages:

- ``{rank}.npz``: this rank's chunks, one npy entry each, keyed
  ``"<name>::<i>"``;
- ``meta.{rank}.json``: ``{"world": W, "entries": {name: {"shape",
  "dtype", "chunks": [{"offset", "shape", "file", "key"}]}}}``, the
  chunks' global offsets;
- ``metadata.json``: the coordinator's own entries (the legacy
  single-file form).

The loader merges every rank's meta of the newest save (rank 0's world
tag; a higher rank's meta from a larger world is stale), assembles each
tensor from its chunks, refuses a tensor the chunks do not cover, and
copies it into the target, so a directory saved at one world size loads
at another.

What a rank writes: a `Shard` (a local block of a tensor sharded across
ranks, with its global offset and shape) is written by its rank; a block
with a placement (`placement.DistAttr`: ``shard_llama``'s parameters, a
ZeRO step's, `api.shard_tensor`'s) is written at its global offset by the
rank at coordinate 0 of every mesh axis that replicates it; a plain
tensor is replicated on every rank, so its rows are cut into one
contiguous block a rank and each rank writes its block (a 0-d tensor, or
one with fewer rows than ranks, is rank 0's). Each byte lands once. A
target with a placement loads its own block of the assembled tensor, so
a save at ``sharding2 x mp2`` loads at world 1 or at dp2.

bf16 chunks are written and read as raw 2-byte words, so the port needs
no ``ml_dtypes``: the entry's npy header names the descr ``'bfloat16'``,
which numpy resolves through ``ml_dtypes`` where the JAX package runs
(its loader reads the chunk as bf16). JAX itself writes bf16 chunks with
the descr ``'<V2'`` (numpy's name for ml_dtypes' bf16), which its own
loader cannot cast; the port reads both.
"""
from __future__ import annotations

import ast
import io
import json
import os
import threading
import zipfile
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .placement import block_offsets, block_slices, dist_attr

__all__ = ["Shard", "load_state_dict", "save_state_dict"]

_META = "metadata.json"
_BF16_DESCRS = ("bfloat16", "<V2", "|V2")


class Shard(NamedTuple):
    """A rank's block of a tensor sharded across ranks: `data` sits at
    `offset` in a tensor of `global_shape`."""

    data: torch.Tensor
    offset: Sequence[int]
    global_shape: Sequence[int]


def _rank_world(process_group=None):
    if dist.is_available() and dist.is_initialized():
        return (dist.get_rank(process_group),
                dist.get_world_size(process_group))
    return 0, 1


def _dtype_name(dtype: torch.dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 \
        else str(np.dtype(str(dtype).replace("torch.", "")))


def _npy_bytes(t: torch.Tensor) -> bytes:
    """An npy entry of `t` (host tensor); bf16 as raw words under the
    descr 'bfloat16'."""
    t = t.detach().contiguous()
    if t.dtype != torch.bfloat16:
        buf = io.BytesIO()
        np.lib.format.write_array(buf, t.numpy(), allow_pickle=False)
        return buf.getvalue()
    raw = t.view(torch.int16).numpy().tobytes()
    header = ("{'descr': 'bfloat16', 'fortran_order': False, 'shape': "
              f"{tuple(t.shape)!r}, }}")
    pad = (64 - (10 + len(header) + 1) % 64) % 64
    header = header + " " * pad + "\n"
    return b"\x93NUMPY\x01\x00" + len(header).to_bytes(2, "little") \
        + header.encode("latin1") + raw


def _npy_tensor(blob: bytes) -> torch.Tensor:
    """A tensor from an npy entry; bf16 entries (descr 'bfloat16' or
    '<V2') from their raw words."""
    if blob[:6] != b"\x93NUMPY":
        raise ValueError("not an npy entry")
    major = blob[6]
    if major == 1:
        hlen, start = int.from_bytes(blob[8:10], "little"), 10
    else:
        hlen, start = int.from_bytes(blob[8:12], "little"), 12
    header = ast.literal_eval(blob[start:start + hlen].decode("latin1"))
    data = blob[start + hlen:]
    shape = tuple(header["shape"])
    order = "F" if header["fortran_order"] else "C"
    if header["descr"] in _BF16_DESCRS:
        words = np.frombuffer(data, dtype="<i2").reshape(shape, order=order)
        return torch.from_numpy(np.array(words, order="C")).view(
            torch.bfloat16)
    arr = np.frombuffer(data, dtype=np.dtype(header["descr"]))
    return torch.from_numpy(np.array(arr.reshape(shape, order=order),
                                     order="C"))


def _chunks(value, rank: int, world: int):
    """(global shape, dtype, [(offset, host tensor)]) this rank writes."""
    if isinstance(value, Shard):
        t = value.data.detach()
        return (list(value.global_shape), t.dtype,
                [(list(value.offset), t)])
    attr = dist_attr(value)
    if attr is not None:
        if attr.partial:
            raise ValueError("save_state_dict: a block holding a partial "
                             f"sum over {attr.partial} (reshard it first)")
        t = value.detach()
        mesh = attr.mesh
        held = attr.sharded_axes()
        if any(mesh.axis_rank(a) for a in mesh.axis_names
               if mesh.shape[a] > 1 and a not in held):
            return list(attr.global_shape), t.dtype, []
        offset = [o for o, _ in block_offsets(mesh, attr.spec,
                                              attr.global_shape)]
        return list(attr.global_shape), t.dtype, [(offset, t)]
    t = value.detach() if isinstance(value, torch.Tensor) \
        else torch.as_tensor(value)
    shape = list(t.shape)
    if t.ndim == 0 or shape[0] < world:
        return shape, t.dtype, ([([0] * t.ndim, t)] if rank == 0 else [])
    per = -(-shape[0] // world)
    lo, hi = min(rank * per, shape[0]), min((rank + 1) * per, shape[0])
    if lo >= hi:
        return shape, t.dtype, []
    return shape, t.dtype, [([lo] + [0] * (t.ndim - 1), t[lo:hi])]


def save_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id=None,
                    async_save=False):
    """Write this rank's ``{rank}.npz`` and ``meta.{rank}.json`` (and, on
    the coordinator, ``metadata.json``). Every rank of the group calls it.
    `async_save` snapshots the tensors to the host now (later steps may
    update them in place) and writes on a background thread, which it
    returns."""
    if async_save:
        snap = {}
        for name, v in state_dict.items():
            if isinstance(v, Shard):
                snap[name] = Shard(v.data.detach().to("cpu", copy=True),
                                   list(v.offset), list(v.global_shape))
            elif dist_attr(v) is not None:
                c = v.detach().to("cpu", copy=True)
                c._dist = dist_attr(v)
                snap[name] = c
            else:
                snap[name] = torch.as_tensor(v).detach().to("cpu",
                                                             copy=True)
        rank_world = _rank_world(process_group)
        th = threading.Thread(
            target=_write, args=(snap, path, rank_world, coordinator_rank),
            daemon=True)
        th.start()
        return th
    _write(state_dict, path, _rank_world(process_group), coordinator_rank)
    return None


def _write(state_dict, path, rank_world, coordinator_rank):
    rank, world = rank_world
    os.makedirs(path, exist_ok=True)
    meta: Dict[str, dict] = {}
    entries = []
    for name, value in state_dict.items():
        shape, dtype, chunks = _chunks(value, rank, world)
        entry = {"shape": shape, "dtype": _dtype_name(dtype), "chunks": []}
        for i, (offset, t) in enumerate(chunks):
            key = f"{name}::{i}"
            entries.append((key, t.to("cpu")))
            entry["chunks"].append({"offset": offset,
                                    "shape": list(t.shape),
                                    "file": f"{rank}.npz", "key": key})
        meta[name] = entry
    with zipfile.ZipFile(os.path.join(path, f"{rank}.npz"), "w",
                         zipfile.ZIP_STORED, allowZip64=True) as z:
        for key, t in entries:
            z.writestr(key + ".npy", _npy_bytes(t))
    with open(os.path.join(path, f"meta.{rank}.json"), "w") as f:
        json.dump({"world": world, "entries": meta}, f)
    if rank == coordinator_rank:
        with open(os.path.join(path, _META), "w") as f:
            json.dump(meta, f)


def _merged_meta(path: str) -> Dict[str, dict]:
    """Every rank's entries of the newest save, chunks deduplicated by
    offset (JAX's rules: rank 0's world tag decides which metas count)."""
    import glob

    by_rank = {}
    for fn in sorted(glob.glob(os.path.join(path, "meta.*.json"))):
        with open(fn) as f:
            by_rank[int(os.path.basename(fn).split(".")[1])] = json.load(f)
    if by_rank:
        tagged = any(isinstance(m, dict) and "entries" in m
                     for m in by_rank.values())
        if tagged:
            if not (isinstance(by_rank.get(0), dict)
                    and "entries" in by_rank[0]):
                raise FileNotFoundError(
                    f"sharded checkpoint at {path!r} has world-tagged rank "
                    "metas but meta.0.json is missing or untagged: the "
                    "checkpoint is incomplete")
            world = by_rank[0]["world"]
            metas = [m["entries"] for r, m in sorted(by_rank.items())
                     if r < world and isinstance(m, dict)
                     and m.get("world") == world]
        else:
            metas = [m for _, m in sorted(by_rank.items())]
    else:
        with open(os.path.join(path, _META)) as f:
            metas = [json.load(f)]
    meta: Dict[str, dict] = {}
    for m in metas:
        for name, entry in m.items():
            if name not in meta:
                meta[name] = {"shape": entry["shape"],
                              "dtype": entry["dtype"], "chunks": []}
            seen = {tuple(c["offset"]) for c in meta[name]["chunks"]}
            for ch in entry["chunks"]:
                if tuple(ch["offset"]) not in seen:
                    seen.add(tuple(ch["offset"]))
                    meta[name]["chunks"].append(ch)
    return meta


def load_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id=None,
                    offload: bool = False) -> None:
    """Fill `state_dict`'s tensors in place from a sharded checkpoint
    written at any world size: each tensor is assembled from the saved
    chunks and copied into the target (a `Shard` target takes its own
    block). A tensor the chunks do not cover, or of another shape,
    raises."""
    meta = _merged_meta(path)
    files = {}

    def entry_tensor(fn, key):
        if fn not in files:
            files[fn] = zipfile.ZipFile(os.path.join(path, fn))
        return _npy_tensor(files[fn].read(key + ".npy"))

    try:
        for name, target in state_dict.items():
            if name not in meta:
                continue
            entry = meta[name]
            shape = tuple(entry["shape"])
            attr = dist_attr(target)
            want = tuple(target.global_shape) if isinstance(target, Shard) \
                else tuple(attr.global_shape) if attr is not None \
                else tuple(target.shape)
            if want != shape:
                raise ValueError(f"{name}: checkpoint shape {shape} vs "
                                 f"target {want}")
            full = None
            covered = torch.zeros(shape, dtype=torch.bool)
            for ch in entry["chunks"]:
                part = entry_tensor(ch["file"], ch["key"])
                if full is None:
                    full = torch.zeros(shape, dtype=part.dtype)
                sl = tuple(slice(o, o + s)
                           for o, s in zip(ch["offset"], ch["shape"]))
                full[sl] = part
                covered[sl] = True
            if full is None or not bool(covered.all()):
                raise ValueError(
                    f"{name}: the checkpoint's chunks do not cover the "
                    "whole tensor; refusing to load zeros")
            with torch.no_grad():
                if isinstance(target, Shard):
                    sl = tuple(slice(o, o + s) for o, s in
                               zip(target.offset, target.data.shape))
                    target.data.copy_(full[sl])
                elif attr is not None:
                    target.copy_(full[block_slices(attr.mesh, attr.spec,
                                                   attr.global_shape)])
                else:
                    target.copy_(full)
    finally:
        for z in files.values():
            z.close()
