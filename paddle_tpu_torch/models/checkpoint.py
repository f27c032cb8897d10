"""Streaming checkpoint -> the serving layout (counterpart of
paddle_tpu/models/checkpoint.py).

A Llama-3-8B bf16 state dict is 16 GB; materializing it on the host or
the card before quantizing defeats weight-only serving. The loader reads
one tensor at a time (safetensors files, HF sharded-index layouts
included), uploads it at its stored width, quantizes it on the card, and
drops the full-precision copy before touching the next: the peak
transient is ONE weight.

The safetensors format is read here, by the port's own reader (no
``safetensors`` package): 8 bytes of little-endian u64 header length N,
N bytes of UTF-8 JSON (possibly space-padded) mapping each tensor name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` with offsets
relative to the first byte after the header, and an optional
``"__metadata__"`` entry. Each file's header is parsed once; a read
fetches one tensor's byte range with ``os.preadv`` into a buffer of its
own and views it at the stored dtype.
"""
from __future__ import annotations

import difflib
import json
import os
import struct
import sys
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..nn.quant import weight_quantize
from ..resilience import chaos
from ..resilience.retry import RetryPolicy, default_io_policy

__all__ = ["load_quant_serving_params", "SAFETENSORS_DTYPES"]

# safetensors dtype tag -> torch dtype (every tag the format defines that
# torch holds; the loader's weights are BF16 / F16 / F32)
SAFETENSORS_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "U16": torch.uint16, "I32": torch.int32,
    "U32": torch.uint32, "I64": torch.int64, "U64": torch.uint64,
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
# one os.preadv call moves at most this many bytes on Linux
_READ_CHUNK = 1 << 30


def _nearest(name: str, candidates, n: int = 3) -> str:
    close = difflib.get_close_matches(name, list(candidates), n=n,
                                      cutoff=0.4)
    return f"; nearest keys: {close}" if close else ""


def _hf_name(our_name: str) -> str:
    """Our decode-params key -> HF Llama checkpoint key."""
    if our_name.startswith("llama."):
        return "model." + our_name[len("llama."):]
    return our_name


def _needs_transpose(name: str, t: torch.Tensor) -> bool:
    """HF torch nn.Linear stores [out, in]; our projections are [in,
    out]. Embeddings are [vocab, h] in both."""
    return t.ndim == 2 and "embed_tokens" not in name


class _Entry:
    """Where one tensor lives: its file, stored dtype, shape and absolute
    byte range."""

    __slots__ = ("path", "dtype", "shape", "begin", "nbytes")

    def __init__(self, path, dtype, shape, begin, nbytes):
        self.path, self.dtype, self.shape = path, dtype, shape
        self.begin, self.nbytes = begin, nbytes


def _parse_header(path: str) -> dict:
    """{name: _Entry} of one safetensors file, every entry checked
    against the file: a known dtype, offsets inside the file, and a byte
    range of exactly numel x itemsize. Raises ValueError naming the file
    (and the tensor) otherwise."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a "
                             "safetensors header length")
        (n,) = struct.unpack("<Q", raw)
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} runs past the "
                             f"end of the file ({size} bytes)")
        try:
            header = json.loads(f.read(n).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the safetensors header is not "
                             f"UTF-8 JSON: {e}") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not a JSON "
                         "object")
    base = 8 + n
    entries = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        try:
            tag, shape = meta["dtype"], [int(d) for d in meta["shape"]]
            begin, end = (int(o) for o in meta["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: tensor {name!r} has a malformed "
                             f"header entry {meta!r}") from e
        if tag not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {tag!r}, "
                             f"not one of {sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[tag]
        numel = int(np.prod(shape, dtype=np.int64)) if shape else 1
        want = numel * dtype.itemsize
        if any(d < 0 for d in shape) or not 0 <= begin <= end \
                or base + end > size:
            raise ValueError(
                f"{path}: tensor {name!r} data_offsets [{begin}, {end}] "
                f"fall outside the file's {size - base} data bytes")
        if end - begin != want:
            raise ValueError(
                f"{path}: tensor {name!r} spans {end - begin} bytes but "
                f"its {tag} shape {shape} needs {want}")
        entries[name] = _Entry(path, dtype, tuple(shape), base + begin, want)
    return entries


def _read_entry(e: _Entry) -> torch.Tensor:
    """One tensor's bytes, read into a buffer of its own and viewed at
    the stored dtype (a host tensor that owns that buffer)."""
    if e.nbytes == 0:
        return torch.empty(e.shape, dtype=e.dtype)  # frombuffer refuses b""
    buf = bytearray(e.nbytes)
    view = memoryview(buf)
    fd = os.open(e.path, os.O_RDONLY)
    try:
        done = 0
        while done < e.nbytes:
            got = os.preadv(fd, [view[done:done + _READ_CHUNK]],
                            e.begin + done)
            if got <= 0:
                raise OSError(f"{e.path}: short read at byte "
                              f"{e.begin + done} (file truncated while "
                              "reading?)")
            done += got
    finally:
        os.close(fd)
    return torch.frombuffer(buf, dtype=torch.uint8).view(
        e.dtype).reshape(e.shape)


class _SafetensorsSource:
    """name -> host tensor over a safetensors file or an HF sharded dir.
    Tensors are read one at a time at their stored dtype; nothing else is
    resident. Shard reads retry transient IOErrors through `retry`
    (default: the shared io policy, FLAGS_io_retry_attempts attempts)."""

    def __init__(self, path: str, retry: Optional[RetryPolicy] = None):
        if sys.byteorder != "little":
            raise RuntimeError("the safetensors reader views little-endian "
                               "bytes in place: a big-endian host is not "
                               "supported")
        self._path = path
        self._retry = retry if retry is not None else default_io_policy()
        self._by_name = {}
        if os.path.isdir(path):
            idx = os.path.join(path, "model.safetensors.index.json")
            if os.path.exists(idx):
                with open(idx) as f:
                    weight_map = json.load(f)["weight_map"]
                headers = {}
                for name, fname in weight_map.items():
                    full = os.path.join(path, fname)
                    if full not in headers:
                        headers[full] = _parse_header(full)
                    # a name its shard lacks fails when it is read
                    self._by_name[name] = headers[full].get(
                        name, _Entry(full, None, None, 0, 0))
            else:
                files = sorted(f for f in os.listdir(path)
                               if f.endswith(".safetensors"))
                if not files:
                    raise FileNotFoundError(
                        f"no .safetensors files under {path}")
                for fname in files:
                    full = os.path.join(path, fname)
                    for name, e in _parse_header(full).items():
                        prev = self._by_name.get(name)
                        if prev is not None:
                            # the JAX reader's resolution: the file later
                            # in sorted order wins
                            warnings.warn(
                                f"tensor {name!r} is in both "
                                f"{os.path.basename(prev.path)} and "
                                f"{fname} under {path}; reading it from "
                                f"{fname} (the later file)", stacklevel=2)
                        self._by_name[name] = e
        else:
            self._by_name.update(_parse_header(path))

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def keys(self):
        return self._by_name.keys()

    def __call__(self, name: str) -> torch.Tensor:
        if name not in self._by_name:
            shards = sorted({e.path for e in self._by_name.values()})
            raise KeyError(
                f"tensor {name!r} not found in checkpoint {self._path!r} "
                f"({len(self._by_name)} tensors across "
                f"{len(shards)} shard file(s): "
                f"{[os.path.basename(s) for s in shards[:4]]}"
                f"{'...' if len(shards) > 4 else ''})"
                f"{_nearest(name, self._by_name)}")
        return self._retry.call(self._read, name)

    def _read(self, name: str) -> torch.Tensor:
        chaos.maybe_io_error("shard_read")
        e = self._by_name[name]
        if e.dtype is None:
            raise ValueError(f"{self._path}: the index maps tensor "
                             f"{name!r} to {os.path.basename(e.path)}, "
                             "which does not hold it")
        return _read_entry(e)


def load_quant_serving_params(cfg, source: Union[str, dict, Callable],
                              quant: Optional[str],
                              dtype: torch.dtype = torch.bfloat16,
                              names: str = "auto", device=None) -> dict:
    """Stream a checkpoint into the decode-params serving layout.

    cfg: LlamaConfig of the checkpoint, or of its first
        ``cfg.num_hidden_layers`` layers: only the names `cfg` needs are
        read.
    source: a path to a .safetensors file / HF checkpoint dir (with
        ``model.safetensors.index.json``, whose ``weight_map`` routes each
        name to its shard, or without it, every ``*.safetensors`` file in
        sorted order; a name in two files resolves to the later, with a
        warning), a name -> array dict (torch tensors or numpy arrays),
        or a callable name -> array for custom readers. Dict/callable
        use OUR names and layout ([in, out] projections); paths use HF
        names and torch layout ([out, in], transposed on the card).
    quant: None (dense serving in `dtype`), "weight_only_int8" or
        "weight_only_int4": each projection and the lm_head (when
        ``tie_word_embeddings`` is false) quantizes ON THE CARD the
        moment it lands; its full-precision copy is dropped before the
        next tensor is read.
    names: "auto" (HF names for paths, ours otherwise), "hf", or "ours".
    device: where the params live (None = cuda).

    Every tensor crosses to the card at its STORED width and widens to
    f32 there (exact for bf16 / f16), so a read moves the checkpoint's
    bytes once. Returns the dict ``ContinuousBatchingEngine``,
    ``jit_generate``, ``build_quant_generate`` and
    ``build_paged_generate`` consume, byte-identical to ``decode_params``
    of the same weights."""
    if quant not in (None, "weight_only_int8", "weight_only_int4"):
        raise ValueError(f"unsupported quant {quant!r}")
    dev = resolve_device(device)
    if isinstance(source, str):
        reader = _SafetensorsSource(source)
        hf_names = names in ("auto", "hf")
    elif isinstance(source, dict):
        reader = source.__getitem__
        hf_names = names == "hf"
    else:
        reader = source
        hf_names = names == "hf"

    def fetch(our_name):
        """The tensor on the card at its stored dtype, in our layout."""
        key = _hf_name(our_name) if hf_names else our_name
        try:
            arr = reader(key)
        except KeyError as e:
            if isinstance(source, (str, _SafetensorsSource)):
                raise  # _SafetensorsSource already raised descriptively
            known = source.keys() if isinstance(source, dict) else ()
            raise KeyError(
                f"tensor {key!r} (for param {our_name!r}) not found in "
                f"the {type(source).__name__} checkpoint source"
                f"{_nearest(key, known)}") from e
        # a numpy source is copied (one tensor's bytes): the params must
        # not alias a caller's (possibly read-only) array
        t = (torch.from_numpy(np.array(arr)) if isinstance(arr, np.ndarray)
             else torch.as_tensor(arr)).to(dev)
        if hf_names and _needs_transpose(key, t):
            t = t.t()       # a view: quantize reads it as [in, out]
        return t

    def dense(our_name):
        return fetch(our_name).to(dtype).contiguous()

    def quantized(our_name):
        w = fetch(our_name)
        if quant is None:
            return w.to(torch.float32).to(dtype).contiguous()
        # weight_quantize widens each block of output channels to f32 as
        # it goes: the f32 upcast of the JAX loader, one block at a time,
        # the same bytes out
        out = weight_quantize(w, algo=quant)
        del w   # the stored-width copy dies here, before the next read
        return out

    p = {"llama.embed_tokens.weight": dense("llama.embed_tokens.weight")}
    for i in range(cfg.num_hidden_layers):
        pre = f"llama.layers.{i}."
        for nm in ("input_layernorm.weight",
                   "post_attention_layernorm.weight"):
            p[pre + nm] = dense(pre + nm)
        for nm in ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                   "self_attn.v_proj.weight", "self_attn.o_proj.weight",
                   "mlp.gate_proj.weight", "mlp.up_proj.weight",
                   "mlp.down_proj.weight"):
            p[pre + nm] = quantized(pre + nm)
    p["llama.norm.weight"] = dense("llama.norm.weight")
    if not cfg.tie_word_embeddings:
        p["lm_head.weight"] = quantized("lm_head.weight")
    return p
