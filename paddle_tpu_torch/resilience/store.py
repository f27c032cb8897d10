"""Key-value stores the decode fleet's membership rides on (counterpart of
paddle_tpu/resilience/store.py).

Two implementations of one contract: an in-process dict (in-process
fleets, tests) and a directory of atomically renamed files, one per key,
shared across processes (subprocess workers; the stand-in for etcd).

Store contract:

- ``put(key, value, ttl=None)``: upsert; optional expiry in seconds.
- ``get(key) -> Optional[str]``: None when absent or expired.
- ``delete(key)``: idempotent.
- ``prefix(pre) -> Dict[str, str]``: live entries under a key prefix.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, Optional
from urllib.parse import quote, unquote

__all__ = ["DictStore", "FileStore"]


class DictStore:
    """In-process KV store with TTL semantics."""

    def __init__(self):
        self._kv: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def put(self, key: str, value: str, ttl: Optional[float] = None):
        with self._lock:
            exp = time.time() + ttl if ttl else None
            self._kv[key] = (value, exp)

    def get(self, key: str):
        with self._lock:
            v = self._kv.get(key)
            if v is None:
                return None
            if v[1] is not None and v[1] < time.time():
                del self._kv[key]
                return None
            return v[0]

    def delete(self, key: str):
        with self._lock:
            self._kv.pop(key, None)

    def prefix(self, pre: str) -> Dict[str, str]:
        with self._lock:
            now = time.time()
            out = {}
            for k, (v, exp) in list(self._kv.items()):
                if exp is not None and exp < now:
                    del self._kv[k]
                elif k.startswith(pre):
                    out[k] = v
            return out


class FileStore:
    """File-backed KV store with TTL, shared ACROSS PROCESSES through a
    directory: one file per key (its name URL-quoted), each value written
    to a temporary file and renamed into place, so a concurrent reader
    never sees a partial write."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, quote(key, safe="") + ".json")

    def put(self, key: str, value: str, ttl: Optional[float] = None):
        payload = {"v": value, "exp": time.time() + ttl if ttl else None}
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(key))

    def _read(self, path: str):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return None
        if payload["exp"] is not None and payload["exp"] < time.time():
            # never unlinked here: between this read and an unlink the
            # owner may have renewed the file, and the fresh lease would be
            # deleted. Expired files are skipped; the owner's delete()
            # removes them
            return None
        return payload["v"]

    def get(self, key: str):
        return self._read(self._path(key))

    def delete(self, key: str):
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def prefix(self, pre: str) -> Dict[str, str]:
        out = {}
        for fn in os.listdir(self.root):
            if not fn.endswith(".json"):
                continue
            key = unquote(fn[:-len(".json")])
            if not key.startswith(pre):
                continue
            v = self._read(os.path.join(self.root, fn))
            if v is not None:
                out[key] = v
        return out
