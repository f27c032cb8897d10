"""The port's fleet stores (paddle_tpu_torch.resilience.store) against the
JAX package's, on the CPU.

`DictStore` and `FileStore` of both packages run the same scripts of
operations (put with and without a TTL, get, prefix scans, delete, the
clock moving past an expiry) on a clock the test drives, and every
operation's result must be equal, case for case. FileStore's own rules
are held on the port: a reader never unlinks an expired file (the owner
may have renewed it), writes leave no temporary file behind, and a second
store on the same directory (another process's view) reads the same
entries.
"""
import os

import pytest

import paddle_tpu.resilience.store as jax_store
import paddle_tpu_torch.resilience.store as port_store


class _Clock:
    """Stands in for the `time` module the stores read `time()` from."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(jax_store, "time", clock)
    monkeypatch.setattr(port_store, "time", clock)
    return clock


def _make(mod, kind, root):
    if kind == "dict":
        return mod.DictStore()
    return mod.FileStore(str(root))


SCRIPTS = {
    "ttl": [
        ("put", "fleet/j/hb/w0", "a", 1.0),
        ("put", "fleet/j/hb/w1", "b", 5.0),
        ("put", "fleet/j/epoch", "3", None),
        ("get", "fleet/j/hb/w0"),
        ("prefix", "fleet/j/hb/"),
        ("advance", 2.0),
        ("get", "fleet/j/hb/w0"),
        ("get", "fleet/j/hb/w1"),
        ("prefix", "fleet/j/"),
        ("advance", 10.0),
        ("prefix", "fleet/j/"),
        ("get", "fleet/j/epoch"),
    ],
    "renew_and_delete": [
        ("put", "k", "v1", 1.0),
        ("advance", 0.5),
        ("put", "k", "v2", 1.0),          # renewal moves the expiry
        ("advance", 0.8),
        ("get", "k"),
        ("delete", "k"),
        ("get", "k"),
        ("delete", "k"),                  # idempotent
        ("put", "k", "v3", 0),            # ttl 0 = no expiry
        ("advance", 1e6),
        ("get", "k"),
        ("get", "absent"),
    ],
    "prefix_keys": [
        ("put", "fleet/j/req/w0/00000001", '{"rid": 1}', None),
        ("put", "fleet/j/req/w0/00000000", '{"rid": 0}', None),
        ("put", "fleet/j/req/w10/00000000", '{"rid": 9}', None),
        ("put", "fleet/j/prog/w0/1", '{"tokens": [1, 2]}', None),
        ("put", "a key with spaces/and%percent", "x", None),
        ("prefix", "fleet/j/req/w0/"),
        ("prefix", "fleet/j/req/w1"),
        ("prefix", "a key"),
        ("prefix", "none/"),
        ("delete", "fleet/j/req/w0/00000000"),
        ("prefix", "fleet/j/req/"),
        ("get", "a key with spaces/and%percent"),
    ],
}


def _run(store, clock, script):
    out = []
    for op in script:
        if op[0] == "put":
            store.put(op[1], op[2], ttl=op[3])
            out.append(None)
        elif op[0] == "get":
            out.append(store.get(op[1]))
        elif op[0] == "delete":
            store.delete(op[1])
            out.append(None)
        elif op[0] == "prefix":
            out.append(sorted(store.prefix(op[1]).items()))
        else:
            clock.now += op[1]
            out.append(None)
    return out


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("kind", ["dict", "file"])
def test_store_matches_jax(clocks, tmp_path, kind, script):
    start = clocks.now
    theirs = _run(_make(jax_store, kind, tmp_path / "jax"), clocks,
                  SCRIPTS[script])
    clocks.now = start
    ours = _run(_make(port_store, kind, tmp_path / "port"), clocks,
                SCRIPTS[script])
    assert ours == theirs
    assert any(r for r in ours)


def test_filestore_reader_never_unlinks_an_expired_lease(clocks, tmp_path):
    store = port_store.FileStore(str(tmp_path))
    store.put("fleet/j/hb/w0", "lease", ttl=1.0)
    path = store._path("fleet/j/hb/w0")
    clocks.now += 2.0
    assert store.get("fleet/j/hb/w0") is None
    assert store.prefix("fleet/") == {}
    assert os.path.exists(path)           # skipped, not removed
    store.delete("fleet/j/hb/w0")         # the owner's delete removes it
    assert not os.path.exists(path)


def test_filestore_is_shared_across_instances_and_atomic(tmp_path):
    a = port_store.FileStore(str(tmp_path))
    b = port_store.FileStore(str(tmp_path))
    for i in range(20):
        a.put(f"fleet/j/done/w0/{i}", f'{{"i": {i}}}')
    assert b.prefix("fleet/j/done/w0/") == {
        f"fleet/j/done/w0/{i}": f'{{"i": {i}}}' for i in range(20)}
    b.put("fleet/j/ctl/w0", "drain")
    assert a.get("fleet/j/ctl/w0") == "drain"
    # every value went through a temporary file renamed into place
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # an unreadable file reads as absent
    with open(a._path("broken"), "w") as f:
        f.write("{not json")
    assert a.get("broken") is None and "broken" not in a.prefix("")


def test_resilience_exports_the_stores():
    import paddle_tpu_torch.resilience as res

    assert res.DictStore is port_store.DictStore
    assert res.FileStore is port_store.FileStore
    # every pillar is ported: the docstring lists them, none still to port
    assert "Still to port" not in res.__doc__
    for pillar in ("`store`", "`checkpoint`", "`coordination`",
                   "`preemption`"):
        assert pillar in res.__doc__
