"""The port's gang coordination (paddle_tpu_torch.resilience.coordination,
parallel.launch.gang) against the JAX package's, on the CPU.

Twins of the JAX suite's TestBarrier, TestCoordinator, TestGangCheckpoint,
TestGangTelemetry, TestModelFitGang and TestGangKillResumeEndToEnd
(tests/test_coordination.py): store-backed barriers raise structured
BarrierTimeouts naming the missing ranks; the gang checkpoint manager
commits through the two-phase protocol, restores through generation
agreement and never collects the agreed floor; a subprocess gang killed
by ``preempt_host`` is relaunched by the supervisor and every rank
resumes from one agreed generation. Across packages: a gang generation
the JAX manager commits restores in the port's GangCheckpointManager,
and a port-written one in JAX's (the same store key layout and files).

Tolerances: restored tensors byte-equal; the gang's merged f32
trajectories against the uninterrupted in-process runs rtol 1e-5 (the
JAX suite's). Threads join within 60 s and subprocess gangs carry a
whole-run timeout. The N=4 subprocess gang is marked slow, as in the
JAX suite.
"""
import glob
import json
import os
import shutil
import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from paddle_tpu_torch import hapi
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel.launch import GangSupervisor
from paddle_tpu_torch.resilience import (Barrier, BarrierTimeout,
                                         CheckpointManager,
                                         CheckpointNotFoundError,
                                         Coordinator, DictStore, FileStore,
                                         GangCheckpointManager, chaos,
                                         coordination)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_ranks(fn, world, store, **coord_kw):
    """Run fn(rank, coordinator) on one thread per rank; re-raise the
    first failure. Returns {rank: fn result}."""
    results, errors = {}, []

    def runner(rank):
        try:
            results[rank] = fn(rank, Coordinator(store, rank, world,
                                                 **coord_kw))
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append((rank, e))

    ts = [threading.Thread(target=runner, args=(r,), daemon=True)
          for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts), "a rank thread hung"
    if errors:
        raise errors[0][1]
    return results


def test_coordination_rides_the_shared_stores():
    from paddle_tpu_torch.resilience import store

    assert coordination.DictStore is store.DictStore
    assert coordination.FileStore is store.FileStore


# ---------------------------------------------------------------------------
# barriers and the coordinator
# ---------------------------------------------------------------------------

def test_barrier_all_arrive_returns_values():
    store = DictStore()
    b = Barrier(store, 3, name="/t/b1", timeout=10)
    out = _run_ranks(lambda r, c: b.wait(r, value=f"v{r}"), 3, store)
    for r in range(3):
        assert out[r] == {0: "v0", 1: "v1", 2: "v2"}


def test_barrier_timeout_names_missing_ranks():
    b = Barrier(DictStore(), 3, name="/t/b2", timeout=0.3)
    with pytest.raises(BarrierTimeout) as cm:
        b.wait(0)
    e = cm.value
    assert (e.missing, e.arrived, e.world_size) == ([1, 2], [0], 3)
    assert "missing rank(s) [1, 2]" in str(e) and "/t/b2" in str(e)
    assert e.last_seen == {1: None, 2: None}


def test_barrier_timeout_reports_last_seen_heartbeat():
    store = DictStore()
    Coordinator(store, 1, 2, timeout=0.3, job_id="ls")
    c0 = Coordinator(store, 0, 2, timeout=0.3, job_id="ls")
    with pytest.raises(BarrierTimeout) as cm:
        c0.barrier("x")
    ago = cm.value.last_seen[1]
    assert ago is not None and ago < 30.0
    assert "s ago" in str(cm.value)


def test_attempt_namespacing_isolates_barriers():
    store = DictStore()
    c1_old = Coordinator(store, 1, 2, timeout=0.2, attempt=0)
    with pytest.raises(BarrierTimeout):
        c1_old.barrier("ckpt")
    c0_new = Coordinator(store, 0, 2, timeout=0.2, attempt=1)
    with pytest.raises(BarrierTimeout) as cm:
        c0_new.barrier("ckpt")
    assert cm.value.missing == [1]


def test_barrier_name_reuse_is_distinct_rendezvous():
    def fn(rank, coord):
        return (coord.barrier("same", value=f"a{rank}"),
                coord.barrier("same", value=f"b{rank}"))

    out = _run_ranks(fn, 2, DictStore(), timeout=10)
    assert out[0] == ({0: "a0", 1: "a1"}, {0: "b0", 1: "b1"})


def test_peers_and_wait_accounting():
    store = DictStore()
    c0 = Coordinator(store, 0, 2, timeout=5)
    c1 = Coordinator(store, 1, 2, timeout=5)
    assert sorted(c0.peers()) == [0, 1]
    assert c1.peers()[0]["pid"] == os.getpid()
    out = _run_ranks(lambda r, c: (c.barrier("b"), c.n_barriers,
                                   c.barrier_wait_s), 2, DictStore(),
                     timeout=5)
    assert out[0][1] == 1 and out[0][2] >= 0.0


def test_rank_validation():
    with pytest.raises(ValueError):
        Coordinator(DictStore(), 2, 2)
    with pytest.raises(ValueError):
        Barrier(DictStore(), 0)


def test_from_env():
    env = {"PADDLE_GANG_RANK": "1", "PADDLE_GANG_WORLD_SIZE": "3",
           "PADDLE_GANG_ATTEMPT": "2", "PADDLE_GANG_JOB": "j7"}
    with mock.patch.dict(os.environ, env):
        c = coordination.from_env(store=DictStore())
        assert (c.rank, c.world_size, c.attempt, c.job_id) == (1, 3, 2, "j7")
    with mock.patch.dict(os.environ):
        os.environ.pop("PADDLE_GANG_RANK", None)
        assert coordination.from_env() is None
    with mock.patch.dict(os.environ, {"PADDLE_GANG_RANK": "0"}):
        os.environ.pop("PADDLE_GANG_STORE", None)
        with pytest.raises(ValueError, match="PADDLE_GANG_STORE"):
            coordination.from_env()


def test_barrier_timeout_default_is_the_flag():
    from paddle_tpu_torch import set_flags

    set_flags({"barrier_timeout_s": 7.5})
    try:
        assert Barrier(DictStore(), 2).timeout == 7.5
        assert Coordinator(DictStore(), 0, 1).timeout == 7.5
    finally:
        set_flags({"barrier_timeout_s": 60.0})


# ---------------------------------------------------------------------------
# the gang checkpoint manager
# ---------------------------------------------------------------------------

@pytest.fixture
def ckdir(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    return str(d)


def _save(ckdir, store, world, payload_of_rank, step=1, job="j",
          max_to_keep=None, attempt=0):
    def fn(rank, coord):
        mgr = CheckpointManager(ckdir, max_to_keep=max_to_keep,
                                coordinator=coord)
        return mgr.save(payload_of_rank(rank), step=step)

    return _run_ranks(fn, world, store, timeout=15, job_id=job,
                      attempt=attempt)


def _corrupt(ckdir, host, gen, data=b"\xff\xee\xdd"):
    for shard in glob.glob(os.path.join(ckdir, host, f"gen-{gen:08d}",
                                        "shard-*.bin")):
        with open(shard, "r+b") as f:
            f.write(data)


def test_dispatch_and_single_host_unchanged(ckdir):
    c = Coordinator(DictStore(), 0, 1, timeout=5)
    mgr = CheckpointManager(ckdir, coordinator=c)
    assert isinstance(mgr, GangCheckpointManager)
    assert isinstance(mgr, CheckpointManager)
    plain_dir = os.path.join(ckdir, "plain")
    plain = CheckpointManager(plain_dir)
    assert type(plain) is CheckpointManager
    plain.save({"w": torch.arange(4.0)}, step=3)
    assert sorted(os.listdir(plain_dir)) == ["gen-00000001"]
    ck = plain.restore()
    assert ck.step == 3 and torch.equal(ck.value["w"], torch.arange(4.0))


def test_gang_roundtrip_layout_and_per_host_shards(ckdir):
    store = DictStore()
    gens = _save(ckdir, store, 2,
                 lambda r: {"w": torch.full((4,), float(r))}, step=7)
    assert gens == {0: 1, 1: 1}
    assert sorted(os.listdir(ckdir)) == ["group", "host-00000",
                                         "host-00001"]
    with open(os.path.join(ckdir, "group", "gen-00000001.json")) as f:
        manifest = json.load(f)
    assert manifest["world_size"] == 2
    assert manifest["hosts"] == ["host-00000", "host-00001"]

    def restore(rank, coord):
        ck = CheckpointManager(ckdir, coordinator=coord).restore()
        return ck.generation, float(ck.value["w"][0]), ck.step

    out = _run_ranks(restore, 2, store, timeout=15, job_id="j2")
    assert out == {0: (1, 0.0, 7), 1: (1, 1.0, 7)}


def test_uncommitted_stage_is_invisible(ckdir):
    store = DictStore()
    _save(ckdir, store, 2, lambda r: {"w": torch.zeros(2)})
    for host in ("host-00000", "host-00001"):
        shutil.copytree(os.path.join(ckdir, host, "gen-00000001"),
                        os.path.join(ckdir, host, "gen-00000002"))

    def restore(rank, coord):
        mgr = CheckpointManager(ckdir, coordinator=coord)
        assert mgr.generations() == [1]
        assert mgr.local_generations() == [1, 2]
        return mgr.restore().generation

    assert _run_ranks(restore, 2, store, timeout=15, job_id="j2") \
        == {0: 1, 1: 1}


def test_agreement_adopts_min_and_skips_corrupt(ckdir):
    store = DictStore()
    _save(ckdir, store, 2, lambda r: {"w": torch.full((8,), r + 1.0)})
    _save(ckdir, store, 2, lambda r: {"w": torch.full((8,), r + 10.0)},
          job="j2")
    _corrupt(ckdir, "host-00001", 2)

    def restore(rank, coord):
        ck = CheckpointManager(ckdir, coordinator=coord).restore()
        return ck.generation, float(ck.value["w"][0])

    out = _run_ranks(restore, 2, store, timeout=15, job_id="j3")
    assert out == {0: (1, 1.0), 1: (1, 2.0)}  # rolled BACK together


def test_agreement_raises_when_a_host_has_no_verified_copy(ckdir):
    store = DictStore()
    _save(ckdir, store, 2, lambda r: {"w": torch.full((8,), 1.0)})
    _corrupt(ckdir, "host-00001", 1, b"\x00garbage\x00")

    def restore(rank, coord):
        with pytest.raises(CheckpointNotFoundError, match=r"rank\(s\) \[1\]"):
            CheckpointManager(ckdir, coordinator=coord).restore()
        return True

    assert _run_ranks(restore, 2, store, timeout=15, job_id="j4") \
        == {0: True, 1: True}


def test_fresh_gang_restore_raises_not_found(ckdir):
    def restore(rank, coord):
        mgr = CheckpointManager(ckdir, coordinator=coord)
        assert mgr.generations() == []
        with pytest.raises(CheckpointNotFoundError):
            mgr.restore()
        return True

    _run_ranks(restore, 2, DictStore(), timeout=15)


def test_coordinated_gc_keeps_agreed_floor(ckdir):
    store = DictStore()
    _save(ckdir, store, 2, lambda r: {"w": torch.full((8,), 1.0)})
    _save(ckdir, store, 2, lambda r: {"w": torch.full((8,), 2.0)},
          job="j2")
    _corrupt(ckdir, "host-00001", 2)

    def agree_then_save(rank, coord):
        mgr = CheckpointManager(ckdir, max_to_keep=1, coordinator=coord)
        assert mgr.restore().generation == 1   # agreement -> floor 1
        mgr.save({"w": torch.full((8,), 3.0)})   # gen 3 + coordinated GC
        return sorted(mgr.local_generations())

    out = _run_ranks(agree_then_save, 2, store, timeout=15, job_id="j5")
    assert out == {0: [1, 3], 1: [1, 3]}
    assert sorted(os.listdir(os.path.join(ckdir, "group"))) == [
        "gen-00000001.json", "gen-00000003.json"]


def test_gc_without_agreement_keeps_window_only(ckdir):
    store = DictStore()
    for i, job in enumerate(("a", "b", "c")):
        _save(ckdir, store, 2,
              lambda r, v=float(i): {"w": torch.full((8,), v)}, job=job,
              max_to_keep=2)
    mgr = CheckpointManager(ckdir, max_to_keep=2, coordinator=Coordinator(
        store, 0, 2, timeout=5, job_id="z"))
    assert mgr.generations() == [2, 3]


def test_straggler_at_barrier_raises_not_hangs(ckdir):
    mgr = CheckpointManager(ckdir, coordinator=Coordinator(
        DictStore(), 0, 2, timeout=0.4, job_id="s"))
    with pytest.raises(BarrierTimeout) as cm:
        mgr.save({"w": torch.zeros(4)})
    assert cm.value.missing == [1]
    assert mgr.local_generations() == [1] and mgr.generations() == []


def test_async_gang_save_surfaces_timeout_at_wait(ckdir):
    mgr = CheckpointManager(ckdir, coordinator=Coordinator(
        DictStore(), 0, 2, timeout=0.4, job_id="s2"))
    mgr.save({"w": torch.zeros(4)}, blocking=False)
    with pytest.raises(BarrierTimeout):
        mgr.wait()


def test_world_size_one_gang_layout(ckdir):
    mgr = CheckpointManager(ckdir, coordinator=Coordinator(
        DictStore(), 0, 1, timeout=5))
    assert mgr.save({"w": torch.arange(3.0)}, step=9) == 1
    ck = mgr.restore()
    assert (ck.generation, ck.step) == (1, 9)
    assert sorted(os.listdir(ckdir)) == ["group", "host-00000"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gang_generation_crosses_packages(tmp_path, writer):
    """A 2-host gang generation committed by one package's
    GangCheckpointManager over a FileStore restores, through the other's
    agreement, on every rank: the same files and store keys."""
    import paddle_tpu.resilience as jres

    ck, st = str(tmp_path / "ck"), str(tmp_path / "store")
    rng = np.random.default_rng(3)
    payload = {r: rng.standard_normal((6, 5)).astype(np.float32)
               for r in range(2)}
    w_mod, r_mod = (jres, None) if writer == "jax" else (None, jres)

    def run(mod, fn, attempt):
        results, errors = {}, []
        Coord = mod.Coordinator if mod else Coordinator
        Mgr = mod.CheckpointManager if mod else CheckpointManager
        Store = mod.FileStore if mod else FileStore

        def runner(rank):
            try:
                c = Coord(Store(st), rank, 2, timeout=15, attempt=attempt)
                results[rank] = fn(rank, Mgr(ck, coordinator=c))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=runner, args=(r,), daemon=True)
              for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        if errors:
            raise errors[0]
        return results

    def save(rank, mgr):
        w = payload[rank] if writer == "jax" else torch.from_numpy(
            payload[rank])
        return mgr.save({"w": w, "rank": rank}, step=5)

    assert run(w_mod, save, 0) == {0: 1, 1: 1}

    def restore(rank, mgr):
        got = mgr.restore()
        w = got.value["w"]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        return got.generation, got.value["rank"], w.tobytes()

    out = run(r_mod, restore, 1)
    for r in range(2):
        assert out[r] == (1, r, payload[r].tobytes())


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

@pytest.fixture
def registry():
    reg = obs_metrics.enable()
    yield reg
    obs_metrics.disable()


def test_gang_checkpoint_events(ckdir, registry):
    def fn(rank, coord):
        mgr = CheckpointManager(ckdir, coordinator=coord)
        mgr.save({"w": torch.zeros(4)}, step=1)
        mgr.restore()
        return True

    _run_ranks(fn, 2, DictStore(), timeout=15)
    names = {e["event"] for e in registry.events()}
    assert {"barrier.wait", "ckpt.gang_commit",
            "ckpt.agree_generation"} <= names
    assert registry.events("ckpt.agree_generation")[0]["generation"] == 1


def test_barrier_timeout_event(registry):
    c0 = Coordinator(DictStore(), 0, 2, timeout=0.2, job_id="t")
    with pytest.raises(BarrierTimeout):
        c0.barrier("x")
    evs = registry.events("barrier.timeout")
    assert len(evs) == 1 and "[1]" in evs[0]["missing"]


def test_supervisor_restart_event(tmp_path, registry):
    sup = GangSupervisor([sys.executable, "-c", "import sys; sys.exit(5)"],
                         1, store_dir=str(tmp_path / "store"),
                         max_restarts=1, terminate_grace_s=0.2)
    res = sup.run(timeout=60)
    assert not res.success and res.attempts == 2
    evs = registry.events("gang.worker_restart")
    assert len(evs) == 1
    assert (evs[0]["prev_exit"], evs[0]["rank"]) == (5, 0)


def test_supervisor_exports_the_gang_environment(tmp_path):
    """Each rank sees PADDLE_GANG_* (rank, world size, store, attempt,
    job), CUDA_VISIBLE_DEVICES as the supervisor had it, and a None
    value in `env` unsets a variable."""
    out = tmp_path / "out"
    out.mkdir()
    code = ("import json, os, sys; json.dump({k: os.environ.get(k) for k "
            "in ('PADDLE_GANG_RANK', 'PADDLE_GANG_WORLD_SIZE', "
            "'PADDLE_GANG_STORE', 'PADDLE_GANG_ATTEMPT', 'PADDLE_GANG_JOB',"
            " 'CUDA_VISIBLE_DEVICES', 'GONE')}, open(os.path.join("
            f"{str(out)!r}, os.environ['PADDLE_GANG_RANK']), 'w'))")
    with mock.patch.dict(os.environ, {"CUDA_VISIBLE_DEVICES": "0",
                                      "GONE": "x"}):
        res = GangSupervisor([sys.executable, "-c", code], 2,
                             store_dir=str(tmp_path / "st"), job_id="jj",
                             env={"GONE": None}).run(timeout=60)
    assert res.success and res.exit_codes == [0, 0]
    for r in range(2):
        got = json.loads((out / str(r)).read_text())
        assert got == {"PADDLE_GANG_RANK": str(r),
                       "PADDLE_GANG_WORLD_SIZE": "2",
                       "PADDLE_GANG_STORE": str(tmp_path / "st"),
                       "PADDLE_GANG_ATTEMPT": "0", "PADDLE_GANG_JOB": "jj",
                       "CUDA_VISIBLE_DEVICES": "0", "GONE": None}
    assert os.path.exists(GangSupervisor([], 1, store_dir=str(
        tmp_path / "st")).log_path(1, 0))


# ---------------------------------------------------------------------------
# fit in gang mode
# ---------------------------------------------------------------------------

class _Lin(torch.nn.Module):
    """paddle's Linear: weight [in, out], y = x @ w + b."""

    def __init__(self, seed):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.weight = torch.nn.Parameter(torch.from_numpy(
            rng.uniform(-0.5, 0.5, (4, 1)).astype(np.float32)))
        self.bias = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x @ self.weight + self.bias


def _gang_model(rank):
    net = _Lin(5 + rank)
    model = hapi.Model(net, device="cpu")
    model.prepare(optimizer=Adam(learning_rate=0.01,
                                 parameters=net.parameters()),
                  loss=lambda p, l: torch.mean((p - l) ** 2))
    return model


def _gang_batches(rank, n):
    rng = np.random.default_rng(rank)
    w = rng.normal(size=(4, 1)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(4, 4)).astype(np.float32)
        out.append((x, x @ w + 0.01 * rng.normal(size=(4, 1))
                    .astype(np.float32)))
    return out


def test_fit_saves_gang_generations_and_resume_agrees(ckdir):
    def fit(rank, coord):
        model = _gang_model(rank)
        model.fit(_gang_batches(rank, 6), epochs=1, verbose=0,
                  checkpoint_dir=ckdir, resume=True, checkpoint_freq=3,
                  coordinator=coord)
        return model.restored_generation

    store = DictStore()
    assert _run_ranks(fit, 2, store, timeout=30, attempt=0) \
        == {0: None, 1: None}
    assert sorted(os.listdir(os.path.join(ckdir, "group"))) == [
        "gen-00000001.json", "gen-00000002.json"]
    assert _run_ranks(fit, 2, store, timeout=30, attempt=1) == {0: 2, 1: 2}


def test_emergency_gang_save_abandoned_on_barrier_timeout(ckdir):
    """A preempted rank whose peer never reaches the stage barrier gives
    up its emergency gang save with a RuntimeWarning and stops cleanly."""
    chaos.install("preempt_at:2")
    try:
        model = _gang_model(0)
        coord = Coordinator(DictStore(), 0, 2, timeout=0.3, job_id="e")
        with pytest.warns(RuntimeWarning, match="abandoned"):
            model.fit(_gang_batches(0, 4), epochs=1, verbose=0,
                      checkpoint_dir=ckdir, coordinator=coord)
    finally:
        chaos.uninstall()
    assert model.preempted
    assert CheckpointManager(ckdir, coordinator=Coordinator(
        DictStore(), 0, 2, timeout=5)).generations() == []


# ---------------------------------------------------------------------------
# acceptance: a subprocess gang killed and resumed
# ---------------------------------------------------------------------------

_GANG_TRAIN_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, sys.argv[5])
from paddle_tpu_torch import hapi
from paddle_tpu_torch.resilience import coordination
from test_torch_coordination import _gang_batches, _gang_model

ckpt_dir, out_dir, n_batches, epochs = (sys.argv[1], sys.argv[2],
                                        int(sys.argv[3]), int(sys.argv[4]))
coord = coordination.from_env()
rank = coord.rank
model = _gang_model(rank)
trail = open(os.path.join(out_dir, f"rank{rank}-a{coord.attempt}.jsonl"),
             "w")


class Tape(hapi.Callback):
    epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        Tape.epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        gs = Tape.epoch * n_batches + step + 1
        # flushed PER STEP so a SIGKILLed worker leaves its partial
        # trajectory for the test to merge
        trail.write(json.dumps({"step": gs,
                                "loss": float(logs["loss"][0])}) + "\n")
        trail.flush()


model.fit(_gang_batches(rank, n_batches), epochs=epochs, verbose=0,
          callbacks=[Tape()], checkpoint_dir=ckpt_dir, resume=True,
          checkpoint_freq=1, coordinator=coord)
with open(os.path.join(out_dir, f"rank{rank}-a{coord.attempt}-done.json"),
          "w") as f:
    json.dump({"restored": model.restored_generation,
               "preempted": bool(model.preempted)}, f)
"""


def _oracle(rank, n_batches, epochs):
    losses = []

    class Tape(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"][0]))

    _gang_model(rank).fit(_gang_batches(rank, n_batches), epochs=epochs,
                          verbose=0, callbacks=[Tape()])
    return losses


def _run_gang_and_check(tmp_path, world, killed_rank, chaos_spec,
                        n_batches=8, epochs=2):
    script = tmp_path / "train.py"
    script.write_text(_GANG_TRAIN_SCRIPT)
    ck, out, store = (str(tmp_path / n) for n in ("ck", "out", "store"))
    for p in (ck, out, store):
        os.makedirs(p)

    def env(rank, attempt):
        # the preemption is a ONE-SHOT external event: armed on attempt
        # 0 only, or the relaunched rank would be re-killed replaying it
        return {"PYTHONPATH": REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
                "PADDLE_TPU_BARRIER_TIMEOUT_S": "20",
                "PADDLE_TPU_CHAOS": chaos_spec if attempt == 0 else ""}

    sup = GangSupervisor(
        [sys.executable, str(script), ck, out, str(n_batches), str(epochs),
         os.path.join(REPO, "tests")], world, store_dir=store,
        max_restarts=2, env=env, terminate_grace_s=1.5)
    res = sup.run(timeout=240)
    if not res.success:
        logs = sorted(glob.glob(os.path.join(store, "logs", "*")))
        tail = open(logs[-1]).read()[-3000:] if logs else ""
        pytest.fail(f"gang failed: {res.as_dict()}\n{tail}")
    assert res.attempts == 2 and res.exit_codes == [0] * world
    assert (killed_rank, 0, -9) in res.restarts
    n_steps = n_batches * epochs
    restored = set()
    for rank in range(world):
        merged = {}
        for fn in sorted(glob.glob(os.path.join(out,
                                                f"rank{rank}-a*.jsonl"))):
            for line in open(fn):
                rec = json.loads(line)
                if rec["step"] in merged:
                    assert abs(merged[rec["step"]] - rec["loss"]) < 1e-5
                merged[rec["step"]] = rec["loss"]
        assert sorted(merged) == list(range(1, n_steps + 1))
        np.testing.assert_allclose(
            [merged[s] for s in range(1, n_steps + 1)],
            _oracle(rank, n_batches, epochs), rtol=1e-5)
        with open(os.path.join(out, f"rank{rank}-a1-done.json")) as f:
            done = json.load(f)
        assert done["restored"] is not None
        restored.add(done["restored"])
    assert len(restored) == 1, restored       # ONE agreed generation
    floor = restored.pop()
    group = sorted(os.listdir(os.path.join(ck, "group")))
    assert f"gen-{floor:08d}.json" in group and len(group) <= 4


def test_gang_kill_and_resume_converges_on_agreed_generation(tmp_path):
    """N=2 subprocess gang under PADDLE_TPU_CHAOS=preempt_host:1@6: the
    supervisor relaunches the dead gang, both ranks restore the same
    agreed generation, and the merged trajectories equal the
    uninterrupted runs'."""
    _run_gang_and_check(tmp_path, 2, 1, "preempt_host:1@6")


@pytest.mark.slow
def test_gang_kill_and_resume_n4(tmp_path):
    """The N=4 variant (kill a middle rank), marked slow as in the JAX
    suite: four fresh torch processes an attempt."""
    _run_gang_and_check(tmp_path, 4, 2, "preempt_host:2@5", epochs=1)
