"""The port's checkpoint, preemption and fit-resume paths
(paddle_tpu_torch.resilience, hapi.Model.fit) against the JAX package's,
on the CPU.

Twins of the JAX suite's TestCheckpointManager, TestPreemption,
TestFitCheckpointResume, TestPreemptKillResumeEndToEnd and
TestDataLoaderRetry (tests/test_resilience.py), plus:

- the manifest read across packages both ways (a generation the JAX
  manager writes restores in the port's, and the reverse) for float32,
  int64 and bfloat16 leaves: byte-equal (the JAX side reads bf16 through
  its own ml_dtypes);
- the async snapshot of CPU torch tensors the optimizer then updates in
  place (``t.cpu()`` would alias them);
- a save while a CUDA graph capture records raises CheckpointError.

Tolerances: restored tensors are byte-equal; the fit trajectories are
f32 on a 4 -> 1 linear model: a resumed run against the uninterrupted one
rtol 1e-5 (the JAX suite's), and the port's uninterrupted run against the
JAX package's rtol 1e-5 too (f32 rounding of the two Adam steps drifts by
a few ulps over 16 steps).
"""
import glob
import json
import os
import signal
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch import hapi, set_flags
from paddle_tpu_torch.io import DataLoader, Dataset
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.resilience import (ChaosError, Checkpoint,
                                         CheckpointCorruptError,
                                         CheckpointError, CheckpointManager,
                                         CheckpointNotFoundError,
                                         PreemptionGuard, RetryPolicy, chaos)
from paddle_tpu_torch.resilience import preemption as preemption_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    chaos.uninstall()


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------

def _corrupt_latest_shard(mgr):
    gen = mgr.latest_generation()
    shard = sorted(glob.glob(os.path.join(mgr._gen_path(gen),
                                          "shard-*.bin")))[0]
    with open(shard, "r+b") as f:
        raw = f.read()
        f.seek(0)
        f.write(bytes([raw[0] ^ 0xFF]) + raw[1:])
    return gen


def test_roundtrip_nested_pytree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "bf16": torch.full((2, 2), 1.5, dtype=torch.bfloat16),
        "np": np.arange(5, dtype=np.int32),
        "opt": {"lr": 0.1, "step": 7, "name": "adam", "flag": True,
                "none": None},
        "stack": [torch.ones(2, dtype=torch.int32), (1, 2.5)],
    }
    gen = mgr.save(state, step=42, meta={"epoch": 3})
    ck = mgr.restore()
    assert isinstance(ck, Checkpoint)
    assert (ck.generation, ck.step, ck.meta["epoch"]) == (gen, 42, 3)
    assert torch.equal(ck.value["w"], state["w"])
    assert ck.value["bf16"].dtype == torch.bfloat16
    assert torch.equal(ck.value["bf16"], state["bf16"])
    # numpy leaves come back as torch tensors (the port's restore)
    assert torch.equal(ck.value["np"], torch.arange(5, dtype=torch.int32))
    assert ck.value["opt"] == state["opt"]
    assert isinstance(ck.value["stack"][1], tuple)


def test_tensor_leaves_roundtrip(tmp_path):
    lin = torch.nn.Linear(4, 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"model": lin.state_dict()})
    lin2 = torch.nn.Linear(4, 2)
    lin2.load_state_dict(mgr.restore().value["model"])
    assert torch.equal(lin2.weight, lin.weight)
    assert torch.equal(lin2.bias, lin.bias)


def test_generations_monotonic_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    gens = [mgr.save({"x": torch.zeros(1)}, step=i) for i in range(4)]
    assert gens == [1, 2, 3, 4]
    assert mgr.generations() == [3, 4]
    # a NEW manager continues the counter from disk
    assert CheckpointManager(str(tmp_path), max_to_keep=2).save(
        {"x": torch.zeros(1)}) == 5


def test_corrupt_shard_falls_back_to_previous_generation(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.full((4,), 1.0)}, step=1)
    g2 = mgr.save({"x": torch.full((4,), 2.0)}, step=2)
    _corrupt_latest_shard(mgr)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ck = mgr.restore()
    assert any("failed verification" in str(x.message) for x in w)
    assert ck.step == 1
    assert torch.equal(ck.value["x"], torch.full((4,), 1.0))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(generation=g2)


def test_every_generation_corrupt_raises_not_found(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.ones(2)})
    _corrupt_latest_shard(mgr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(CheckpointNotFoundError):
            mgr.restore()


def test_empty_dir_raises_not_found(tmp_path):
    with pytest.raises(CheckpointNotFoundError):
        CheckpointManager(str(tmp_path)).restore()


def test_async_save_waits_and_surfaces_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.ones(8)}, step=1, blocking=False)
    mgr.wait()
    assert mgr.restore().step == 1
    chaos.install("io_error:1.0:ckpt.write")
    set_flags({"io_retry_attempts": 1})
    try:
        mgr.save({"x": torch.ones(8)}, step=2, blocking=False)
        with pytest.raises(ChaosError):
            mgr.wait()
    finally:
        set_flags({"io_retry_attempts": 3})
        chaos.uninstall()
    assert mgr.restore().step == 1  # the failed generation never committed


def test_write_retries_transient_io_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    chaos.install("io_error:0.5:ckpt.write", seed=3)
    try:
        mgr.save({"x": torch.ones(4), "y": torch.zeros(3)}, step=9)
    finally:
        chaos.uninstall()
    assert mgr.restore().step == 9


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_async_save_snapshots_before_mutation(tmp_path, kind):
    # a CPU leaf the next step updates in place must be saved as it was
    # when save() returned: .cpu() / np.asarray alone would alias it
    mgr = CheckpointManager(str(tmp_path))
    arr = torch.full((64,), 1.0) if kind == "torch" else np.full(64, 1.0)
    mgr.save({"w": arr}, step=1, blocking=False)
    arr[:] = 999.0
    mgr.wait()
    got = mgr.restore().value["w"]
    assert torch.equal(got, torch.full((64,), 1.0, dtype=got.dtype))


def test_async_save_snapshots_optimizer_updates(tmp_path):
    # the port's optimizer writes params with p.copy_(...): a step right
    # after an async save must not reach the generation
    p = torch.nn.Parameter(torch.ones(32))
    opt = Adam(0.1, parameters=[p])
    p.grad = torch.ones(32)
    opt.step()
    before = {"p": p.detach().clone(),
              "m": opt.state_dict()["param_0_moment1"].clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"p": p, "opt": opt.state_dict()}, blocking=False)
    for _ in range(3):
        opt.step()
    mgr.wait()
    got = mgr.restore().value
    assert torch.equal(got["p"], before["p"])
    assert torch.equal(got["opt"]["param_0_moment1"], before["m"])
    assert not torch.equal(p.detach(), before["p"])


def test_injected_write_corruption_caught_by_digest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.full((16,), 1.0)}, step=1)
    chaos.install("corrupt:1.0:ckpt.write", seed=0)
    try:
        mgr.save({"x": torch.full((16,), 2.0)}, step=2)
    finally:
        chaos.uninstall()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ck = mgr.restore()
    assert ck.step == 1
    assert any("failed verification" in str(x.message) for x in w)


def test_restore_retries_transient_read_faults(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.arange(4.0)}, step=1)
    chaos.install("io_error:0.35:ckpt.read", seed=1)
    try:
        ck = mgr.restore()
    finally:
        chaos.uninstall()
    assert ck.step == 1


def test_save_while_capturing_a_cuda_graph_raises(tmp_path, monkeypatch):
    # the port's twin of the JAX suite's save-inside-jit: a save must
    # never be recorded into a captured program (the capture state is
    # faked here; tests/test_torch_cuda.py has no such card case)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(CheckpointError, match="CUDA graph capture"):
        mgr.save({"x": torch.ones(2)})
    monkeypatch.undo()
    assert mgr.generations() == []


# ---------------------------------------------------------------------------
# one on-disk format: a generation of either package restores in the other
# ---------------------------------------------------------------------------

def _cross_state():
    import ml_dtypes

    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((5, 3)).astype(np.float32)
    i64 = rng.integers(-2 ** 40, 2 ** 40, (4,), dtype=np.int64)
    bf16 = rng.standard_normal((3, 6)).astype(ml_dtypes.bfloat16)
    return f32, i64, bf16


def test_jax_generation_restores_in_the_port(tmp_path):
    from paddle_tpu.resilience import CheckpointManager as JaxManager

    f32, i64, bf16 = _cross_state()
    JaxManager(str(tmp_path)).save(
        {"f32": f32, "nest": {"i64": i64, "bf16": bf16}, "lr": 0.5},
        step=11, meta={"epoch": 2})
    ck = CheckpointManager(str(tmp_path)).restore()
    assert (ck.step, ck.meta) == (11, {"epoch": 2})
    assert ck.value["lr"] == 0.5
    assert torch.equal(ck.value["f32"], torch.from_numpy(f32))
    assert torch.equal(ck.value["nest"]["i64"], torch.from_numpy(i64))
    got = ck.value["nest"]["bf16"]
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == bf16.tobytes()


def test_port_generation_restores_in_jax(tmp_path):
    from paddle_tpu.resilience import CheckpointManager as JaxManager

    f32, i64, bf16 = _cross_state()
    t_bf16 = torch.from_numpy(bf16.view(np.int16).copy()).view(
        torch.bfloat16)
    CheckpointManager(str(tmp_path), digest="sha256").save(
        {"f32": torch.from_numpy(f32), "nest": {
            "i64": torch.from_numpy(i64), "bf16": t_bf16}, "lr": 0.5},
        step=12)
    ck = JaxManager(str(tmp_path)).restore()
    assert ck.step == 12 and ck.value["lr"] == 0.5
    np.testing.assert_array_equal(ck.value["f32"], f32)
    np.testing.assert_array_equal(ck.value["nest"]["i64"], i64)
    assert str(ck.value["nest"]["bf16"].dtype) == "bfloat16"
    assert ck.value["nest"]["bf16"].tobytes() == bf16.tobytes()


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def test_guard_flags_real_sigterm():
    with PreemptionGuard(signals=(signal.SIGTERM,)) as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):          # the handler runs between bytecodes
            if guard.requested:
                break
            time.sleep(0.01)
        assert guard.requested and guard.signum == signal.SIGTERM
    guard.reset()
    assert not guard.requested


def test_chains_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard(signals=(signal.SIGTERM,)) as guard:
            guard.deliver(signal.SIGTERM)
            assert guard.requested and seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_sigint_default_handler_not_chained():
    if signal.getsignal(signal.SIGINT) is not signal.default_int_handler:
        pytest.skip("SIGINT handler not the python default here")
    with PreemptionGuard(signals=(signal.SIGINT,)) as guard:
        guard.deliver(signal.SIGINT)  # must not raise KeyboardInterrupt
        assert guard.requested


def test_module_guard_nests():
    g1 = preemption_mod.install(signals=(signal.SIGTERM,))
    g2 = preemption_mod.install()
    assert g1 is g2
    g1.deliver()
    assert preemption_mod.requested()
    preemption_mod.uninstall()
    assert preemption_mod.requested()       # still held by g1
    preemption_mod.uninstall()
    assert not preemption_mod.requested()   # released


# ---------------------------------------------------------------------------
# fit: checkpoint and resume (a 4 -> 1 linear model in paddle's layout)
# ---------------------------------------------------------------------------

class _Lin(torch.nn.Module):
    """paddle's Linear: weight [in, out], y = x @ w + b."""

    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.as_tensor(w))
        self.bias = torch.nn.Parameter(torch.as_tensor(b))

    def forward(self, x):
        return x @ self.weight + self.bias


def _mse(pred, label):
    return torch.mean((pred - label) ** 2)


def _init(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (4, 1)).astype(np.float32),
            np.zeros(1, np.float32))


class _LossTape(hapi.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


def _make_batches(n=8, bsz=4, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(4, 1)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(bsz, 4)).astype(np.float32)
        out.append((x, x @ w + 0.01 * rng.normal(size=(bsz, 1))
                    .astype(np.float32)))
    return out


def _make_model(seed=5):
    net = _Lin(*_init(seed))
    model = hapi.Model(net, device="cpu")
    model.prepare(optimizer=Adam(learning_rate=0.01,
                                 parameters=net.parameters()), loss=_mse)
    return model


def test_uninterrupted_fit_matches_jax():
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as jopt

    batches = _make_batches()
    net = jnn.Linear(4, 1)
    w, b = _init(5)
    net.set_state_dict({"weight": w, "bias": b})
    jm = paddle.Model(net)
    jm.prepare(optimizer=jopt.Adam(learning_rate=0.01,
                                   parameters=net.parameters()),
               loss=lambda p, l: jnn.MSELoss()(p, l))

    class JaxTape(paddle.hapi.Callback):
        losses = []

        def on_train_batch_end(self, step, logs=None):
            JaxTape.losses.append(float(logs["loss"][0]))

    jm.fit(batches, epochs=2, verbose=0, callbacks=[JaxTape()])
    tape = _LossTape()
    _make_model().fit(batches, epochs=2, verbose=0, callbacks=[tape])
    assert len(tape.losses) == 16
    np.testing.assert_allclose(tape.losses, JaxTape.losses, rtol=1e-5)


def test_resume_reproduces_uninterrupted_trajectory(tmp_path):
    batches = _make_batches()
    full = _LossTape()
    _make_model().fit(batches, epochs=2, verbose=0, callbacks=[full])
    part1 = _LossTape()
    _make_model().fit(batches, epochs=2, verbose=0, callbacks=[part1],
                      checkpoint_dir=str(tmp_path), checkpoint_freq=1,
                      num_iters=5)
    assert len(part1.losses) == 5
    part2 = _LossTape()
    m2 = _make_model(seed=123)  # a different init must not matter
    ids = [id(p) for p in m2.network.parameters()]
    m2.fit(batches, epochs=2, verbose=0, callbacks=[part2],
           checkpoint_dir=str(tmp_path), resume=True)
    assert len(part2.losses) == 11
    assert ids == [id(p) for p in m2.network.parameters()]
    np.testing.assert_allclose(part1.losses + part2.losses, full.losses,
                               rtol=1e-5)


def test_epoch_boundary_checkpoint_and_resume(tmp_path):
    batches = _make_batches(n=4)
    _make_model().fit(batches, epochs=1, verbose=0,
                      checkpoint_dir=str(tmp_path))
    ck = CheckpointManager(str(tmp_path)).restore()
    assert (ck.meta["epoch"], ck.meta["step_in_epoch"]) == (1, 0)
    tape = _LossTape()
    _make_model(seed=77).fit(batches, epochs=2, verbose=0,
                             checkpoint_dir=str(tmp_path), resume=True,
                             callbacks=[tape])
    assert len(tape.losses) == 4  # only epoch 2 ran


def test_num_iters_stop_still_checkpoints_true_position(tmp_path):
    _make_model().fit(_make_batches(n=8), epochs=2, verbose=0,
                      checkpoint_dir=str(tmp_path), num_iters=3)
    meta = CheckpointManager(str(tmp_path)).restore().meta
    assert (meta["epoch"], meta["step_in_epoch"], meta["global_step"]) \
        == (0, 3, 3)


def test_resume_with_all_generations_corrupt_raises(tmp_path):
    batches = _make_batches(n=4)
    _make_model().fit(batches, epochs=1, verbose=0,
                      checkpoint_dir=str(tmp_path))
    for shard in glob.glob(os.path.join(str(tmp_path), "gen-*",
                                        "shard-*.bin")):
        with open(shard, "r+b") as f:
            f.write(b"\x00garbage\x00")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(CheckpointNotFoundError):
            _make_model().fit(batches, epochs=1, verbose=0,
                              checkpoint_dir=str(tmp_path), resume=True)


def test_in_process_preemption_emergency_checkpoint(tmp_path):
    chaos.install("preempt_at:3")
    tape = _LossTape()
    model = _make_model()
    model.fit(_make_batches(), epochs=2, verbose=0, callbacks=[tape],
              checkpoint_dir=str(tmp_path))
    assert model.preempted and len(tape.losses) == 3
    ck = CheckpointManager(str(tmp_path)).restore()
    assert ck.meta["global_step"] == 3
    assert "model" in ck.value and "optimizer" in ck.value
    assert ck.value["optimizer"]["global_step"] == 3


_TRAIN_SCRIPT = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[3])
from test_torch_resilience import _LossTape, _make_batches, _make_model

ckpt_dir, out_path = sys.argv[1], sys.argv[2]
tape = _LossTape()
model = _make_model()
model.fit(_make_batches(), epochs=2, verbose=0, callbacks=[tape],
          checkpoint_dir=ckpt_dir, resume=True, checkpoint_freq=1)
with open(out_path, "w") as f:
    json.dump({"preempted": bool(model.preempted),
               "n_steps": len(tape.losses), "losses": tape.losses}, f)
"""


def test_kill_and_resume_in_a_fresh_process_matches_uninterrupted(tmp_path):
    """PADDLE_TPU_CHAOS=preempt_at:6 training checkpoints atomically and
    exits cleanly (code 0); a FRESH process resumes to the uninterrupted
    run's trajectory."""
    script = tmp_path / "train.py"
    script.write_text(_TRAIN_SCRIPT)
    oracle = _LossTape()
    _make_model().fit(_make_batches(), epochs=2, verbose=0,
                      callbacks=[oracle])
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("PADDLE_TPU_CHAOS", None)

    def run(out, extra=None):
        return subprocess.run(
            [sys.executable, str(script), ck, str(out),
             os.path.join(REPO, "tests")], capture_output=True, text=True,
            timeout=300, env={**env, **(extra or {})}, cwd=REPO)

    p1 = run(tmp_path / "r1.json", {"PADDLE_TPU_CHAOS": "preempt_at:6"})
    assert p1.returncode == 0, p1.stderr[-2000:]
    r1 = json.loads((tmp_path / "r1.json").read_text())
    assert r1["preempted"] and r1["n_steps"] == 6
    assert CheckpointManager(ck).restore().meta["global_step"] == 6
    p2 = run(tmp_path / "r2.json")
    assert p2.returncode == 0, p2.stderr[-2000:]
    r2 = json.loads((tmp_path / "r2.json").read_text())
    assert not r2["preempted"] and r2["n_steps"] == 10
    np.testing.assert_allclose(r1["losses"] + r2["losses"], oracle.losses,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the data loader's retry seam
# ---------------------------------------------------------------------------

def test_transient_fetch_fault_is_retried():
    class Flaky(Dataset):
        def __init__(self):
            self.fails = 2

        def __len__(self):
            return 8

        def __getitem__(self, i):
            if self.fails:
                self.fails -= 1
                raise IOError("transient storage blip")
            return np.full((2,), i, np.float32)

    slept = []
    dl = DataLoader(Flaky(), batch_size=4, shuffle=False,
                    retry_policy=RetryPolicy(max_attempts=4, jitter=0.0,
                                             sleep=slept.append))
    batches = list(dl)
    assert len(batches) == 2 and isinstance(batches[0], torch.Tensor)
    assert torch.equal(batches[1][:, 0], torch.arange(4.0, 8.0))
    assert dl.retry_policy.stats.retries == 2 and len(slept) == 2


def test_chaos_fetch_seam_is_retried():
    chaos.install("io_error:0.3:dataloader.fetch", seed=4)
    dl = DataLoader([np.float32(i) for i in range(8)], batch_size=4,
                    retry_policy=RetryPolicy(max_attempts=8, jitter=0.0,
                                             sleep=lambda s: None))
    got = torch.cat(list(dl))
    assert torch.equal(got, torch.arange(8.0))
    assert dl.retry_policy.stats.retries > 0
