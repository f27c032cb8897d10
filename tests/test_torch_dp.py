"""The port's data-parallel training (`parallel.mesh`, `DataParallel`,
`make_train_step(mesh=)`, `quantized_psum_tree`, `hapi.Model.fit` over
dp), Paddle's collective API and the sharded checkpoint, against the JAX
package on the CPU.

The port runs one process a rank over gloo (a pool of spawned ranks for
the file, tests/torch_rank_pool.py); JAX runs its single controller over
a dp mesh of the 8-device CPU host (tests/conftest.py). Every rank is
handed the same global batch and trains on its rows. Tolerances:

- DataParallel over two ranks against JAX's serial run of the same MLP
  (SGD, cross entropy): rtol 1e-4, atol 1e-5 (JAX's TestDataParallel);
- `make_train_step(mesh=dp2)` on tiny() in f32 against JAX's dp2 step:
  losses atol 1e-4, params after step 1 within 2 * lr + 1e-6 (Adam's
  first update is about lr * sign(g); tests/test_torch_train.py's bars),
  and both ranks' parameters bitwise equal after every run;
- `quantized_psum_tree` against JAX's on the same leaves: atol 1e-6,
  rtol 1e-6 (the bound of tests/test_torch_collectives.py's
  quantized_psum). Not bitwise, and the sum that differs is named: hop
  2's f32 dequantize-accumulate over the ranks' chunks, which XLA:CPU
  contracts into a fused multiply-add (round(q1 s1 + round(q0 s0))) where
  torch rounds each product and the sum apart; the two differ by one f32
  rounding, and hop 3's re-quantization carries that into the scales;
- fit with the quantized gradient sync against the plain dp fit: each
  loss within 5% (JAX's TestFitQuantizedDP), both ranks bitwise equal;
  the plain dp fit against a one-rank fit of the global batches: losses
  rtol 1e-5;
- the sharded checkpoint: byte-exact both ways (f32 and bf16).
"""
import dataclasses
import os
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.parallel import checkpoint as jckpt
from paddle_tpu.parallel import collectives as jqc
from paddle_tpu.parallel import make_train_step as jax_make_train_step
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel.shard_map_compat import shard_map
from paddle_tpu_torch import hapi
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import params_from_jax
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import (HybridCommunicateGroup, build_mesh,
                                       get_global_mesh, load_state_dict,
                                       make_train_step, set_global_mesh)
from paddle_tpu_torch.parallel.checkpoint import Shard
from paddle_tpu_torch.parallel import env as penv
from torch_rank_pool import (RankPool, ckpt_save_rank, data_parallel_rank,
                             dp_train_rank, facade_rank, fit_dp_rank,
                             fit_audit_rank, psum_tree_rank)

LR = 1e-3


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def _tiny(seed=0):
    paddle.seed(seed)
    jm = JaxModel(JaxConfig.tiny())
    return jm, {k: np.array(v) for k, v in jm.raw_state().items()}


def _batch(b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 128, (b, s)), rng.integers(0, 128, (b, s)))


# ---------------------------------------------------------------------------
# the environment, the mesh and Paddle's collective API
# ---------------------------------------------------------------------------

def test_env_mesh_and_refusals_without_a_group(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert (penv.get_rank(), penv.get_world_size()) == (3, 4)
    assert penv.ParallelEnv().nranks == 4
    mesh = build_mesh({"dp": 1, "mp": 1})
    assert mesh.axis_names == ("dp", "mp") and mesh.size == 1
    hcg = HybridCommunicateGroup(mesh)
    assert hcg.get_data_parallel_world_size() == 1
    assert hcg.topology() == [1, 1]
    # every axis is ported: such a mesh needs its ranks
    for axis in ("mp", "pp", "sep"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            build_mesh({"dp": 1, axis: 2})
    with pytest.raises(ValueError, match="needs 2 ranks"):
        build_mesh({"dp": 2})
    # a sharding strategy without a mesh is JAX's no-op
    step, p, s = make_train_step(torch.nn.Linear(2, 2),
                                 lambda o, y: o.sum(),
                                 strategy={"sharding": {"enable": True}},
                                 device="cpu")
    assert torch.isfinite(step(p, s, torch.ones(2, 2), torch.ones(2))[0])
    from paddle_tpu_torch.parallel.mesh import divisible_prefix

    assert divisible_prefix(jmesh.build_mesh(
        {"dp": 2, "sharding": 4}, devices=jax.devices()[:8]), 4,
        ("dp", "sharding")) == jmesh.divisible_prefix(
        jmesh.build_mesh({"dp": 2, "sharding": 4},
                         devices=jax.devices()[:8]), 4, ("dp", "sharding"))


def test_collective_facade_on_two_ranks(pool):
    outs = pool.run(2, facade_rank)
    xs = [np.arange(4, dtype=np.float32) + 10 * r for r in range(2)]
    for r, o in enumerate(outs):
        assert (o["rank"], o["world"], o["nranks"]) == (r, 2, 2)
        np.testing.assert_array_equal(o["sum"], xs[0] + xs[1])
        np.testing.assert_array_equal(o["max"], np.maximum(*xs))
        np.testing.assert_array_equal(o["avg"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(o["prod"], (xs[0] + 1) * (xs[1] + 1))
        np.testing.assert_array_equal(np.stack(o["gather"]), np.stack(xs))
        assert o["objects"] == [{"r": 0}, {"r": 1}]
        np.testing.assert_array_equal(o["broadcast"], xs[1])
        # all_to_all: entry j came from rank j (its j-th list entry is
        # x_j[:2] + 100 * r)
        for j in range(2):
            np.testing.assert_array_equal(o["a2a"][j], xs[j][:2] + 100 * r)
        np.testing.assert_array_equal(
            o["a2a_single"], np.concatenate([xs[j][2 * r:2 * r + 2]
                                             for j in range(2)]))
        np.testing.assert_array_equal(o["reduce_scatter"],
                                      (xs[0] + xs[1])[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["scatter"], [5.0 + 2 * r] * 2)
        assert o["group"] == (2, r, 1)
    np.testing.assert_array_equal(outs[1]["recv"], [1.0, 2.0, 3.0])


# ---------------------------------------------------------------------------
# DataParallel and make_train_step(mesh=)
# ---------------------------------------------------------------------------

def test_data_parallel_matches_jax_serial(pool):
    """JAX's test_dp_training_matches_serial: two-rank DataParallel
    (each rank 4 of the 8 rows) against the JAX serial run."""
    paddle.seed(11)
    jm = jnn.Sequential(jnn.Linear(8, 8), jnn.Tanh(), jnn.Linear(8, 2))
    ws = [np.array(jm[0].weight.numpy()), np.array(jm[0].bias.numpy()),
          np.array(jm[2].weight.numpy()), np.array(jm[2].bias.numpy())]
    o = jopt.SGD(learning_rate=0.1, parameters=jm.parameters())
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=(8, 8)).astype(np.float32) for _ in range(3)]
    ys = [rng.integers(0, 2, 8) for _ in range(3)]
    for x, y in zip(xs, ys):
        loss = JF.cross_entropy(jm(paddle.to_tensor(x)),
                                paddle.to_tensor(y))
        loss.backward()
        o.step()
        o.clear_grad()
    outs = pool.run(2, data_parallel_rank, ws, xs, ys, 0.1)
    for w, seen in outs:
        np.testing.assert_allclose(w, jm[0].weight.numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert seen["state_dict"] == 4
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    # inside no_sync each rank keeps its own rows' gradient
    assert not np.array_equal(outs[0][1]["no_sync_grad"],
                              outs[1][1]["no_sync_grad"])


def _jax_dp_run(jm, steps, x, y, strategy=None):
    crit = JaxCriterion(jm.config)
    mesh = jmesh.build_mesh({"dp": 2}, devices=jax.devices()[:2])
    step, p, s = jax_make_train_step(jm, lambda lg, lb: crit(lg, lb), mesh,
                                     lr=LR, strategy=strategy)
    losses, first = [], None
    for i in range(steps):
        loss, p, s = step(p, s, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
        if i == 0:
            first = {k: np.array(v, np.float32) for k, v in p.items()}
    return losses, first


@pytest.mark.parametrize("strategy", [None, {"gradient_merge": {
    "enable": True, "k_steps": 2}}], ids=["plain", "gradient_merge"])
def test_make_train_step_dp2_matches_jax(pool, strategy):
    jm, np_params = _tiny(seed=1)
    x, y = _batch(seed=1)
    jl, jfirst = _jax_dp_run(jm, 3, x, y, strategy)
    first = pool.run(2, dp_train_rank, np_params, x, y, 1, LR, strategy,
                     False, True)
    runs = pool.run(2, dp_train_rank, np_params, x, y, 3, LR, strategy)
    np.testing.assert_allclose(runs[0][0], jl, atol=1e-4, rtol=0)
    worst = max(float(np.abs(first[0][1][k] - jfirst[k]).max())
                for k in jfirst)
    assert worst <= 2 * LR + 1e-6, worst
    for run in (first, runs):
        assert run[0][0] == run[1][0]
        for k in run[0][1]:
            np.testing.assert_array_equal(run[0][1][k], run[1][1][k])


def test_make_train_step_dp_refuses_nothing_silently(pool):
    """A batch dp does not divide runs whole on every rank (a warning),
    as JAX replicates it; the ranks stay equal."""
    _, np_params = _tiny(seed=2)
    x, y = _batch(b=3, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs = pool.run(2, dp_train_rank, np_params, x, y, 1, LR)
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])


def test_quantized_psum_tree_matches_jax(pool):
    rng = np.random.default_rng(3)
    shapes = {"w.b": (7,), "a.w": (5, 40), "m": (3, 3, 50)}
    trees = [{k: (rng.normal(size=s) * (1 + r)).astype(np.float32)
              for k, s in shapes.items()} for r in range(2)]
    outs = pool.run(2, psum_tree_rank, trees)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))

    def body(t):
        out = jqc.quantized_psum_tree({k: v[0] for k, v in t.items()},
                                      "dp")
        return {k: v[None] for k, v in out.items()}

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp"),
                           out_specs=P("dp"), check_vma=False))
    want = fn({k: jnp.asarray(np.stack([t[k] for t in trees]))
               for k in shapes})
    for got in outs:
        for k in shapes:
            np.testing.assert_array_equal(got[k], outs[0][k])
            np.testing.assert_allclose(got[k], np.asarray(want[k])[0],
                                       atol=1e-6, rtol=1e-6)
        exact = {k: trees[0][k] + trees[1][k] for k in shapes}
        for k in shapes:
            rel = np.linalg.norm(got[k] - exact[k]) / np.linalg.norm(
                exact[k])
            assert rel < 0.05, (k, rel)


# ---------------------------------------------------------------------------
# hapi.Model.fit over dp
# ---------------------------------------------------------------------------

def _fit_batches(n=3):
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 128, (4, 8)).astype(np.int64),
             rng.normal(size=(4, 8, 128)).astype(np.float32))
            for _ in range(n)]


def test_fit_dp_quantized_within_jax_tolerance_of_plain(pool):
    _, np_params = _tiny(seed=5)
    batches = _fit_batches()
    plain = pool.run(2, fit_dp_rank, np_params, batches, False)
    quant = pool.run(2, fit_dp_rank, np_params, batches, True)
    # a one-rank fit of the same global batches
    net = LlamaForCausalLM(LlamaConfig.tiny()).load_params(
        params_from_jax(np_params, device="cpu"), trainable=True)
    model = hapi.Model(net, device="cpu")
    model.prepare(optimizer=Adam(learning_rate=0.01,
                                 parameters=net.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    from torch_rank_pool import _LossRec

    rec = _LossRec()
    model.fit([(torch.from_numpy(a), torch.from_numpy(b))
               for a, b in batches], epochs=1, verbose=0,
              callbacks=[rec.cb])
    np.testing.assert_allclose(plain[0][0], rec.losses, rtol=1e-5)
    assert [p[1] for p in plain] == [0, 0]
    assert [q[1] for q in quant] == [len(batches)] * 2
    assert plain[0][0] == plain[1][0] and quant[0][0] == quant[1][0]
    for run in (plain, quant):
        for k in run[0][2]:
            np.testing.assert_array_equal(run[0][2][k], run[1][2][k])
    for a, b in zip(plain[0][0], quant[0][0]):
        assert abs(a - b) / max(abs(a), 1e-6) < 0.05, (plain[0][0],
                                                       quant[0][0])


def test_fit_dp_gradient_psum_fires_tpu803(pool):
    audit, _ = pool.run(2, fit_audit_rank, 512, 4)[0]
    assert "fit.step[dp=2]" in audit["target"]
    assert audit["mp"] == 2 and audit["n_collective_sites"] >= 1
    assert set(audit["per_axis"]) == {"dp"}
    ref = (512 * 512 + 512) * 4
    assert abs(audit["float_payload_bytes"] - ref) / ref <= 0.10
    assert "TPU803" in [d["rule"] for d in audit["diagnostics"]]


def test_fit_dp_incompatible_batch_warns_on_fallback(pool):
    audit, caught = pool.run(2, fit_audit_rank, 8, 3)[0]
    assert any("dp gradient psum is NOT counted" in w for w in caught)
    assert audit["n_collectives"] == 0


def test_fit_without_dp_mesh_audits_zero_collectives():
    assert get_global_mesh() is None
    torch.manual_seed(5)
    net = torch.nn.Linear(8, 8)
    model = hapi.Model(net, device="cpu")
    model.prepare(optimizer=Adam(learning_rate=0.01,
                                 parameters=net.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    batch = [(torch.randn(4, 8), torch.randn(4, 8))]
    model.fit(batch, epochs=1, verbose=0)
    assert model.comms_audit is None
    with pytest.warns(UserWarning, match="no gradient sync to quantize"):
        model.fit(batch, epochs=1, verbose=0, audit_comms=True,
                  quantized_collectives=True)
    assert model.comms_audit["n_collectives"] == 0
    assert model.comms_audit["bytes_on_wire"] == 0
    assert model.quantized_dp_steps == 0


# ---------------------------------------------------------------------------
# the sharded checkpoint
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(9)
    return {"w": rng.normal(size=(6, 4)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "h": rng.normal(size=(5, 2)).astype(np.float32),
            "s": np.array(2.5, dtype=np.float32),
            "rows": rng.normal(size=(4, 3)).astype(np.float32)}


def test_port_checkpoint_loads_in_jax_and_reshards(pool, tmp_path):
    arrays = _arrays()
    path = str(tmp_path / "ck")
    files = pool.run(2, ckpt_save_rank, path, arrays, ["h"], "rows")
    assert files[0] == ["0.npz", "1.npz", "meta.0.json", "meta.1.json",
                        "metadata.json"]
    bf16 = jnp.asarray(arrays["h"]).astype(jnp.bfloat16)
    target = {k: jnp.zeros(v.shape, jnp.bfloat16 if k == "h"
                           else jnp.float32) for k, v in arrays.items()}
    jckpt.load_state_dict(target, path)
    for k, v in arrays.items():
        want = np.asarray(bf16) if k == "h" else v
        np.testing.assert_array_equal(np.asarray(target[k]), want)
    # the port loads it at world 1 (reshard 2 -> 1), a Shard target its
    # own block
    mine = {k: torch.zeros(v.shape, dtype=torch.bfloat16 if k == "h"
                           else torch.float32) for k, v in arrays.items()}
    mine["rows"] = Shard(torch.zeros(2, 3), [2, 0], [4, 3])
    load_state_dict(mine, path)
    for k, v in arrays.items():
        got = mine[k].data if k == "rows" else mine[k]
        want = torch.from_numpy(v).to(torch.bfloat16) if k == "h" \
            else torch.from_numpy(v)
        if k == "rows":
            want = want[2:]
        assert torch.equal(got, want), k
    with pytest.raises(ValueError, match="checkpoint shape"):
        load_state_dict({"w": torch.zeros(2, 2)}, path)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    arrays = _arrays()
    path = str(tmp_path / "jck")
    sd = {k: jnp.asarray(v) for k, v in arrays.items()}
    sd["h"] = sd["h"].astype(jnp.bfloat16)
    jckpt.save_state_dict(sd, path)
    mine = {k: torch.zeros(v.shape, dtype=torch.bfloat16 if k == "h"
                           else torch.float32) for k, v in arrays.items()}
    load_state_dict(mine, path)
    for k, v in arrays.items():
        want = torch.from_numpy(v).to(torch.bfloat16) if k == "h" \
            else torch.from_numpy(v)
        assert torch.equal(mine[k], want), k
    # an async save at world 1 writes the same chunks JAX does
    from paddle_tpu_torch.parallel import save_state_dict

    own = str(tmp_path / "own")
    th = save_state_dict({k: mine[k].clone() for k in mine}, own,
                         async_save=True)
    th.join()
    again = {k: torch.zeros_like(v) for k, v in mine.items()}
    load_state_dict(again, own)
    assert all(torch.equal(again[k], mine[k]) for k in mine)
    with open(os.path.join(own, "meta.0.json")) as f:
        assert '"world": 1' in f.read()
