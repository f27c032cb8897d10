"""The port's tensor-parallel training over the ``mp`` mesh axis, alone
and with ZeRO's ``sharding`` (`shard_llama`, the training forward at a
rank's heads, `parallel/mpu.py`), the semi-auto API over a rank's blocks
(`parallel/placement.py`, `api.py`, `spmd_rules.py`), `make_eval_step`
and the checkpoint of sharded state, against the JAX package on the CPU.

The port runs one process a rank over gloo (a pool of four spawned ranks
for the file, tests/torch_rank_pool.py); JAX runs its single controller
over the same mesh on the 8-device CPU host (tests/conftest.py), each JAX
reference built once for the module. Tolerances, on tiny() in f32:

- placements: `shard_llama`'s specs equal JAX's leaf by leaf at
  sharding2, mp2 and sharding2 x mp2;
- `make_train_step` at mp2, sharding2 x mp2 (four ranks), at mp2 with
  one kv head (the k / v gather), losses atol 1e-4 of JAX's step on the
  same mesh, and at dp2 x sharding2 (bench.py's route with dp: the batch
  group) of JAX's four-device sharding2 x mp2 step; params after the
  first step within 2 * lr + 1e-6, every rank's gathered params bitwise
  equal; every rank's first-step gradients (gathered) and clip norm
  against those of JAX's step on the same mesh, as
  tests/test_torch_zero.py holds them (rtol 1e-5);
- the spmd rules: equal to JAX's outputs, case by case;
- the mpu layers and `shard_tensor` / `reshard`: rtol 1e-4, atol 1e-5 of
  JAX's layers fed the same weights (JAX's TestTPLayers bars); the
  parallel cross entropy and its gradient rtol 1e-5;
- `make_eval_step` over sharding2 x mp2: the global logits atol 1e-5 of
  one process's;
- the communication audit of an mp2 step: the bytes on the mp axis equal
  the hand count of the f / g all-reduces and the gathers exactly;
- the checkpoint: a sharding2 x mp2 save loads byte-identical to the
  gathered params in JAX's loader, at world 1 and on two dp ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.models.llama import shard_llama as jax_shard_llama
from paddle_tpu.parallel import checkpoint as jckpt
from paddle_tpu.parallel import make_train_step as jax_make_train_step
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import spmd_rules as jrules
from paddle_tpu_torch.parallel import spmd_rules as prules
from test_torch_zero import check_grads, recording_grads
from torch_rank_pool import (RankPool, audit_step_rank, eval_rank,
                             load_dp_rank, save_sharded_rank,
                             shard_specs_rank, shard_tensor_rank,
                             sharded_train_rank, spmd_apply_rank,
                             tp_layers_rank)

LR = 1e-3
STEPS = 2
MESHES = {"sharding2": {"sharding": 2}, "mp2": {"mp": 2},
          "sharding2xmp2": {"sharding": 2, "mp": 2}}
# the batch group: rows over dp x sharding, gradients reduce-scattered
# over sharding and all-reduced over dp
DP_SHARDING = {"dp": 2, "sharding": 2}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _world(shape):
    return int(np.prod(list(shape.values())))


def _spec(arr):
    spec = tuple(getattr(arr.sharding, "spec", ()))
    return (spec + (None,) * arr.ndim)[:arr.ndim]


def _pad(spec, ndim):
    spec = tuple(spec or ())
    return (spec + (None,) * ndim)[:ndim]


def _batch():
    rng = np.random.default_rng(1)
    return rng.integers(0, 128, (4, 32)), rng.integers(0, 128, (4, 32))


def _jax_model(cfg_kw=None):
    paddle.seed(1)
    jm = JaxModel(JaxConfig.tiny(**(cfg_kw or {})))
    return jm, {k: np.array(v) for k, v in jm.raw_state().items()}


def _jax_run(shape, cfg_kw=None):
    """JAX's step after shard_llama over `shape`: (np params, losses,
    params after step 1, the first step's gradients and clip norm)."""
    jm, np_params = _jax_model(cfg_kw)
    mesh = jmesh.build_mesh(shape, devices=jax.devices()[:_world(shape)])
    jax_shard_llama(jm, mesh)
    crit = JaxCriterion(jm.config)
    step, p, s = jax_make_train_step(jm, lambda lg, lb: crit(lg, lb), mesh,
                                     lr=LR)
    x, y = _batch()
    losses, first = [], None
    with recording_grads() as seen:
        for i in range(STEPS):
            loss, p, s = step(p, s, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
            if i == 0:
                first = {k: np.array(v, np.float32) for k, v in p.items()}
    return np_params, losses, first, seen[0]


@pytest.fixture(scope="module")
def jax_runs():
    return {"mp2": _jax_run(MESHES["mp2"]),
            "sharding2xmp2": _jax_run(MESHES["sharding2xmp2"]),
            "mp2-kv1": _jax_run(MESHES["mp2"], {"num_key_value_heads": 1})}


# ---------------------------------------------------------------------------
# shard_llama and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_llama_placements_match_jax(pool, mesh):
    shape = MESHES[mesh]
    jm, np_params = _jax_model()
    jax_shard_llama(jm, jmesh.build_mesh(
        shape, devices=jax.devices()[:_world(shape)]))
    want = {k: _spec(v) for k, v in jm.raw_state().items()}
    got = pool.run(_world(shape), shard_specs_rank, np_params, shape)
    for rank_specs in got:
        for k, w in want.items():
            spec, block = rank_specs[k]
            assert _pad(spec, len(w)) == w, (k, spec, w)
            full = np_params[k].shape
            n = [int(np.prod([shape.get(a, 1) for a in
                              ((e,) if isinstance(e, str) else e or ())]))
                 for e in w]
            assert block == tuple(d // m for d, m in zip(full, n)), k


@pytest.mark.parametrize("run", ["mp2", "sharding2xmp2", "mp2-kv1",
                                 "dp2xsharding2"])
def test_make_train_step_tp_matches_jax(pool, jax_runs, run):
    # dp2 x sharding2 is held to JAX's four-device sharding2 x mp2 step:
    # one global computation, laid out otherwise
    np_params, losses, first, grads = jax_runs[
        "sharding2xmp2" if run == "dp2xsharding2" else run]
    shape = DP_SHARDING if run == "dp2xsharding2" \
        else MESHES[run.split("-")[0]]
    cfg_kw = {"num_key_value_heads": 1} if run.endswith("kv1") else None
    x, y = _batch()
    runs = pool.run(_world(shape), sharded_train_rank, np_params, x, y,
                    STEPS, LR, shape, None, True, cfg_kw)
    np.testing.assert_allclose(runs[0][0], losses, atol=1e-4, rtol=0)
    worst = max(float(np.abs(runs[0][1][k] - first[k]).max())
                for k in first)
    assert worst <= 2 * LR + 1e-6, worst
    for r in runs:
        check_grads(r, grads)
    for r in runs[1:]:
        assert r[0] == runs[0][0]
        for which in (1, 2):
            for k in runs[0][which]:
                np.testing.assert_array_equal(r[which][k], runs[0][which][k])


def test_make_eval_step_returns_the_global_logits(pool, jax_runs):
    np_params = jax_runs["mp2"][0]
    x, _ = _batch()
    one = pool.run(1, eval_rank, np_params, x, {"dp": 1})[0]
    outs = pool.run(4, eval_rank, np_params, x, MESHES["sharding2xmp2"])
    for got in outs:
        assert got.shape == (4, 32, 128)
        np.testing.assert_allclose(got, one, atol=1e-5, rtol=0)


def test_mp2_comms_audit_is_the_hand_count(pool, jax_runs):
    """An mp2 step's loss and gradients traced: forward, the embedding's
    columns and the logits' vocab gathered (half their bytes a rank) and
    g's all-reduce after o and down; backward, f's all-reduce before
    q / k / v, gate / up and the lm head (at n = 2 an all-reduce moves
    its operand's bytes a rank)."""
    per_axis, per_kind, events = pool.run(
        2, audit_step_rank, jax_runs["mp2"][0], MESHES["mp2"], None,
        True)[0]
    b, s, h, v, L = 4, 16, 64, 128, 2
    act = b * s * h * 4
    gathers = act // 2 + b * s * v * 4 // 2
    psum = 2 * L * act + (2 * L + 1) * act
    assert per_kind == {"all_gather": gathers, "psum": psum}
    assert per_axis == {"mp": gathers + psum}


# ---------------------------------------------------------------------------
# the checkpoint of sharded state
# ---------------------------------------------------------------------------

def test_sharded_save_loads_in_jax_at_world_1_and_on_dp2(pool, jax_runs,
                                                       tmp_path):
    import torch

    from paddle_tpu_torch.parallel import load_state_dict

    np_params = jax_runs["mp2"][0]
    path = str(tmp_path / "ck")
    gathered = pool.run(4, save_sharded_rank, np_params, path,
                        MESHES["sharding2xmp2"])
    for g in gathered[1:]:
        for k in g:
            np.testing.assert_array_equal(g[k], gathered[0][k])
    want = gathered[0]
    target = {k: jnp.zeros(v.shape, jnp.float32) for k, v in want.items()}
    jckpt.load_state_dict(target, path)
    mine = {k: torch.zeros(v.shape) for k, v in want.items()}
    load_state_dict(mine, path)
    on_dp = pool.run(2, load_dp_rank, {k: v.shape for k, v in want.items()},
                     path)
    for k, v in want.items():
        assert np.asarray(target[k]).tobytes() == v.tobytes(), k
        assert mine[k].numpy().tobytes() == v.tobytes(), k
        for r in on_dp:
            assert r[k].tobytes() == v.tobytes(), k
        np.testing.assert_array_equal(v, np_params[k])


# ---------------------------------------------------------------------------
# the semi-auto API and the mpu layers
# ---------------------------------------------------------------------------

def test_shard_tensor_reshard_and_layers_match_jax(pool):
    """JAX's TestShardTensor on the port's {"dp": 2, "mp": 2} blocks."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (8, 8)).astype(np.float32)
    a = rng.uniform(-1, 1, (8, 16)).astype(np.float32)
    b = rng.uniform(-1, 1, (16, 8)).astype(np.float32)
    mesh = jdist.build_mesh({"dp": 2, "mp": 2}, devices=jax.devices()[:4])
    d = jdist.shard_tensor(paddle.to_tensor(x), mesh, [jdist.Shard(0)])
    jpl = [repr(p) for p in jdist.get_placements(d, mesh)]
    y = jdist.reshard(d, mesh, [jdist.Replicate(), jdist.Shard(1)])
    jpl_y = [repr(p) for p in jdist.get_placements(y, mesh)]
    jmm = paddle.matmul(
        jdist.shard_tensor(paddle.to_tensor(a), mesh, [jdist.Shard(0)]),
        jdist.shard_tensor(paddle.to_tensor(b), mesh,
                           [jdist.Replicate(), jdist.Shard(1)])).numpy()
    for o in pool.run(4, shard_tensor_rank, x, a, b):
        assert o["shape"] == ((8, 8), (4, 8))
        assert o["placements"] == jpl
        assert o["reshard_placements"] == jpl_y
        np.testing.assert_array_equal(o["unshard"], x)
        np.testing.assert_array_equal(o["reshard"], y.numpy())
        np.testing.assert_array_equal(o["p_to_r"], x)
        np.testing.assert_array_equal(o["p_to_s"], x)
        assert o["layer"] and o["grad_shape"] == (4, 8)
        np.testing.assert_allclose(o["matmul"], jmm, rtol=1e-4, atol=1e-5)
    pm = jdist.ProcessMesh([[0, 1], [2, 3]], dim_names=["x", "y"])
    from paddle_tpu_torch.parallel import ProcessMesh

    mine = ProcessMesh([[0, 1], [2, 3]], dim_names=["x", "y"])
    assert (mine.shape, mine.dim_names, mine.ndim) == (pm.shape,
                                                       pm.dim_names, pm.ndim)


def _jax_layer_out(case, weights, x, extra=None):
    """JAX's mpu layer on {"mp": 2}, fed the port's global weights."""
    mesh = jdist.build_mesh({"mp": 2}, devices=jax.devices()[:2])
    jdist.set_global_mesh(mesh)
    try:
        def put(param, value):
            sh = param._array.sharding
            if not isinstance(sh, NamedSharding):
                sh = NamedSharding(mesh, PartitionSpec())
            param._array = jax.device_put(jnp.asarray(value), sh)

        if case == "column":
            layer = jdist.mpu.ColumnParallelLinear(8, 16, gather_output=True)
        elif case == "row":
            layer = jdist.mpu.RowParallelLinear(16, 8,
                                                input_is_parallel=False)
        elif case == "vocab":
            layer = jdist.mpu.VocabParallelEmbedding(16, 8)
        elif case == "ce":
            ce = jdist.mpu.ParallelCrossEntropy()
            lg = paddle.to_tensor(x)
            lg.stop_gradient = False
            loss = ce(lg, paddle.to_tensor(extra))
            loss.sum().backward()
            return lg.grad.numpy(), loss.numpy()
        else:
            col = jdist.mpu.ColumnParallelLinear(8, 16, gather_output=False)
            row = jdist.mpu.RowParallelLinear(16, 8, input_is_parallel=True)
            for p, v in zip((col.weight, col.bias, row.weight, row.bias),
                            weights):
                put(p, v)
            out = row(JF.relu(col(paddle.to_tensor(x))))
            (out * out).sum().backward()
            return [col.weight.grad.numpy(), row.weight.grad.numpy()], \
                out.numpy()
        put(layer.weight, weights[0])
        if weights[1] is not None:
            put(layer.bias, weights[1])
        return None, layer(paddle.to_tensor(x)).numpy()
    finally:
        jdist.set_global_mesh(None)


@pytest.mark.parametrize("case", ["column", "row", "vocab", "ce",
                                  "mlp_grad"])
def test_tp_layers_match_jax(pool, case):
    rng = np.random.default_rng(7)
    extra = None
    if case in ("column", "mlp_grad"):
        x = rng.uniform(-1, 1, (4, 8)).astype(np.float32)
    elif case == "row":
        x = rng.uniform(-1, 1, (4, 16)).astype(np.float32)
    elif case == "vocab":
        x = np.array([0, 5, 15])
    else:
        x = rng.uniform(-1, 1, (4, 10)).astype(np.float32)
        extra = np.array([1, 2, 3, -100])
    outs = pool.run(2, tp_layers_rank, case, x, extra)
    # the ranks hold the same global weights (broadcast at construction)
    weights, grads, _ = outs[0]
    if case == "ce":
        jgrad, jout = _jax_layer_out(case, None, x, extra)
        got = np.concatenate([o[1] for o in outs], axis=-1)
        np.testing.assert_allclose(got, jgrad, rtol=1e-5, atol=1e-7)
        assert jout[3, 0] == 0.0
        tol = dict(rtol=1e-5)
    elif case == "mlp_grad":
        jgrads, jout = _jax_layer_out(case, weights, x)
        for o in outs:
            for g, jg in zip(o[1], jgrads):
                np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-5)
        tol = dict(rtol=1e-4, atol=1e-5)
    else:
        _, jout = _jax_layer_out(case, (weights, grads), x)
        tol = dict(rtol=1e-4, atol=1e-5)
    for o in outs:
        np.testing.assert_allclose(o[2], jout, **tol)


# ---------------------------------------------------------------------------
# the spmd rules: the port's against JAX's, case by case
# ---------------------------------------------------------------------------

_QKV = (((("dp",), None, "mp", None), (2, 128, 8, 64)),
        ((None, "sep", None, None), (2, 128, 8, 64)),
        ((None, None, None, None), (2, 128, 8, 64)))
FORWARD_CASES = [
    ("matmul", [((("dp",), None), (8, 16)), ((None, "mp"), (16, 32))], {}),
    ("matmul", [((None, "mp"), (8, 16)), (("mp", None), (16, 32))], {}),
    ("matmul", [((None, "mp"), (8, 16)), ((None, None), (16, 32))], {}),
    ("matmul", [((("dp",), None, None), (4, 8, 16)),
                ((("mp",), None), (32, 16))], {"trans_y": True}),
    ("elementwise", [((("dp",), "mp"), (8, 16)), ((None,), (16,))], {}),
    ("embedding", [((("dp",), None), (8, 32)), ((("mp",), None), (128, 64))],
     {}),
    ("embedding", [((("dp",), None), (8, 32)), ((None, "mp"), (128, 64))],
     {}),
    ("layer_norm", [((("dp",), "sep", "mp"), (8, 32, 64)), ((None,), (64,)),
                    ((None,), (64,))], {}),
    ("reduction", [((("dp",), "mp"), (8, 16))], {"axis": 1}),
    ("reduction", [((("dp",), "mp"), (8, 16))], {"axis": 1,
                                                  "keepdim": True}),
    ("softmax", [((("dp",), "mp"), (8, 16))], {"axis": -1}),
    ("transpose", [((("dp",), None, "mp"), (4, 8, 16))],
     {"perm": (2, 0, 1)}),
    ("reshape", [((("dp",), "mp"), (8, 32))], {"shape": (8, 4, 8)}),
    ("reshape", [((("dp",), "mp", None), (8, 4, 8))], {"shape": (8, -1)}),
    ("flash_attention", list(_QKV), {}),
    ("concat", [((("dp",), "mp"), (4, 8)), ((None, "mp"), (4, 8))],
     {"axis": 0}),
    ("split", [((("dp",), "mp"), (8, 16))], {"num_or_sections": 2,
                                              "axis": 1}),
    ("my_op_absent", None, None),
]
BACKWARD_CASES = [
    ("matmul", [(None, (64, 32)), (None, (32, 48))], {"out": ("mp", "dp")}),
    ("matmul", [(("dp", "mp"), (64, 32)), (("mp", None), (32, 48))],
     {"out": (None, None)}),
    ("matmul", [(None, (1, 64, 32)), (None, (512, 48, 32, 48))],
     {"out": ("mp", "dp", None, None)}),
    ("matmul", [(None, (8, 16)), (None, (32, 16))],
     {"out": (None, "mp"), "trans_y": True}),
    ("embedding", [(None, (4, 1024)), (None, (512, 768))],
     {"out": ("dp", None, "mp")}),
    ("layer_norm", [(None, (8, 16, 32)), (None, (32,))],
     {"out": ("dp", "sep", None), "begin_norm_axis": 2}),
    ("reduction", [(None, (8, 16, 32))], {"out": ("dp", None), "axis": 1}),
    ("reduction", [(None, (8, 16, 32))], {"out": ("dp", None, "mp"),
                                          "axis": 1, "keepdim": True}),
    ("softmax", [(None, (4, 8, 32))], {"out": ("dp", None, "mp"),
                                       "axis": -1}),
    ("transpose", [(None, (4, 8, 16))], {"out": ("mp", None, "dp"),
                                         "perm": (2, 0, 1)}),
    ("reshape", [(None, (4, 8, 16))], {"out": ("dp", "mp"),
                                       "shape": (32, 16)}),
    ("flash_attention", [(None, (2, 128, 16, 64))] * 3,
     {"out": ("dp", "sep", "mp", None)}),
    ("split", [(None, (8, 32))], {"out": [("dp", None), ("dp", None)],
                                  "num_or_sections": 2, "axis": 1}),
    ("elementwise", [(None, (8, 16)), (None, (16,))], {"out": ("dp", "mp")}),
    ("gather", [(None, (4,))], {"out": (None,)}),
]


def _both(module, name, inputs, attrs, backward):
    try:
        rule = module.get_spmd_rule(name)
        fn = rule.infer_backward if backward else rule.infer_forward
        return "ok", fn(*inputs, **attrs)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, None


@pytest.mark.parametrize("case", range(len(FORWARD_CASES)))
def test_spmd_forward_rules_match_jax(case):
    name, inputs, attrs = FORWARD_CASES[case]
    got = _both(prules, name, inputs or [], attrs or {}, False)
    assert got == _both(jrules, name, inputs or [], attrs or {}, False)


@pytest.mark.parametrize("case", range(len(BACKWARD_CASES)))
def test_spmd_reverse_rules_match_jax(case):
    name, inputs, attrs = BACKWARD_CASES[case]
    got = _both(prules, name, inputs, attrs, True)
    assert got == _both(jrules, name, inputs, attrs, True)


def test_spmd_registry_and_application(pool):
    """register_spmd_rule, and the application helpers laying a rank's
    blocks out (JAX's TestApplication / TestApplyBackwardConstraint
    specs)."""
    @prules.register_spmd_rule("my_op")
    def rule(x):
        return [x[0]], x[0], ()

    _, out, _ = prules.get_spmd_rule("my_op").infer_forward(
        ((("dp",),), (4,)))
    assert out == (("dp",),)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    w = rng.normal(size=(16, 32)).astype(np.float32)
    jmesh_ = jmesh.build_mesh((2, 4), ("dp", "mp"))
    jw = paddle.to_tensor(np.zeros((16, 32), np.float32))
    jx = paddle.to_tensor(np.zeros((8, 16), np.float32))
    jspecs = jrules.apply_backward_constraint("matmul", ("dp", "mp"), jx,
                                              jw, mesh=jmesh_)
    for got in pool.run(4, spmd_apply_rank, x, w):
        assert got["matmul_spec"] == ("dp", "mp")
        np.testing.assert_allclose(got["matmul"], x @ w, rtol=1e-5,
                                   atol=1e-5)
        assert got["params"] == {"0.weight": ("mp", None),
                                 "0.bias": (None,),
                                 "2.weight": (None, "mp"),
                                 "2.bias": (None,)}
        assert got["backward"] == jspecs
        assert got["backward_block"] == (16, 16)
