"""The port's ZeRO stages 1-3 over the ``sharding`` mesh axis
(`parallel/sharding.py`, `make_train_step`'s sharding strategy and
`batch_spec`, `group_sharded_parallel`), against the JAX package on the
CPU.

The port runs one process a rank over gloo (a pool of spawned ranks for
the file, tests/torch_rank_pool.py) and every rank holds its blocks; JAX
runs its single controller over the same mesh on the 8-device CPU host
(tests/conftest.py), each JAX reference built once for the module.
Tolerances, on tiny() in f32:

- placements: the port's specs equal JAX's leaf by leaf (the params'
  before the first step, the moments');
- `make_train_step` at stage 1, 2 and 3 against JAX's stage-3 step on
  ``{"sharding": 2}`` (its stages 1 and 2 are one program, and the same
  global computation as stage 3; their layouts are held to JAX's own
  stage-1 layouts): losses atol 1e-4, params after the
  first step within 2 * lr + 1e-6 (Adam's first update is about lr *
  sign(g); tests/test_torch_dp.py's bar), both ranks' gathered params
  bitwise equal after the first and the last step; the first step's
  gradients as the update gets them (gathered) within rtol 1e-5 plus
  1e-5 of the leaf's largest element of those JAX's step on the same
  mesh feeds its update, and the clip's global norm within rtol 1e-5
  (so a sum where a mean belongs, or a reduce-scatter over an axis the
  rows were not split on, fails);
- the eager `group_sharded_parallel` levels against JAX's serial run of
  the same MLP: rtol 1e-4, atol 1e-5 (JAX's TestDataParallel bar);
- the communication audit of a stage-3 step: its bytes on the sharding
  axis equal the hand count exactly.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.models.llama import shard_llama as jax_shard_llama
from paddle_tpu.parallel import make_train_step as jax_make_train_step
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import trainer as jtrainer
from torch_rank_pool import (RankPool, audit_step_rank, eager_sharded_rank,
                             shard_specs_rank, sharded_train_rank,
                             strategy_states_rank)

LR = 1e-3
STEPS = 2
SHARDING2 = {"sharding": 2}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def _pad(spec, ndim):
    spec = tuple(spec or ())
    return (spec + (None,) * ndim)[:ndim]


def _spec(arr):
    """A JAX array's spec padded to its rank (a single-device array's:
    replicated)."""
    return _pad(getattr(arr.sharding, "spec", ()), arr.ndim)


def _batch():
    rng = np.random.default_rng(1)
    return rng.integers(0, 128, (4, 32)), rng.integers(0, 128, (4, 32))


@contextlib.contextmanager
def recording_grads():
    """Record what JAX's own jitted train step feeds its update: inside
    the block its `adamw_update` (looked up when the step is traced) is
    wrapped to hand the gradients (`jax.grad` on the step's mesh) and
    their global norm, the clip's, to the host; `seen[0]` is the first
    step's (gradients, norm). The numbers are the step's own."""
    seen = []
    real = jtrainer.adamw_update

    def record(grads, norm):
        seen.append(({k: np.array(v, np.float32) for k, v in grads.items()},
                     float(norm)))

    def spy(params, grads, state, lr, **kw):
        norm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                            for g in jax.tree.leaves(grads)))
        jax.debug.callback(record, grads, norm)
        return real(params, grads, state, lr, **kw)

    jtrainer.adamw_update = spy
    try:
        yield seen
        jax.effects_barrier()
    finally:
        jtrainer.adamw_update = real


def check_grads(run, ref):
    """A rank's first-step gradients and clip norm against JAX's step's
    (`recording_grads`; module doc): each leaf within rtol 1e-5 plus 1e-5
    of its largest element, the norm within rtol 1e-5."""
    want, norm = ref
    grads, got_norm = run[5], run[6]
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
    np.testing.assert_allclose(got_norm, norm, rtol=1e-5)


def _jax_run(stage=None, shard=False, steps=STEPS):
    """JAX's step on the sharding2 mesh: (losses, params after step 1,
    the params' specs before the first step, the moments' specs, the
    first step's gradients and clip norm); with no steps only the
    layouts (nothing compiles)."""
    paddle.seed(1)
    jm = JaxModel(JaxConfig.tiny())
    np_params = {k: np.array(v) for k, v in jm.raw_state().items()}
    mesh = jmesh.build_mesh(SHARDING2, devices=jax.devices()[:2])
    if shard:
        jax_shard_llama(jm, mesh)
    crit = JaxCriterion(jm.config)
    strategy = {"sharding": {"enable": True, "stage": stage}} if stage \
        else None
    step, p, s = jax_make_train_step(jm, lambda lg, lb: crit(lg, lb), mesh,
                                     lr=LR, strategy=strategy)
    specs = {k: _spec(v) for k, v in p.items()}
    mspecs = {k: _spec(v) for k, v in s.m.items()}
    x, y = _batch()
    losses, first = [], None
    with recording_grads() as seen:
        for i in range(steps):
            loss, p, s = step(p, s, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
            if i == 0:
                first = {k: np.array(v, np.float32) for k, v in p.items()}
    return dict(np_params=np_params, losses=losses, first=first,
                specs=specs, mspecs=mspecs, grads=seen[0] if seen else None)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's stage-3 step on {"sharding": 2}, its stage-1 layouts (stages
    1 and 2 are one JAX program, and one global computation with stage
    3's: their numbers are held to stage 3's), and shard_llama's specs."""
    refs = {3: _jax_run(3)}
    refs[1] = dict(refs[3], mspecs=_jax_run(1, steps=0)["mspecs"])
    refs[2] = refs[1]
    paddle.seed(1)
    jm = JaxModel(JaxConfig.tiny())
    mesh = jmesh.build_mesh(SHARDING2, devices=jax.devices()[:2])
    jax_shard_llama(jm, mesh)
    refs["shard_llama"] = {k: _spec(v) for k, v in jm.raw_state().items()}
    return refs


def _check_ranks(runs, ref):
    """Losses, first-step params and bitwise-equal ranks (module doc)."""
    np.testing.assert_allclose(runs[0][0], ref["losses"], atol=1e-4, rtol=0)
    worst = max(float(np.abs(runs[0][1][k] - ref["first"][k]).max())
                for k in ref["first"])
    assert worst <= 2 * LR + 1e-6, worst
    for r in runs[1:]:
        assert r[0] == runs[0][0]
        for which in (1, 2):
            for k in runs[0][which]:
                np.testing.assert_array_equal(r[which][k], runs[0][which][k])


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_make_train_step_zero_stage_matches_jax(pool, jax_refs, stage):
    ref = jax_refs[stage]
    x, y = _batch()
    runs = pool.run(2, sharded_train_rank, ref["np_params"], x, y, STEPS,
                    LR, SHARDING2,
                    {"sharding": {"enable": True, "stage": stage}})
    _check_ranks(runs, ref)
    for r in runs:
        check_grads(r, ref["grads"])
    specs, sspecs = runs[0][3], runs[0][4]
    for k, want in ref["mspecs"].items():
        assert _pad(sspecs[k], len(want)) == want, (k, sspecs[k], want)
    if stage == 3:
        for k, want in ref["specs"].items():
            assert _pad(specs[k], len(want)) == want, (k, specs[k], want)
    else:
        assert all(s is None for s in specs.values())


def test_shard_llama_bench_route_matches_jax(pool, jax_refs):
    """bench.py main()'s route: shard_llama over {"sharding": 2}, no
    strategy (the state follows the params: JAX's zeros_like)."""
    ref = jax_refs[3]
    x, y = _batch()
    runs = pool.run(2, sharded_train_rank, ref["np_params"], x, y, STEPS,
                    LR, SHARDING2, None, True)
    _check_ranks(runs, ref)
    for k, want in jax_refs["shard_llama"].items():
        assert _pad(runs[0][3][k], len(want)) == want, k
        assert _pad(runs[0][4][k], len(want)) == want, k
    got = pool.run(2, shard_specs_rank, ref["np_params"], SHARDING2)
    assert got[0][("llama.embed_tokens.weight")] == (("sharding", None),
                                                     (64, 64))


def test_gradient_merge_and_batch_spec_under_zero(pool, jax_refs):
    """Gradient merge at stage 2 sums once over the axis (JAX's scan
    over micro-batches); batch_spec=(("dp",),) keeps the rows whole on
    the sharding ranks, whose gradients are then their own."""
    ref = jax_refs[1]
    x, y = _batch()
    gm = pool.run(2, sharded_train_rank, ref["np_params"], x, y, STEPS, LR,
                  SHARDING2, {"sharding": {"enable": True, "stage": 2},
                              "gradient_merge": {"enable": True,
                                                 "k_steps": 2}})
    np.testing.assert_allclose(gm[0][0], ref["losses"], atol=1e-4, rtol=0)
    whole = pool.run(2, sharded_train_rank, ref["np_params"], x, y, STEPS,
                     LR, SHARDING2, {"sharding": {"enable": True,
                                                  "stage": 1}},
                     False, None, False, (("dp",),))
    _check_ranks(whole, ref)
    # at stage 3 a gathered weight's gradient is then sliced, not
    # reduce-scattered (each rank's is the whole batch's already)
    whole3 = pool.run(2, sharded_train_rank, ref["np_params"], x, y, 1, LR,
                      SHARDING2, {"sharding": {"enable": True, "stage": 3}},
                      False, None, False, (("dp",),))
    for r in whole3:
        check_grads(r, ref["grads"])


def test_sharding_strategy_shards_states(pool):
    """JAX's test_fused_optimizer.py::test_sharding_strategy_shards_states
    on {"dp": 1, "sharding": 2}: the accumulators of the params whose dim
    0 the axis divides are Shard(0), as JAX lays them out."""
    from paddle_tpu.parallel import set_global_mesh

    paddle.seed(4)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    ws = [np.array(jm[0].weight.numpy()), np.array(jm[0].bias.numpy()),
          np.array(jm[2].weight.numpy()), np.array(jm[2].bias.numpy())]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    y = rng.integers(0, 4, 8)
    mesh = jmesh.build_mesh({"dp": 1, "sharding": 2},
                            devices=jax.devices()[:2])
    set_global_mesh(mesh)
    try:
        o = jopt.Adam(learning_rate=0.01, parameters=jm.parameters())
        loss_fn = jnn.CrossEntropyLoss()
        step, params, state = jax_make_train_step(
            jm, lambda out, yb: loss_fn(out, yb), mesh=mesh, optimizer=o,
            strategy={"sharding": {"enable": True, "stage": 1,
                                   "axis": "sharding"}},
            batch_spec=(("dp",),))
        jax_sharded = sorted(
            k for k, st in state["acc"].items() if any(
                a.sharding.spec and a.sharding.spec[0] == "sharding"
                for a in st.values()))
        jloss, _, _ = step(params, state, jnp.asarray(x), jnp.asarray(y))
    finally:
        set_global_mesh(None)
    # JAX keys its state by its own parameter names: compare the counts
    # and the loss (the port's keys are the structural ones)
    outs = pool.run(2, strategy_states_rank, ws, x, y)
    for sharded, loss in outs:
        assert sharded == ["0.bias", "0.weight", "2.bias", "2.weight"]
        assert len(sharded) == len(jax_sharded)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_group_sharded_levels_match_jax_serial(pool, level, tmp_path):
    """JAX's TestSharding levels, eagerly: two ranks each feeding half the
    rows of each batch against JAX's serial AdamW run of the same MLP;
    `save_group_sharded_model` writes the gathered weights and the
    gathered optimizer state (the sharded optimizer's state_dict). At
    p_g_os no weight gathered for the forward is alive between the
    forward and the backward."""
    from paddle_tpu_torch.framework.io import load

    paddle.seed(3)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 16))
    ws = [np.array(jm[0].weight.numpy()), np.array(jm[0].bias.numpy()),
          np.array(jm[2].weight.numpy()), np.array(jm[2].bias.numpy())]
    o = jopt.AdamW(learning_rate=0.01, parameters=jm.parameters())
    rng = np.random.default_rng(6)
    xs = [rng.uniform(-1, 1, (8, 16)).astype(np.float32) for _ in range(3)]
    losses = []
    for x in xs:
        loss = (jm(paddle.to_tensor(x)) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    path = str(tmp_path / "gs")
    outs = pool.run(2, eager_sharded_rank, ws, xs, level, 0.01, path)
    for w, spec, state_specs, _, (made, alive) in outs:
        # p_g_os gathers the four weights for the forward and keeps none
        # of them for the backward (it gathers them again there)
        assert made == (4 if level == "p_g_os" else 0)
        assert alive == 0
        np.testing.assert_allclose(w, jm[0].weight.numpy(), rtol=1e-4,
                                   atol=1e-5)
        # p_g_os lays the weight [out, in] out Shard(0); os / os_g keep it
        # whole and shard its moments
        if level == "p_g_os":
            assert spec == ("sharding", None)
        else:
            assert spec is None
        assert state_specs["moment1"] == ("sharding", None)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    full = [(a + b) / 2 for a, b in zip(outs[0][3], outs[1][3])]
    np.testing.assert_allclose(full, losses, rtol=1e-4, atol=1e-5)
    saved = load(path + ".pdparams")
    np.testing.assert_array_equal(np.asarray(saved["0.weight"]).T,
                                  outs[0][0])
    opt = load(path + ".pdopt")
    assert tuple(np.shape(opt["param_0_moment1"])) == (32, 16)
    assert int(opt["global_step"]) == len(xs)


def test_stage3_comms_audit_is_the_hand_count(pool, jax_refs):
    """A stage-3 step's loss and gradients traced: every weight gathered
    once forward, each projection gathered again in its backward (the
    gathered copy is not kept), every gradient reduce-scattered; at n = 2
    each moves half its full bytes a rank."""
    per_axis, per_kind, events = pool.run(
        2, audit_step_rank, jax_refs[3]["np_params"], SHARDING2,
        {"sharding": {"enable": True, "stage": 3}})[0]
    shapes = {k: v.shape for k, v in jax_refs[3]["np_params"].items()}
    half = {k: int(np.prod(s)) * 4 // 2 for k, s in shapes.items()}
    linear = sum(b for k, b in half.items()
                 if "proj" in k or "lm_head" in k)
    other = sum(half.values()) - linear
    gathers = 2 * linear + other
    scatters = sum(half.values())
    assert per_kind == {"all_gather": gathers, "reduce_scatter": scatters}
    assert per_axis == {"sharding": gathers + scatters}
    assert all(e[1] == ("sharding",) for e in events)
