"""The port's pipeline parallelism over the ``pp`` mesh axis
(`parallel/pipeline_spmd.py`, `models/llama_pipe.py`, `parallel/pipeline.py`,
`parallel/pipeline_viz.py`, `parallel/passes/`, the ``ppermute`` hop)
against the JAX package on the CPU.

The port runs one process a rank over gloo (a pool of eight spawned
ranks for the file, tests/torch_rank_pool.py); JAX runs its single
controller over the same mesh on the 8-device CPU host
(tests/conftest.py), each JAX reference built once for the module.
Tolerances, in f32:

- the schedule primitives on JAX's toy tanh stages (tests/test_pipeline.py:
  S 4, M 4, mb 2, d 8): against JAX's own pipeline_forward,
  pipeline_1f1b, pipeline_zb1f1b, pipeline_eager_1f1b and
  pipeline_vpp_forward on the same inputs, the loss rtol 1e-6 and the
  gradients atol 1e-6 (JAX's own bars against its serial run);
- the Llama pp step (tiny(), batch 8 x 32, n_micro 4, 2 steps) at every
  schedule on {"pp": 2}, and 1F1B on {"dp": 2, "pp": 2}, {"dp": 2,
  "pp": 2, "mp": 2} and {"pp": 4} (4 layers), against JAX's FThenB step on the same mesh (its
  1F1B-family Llama steps raise under jax 0.9.0's custom-VJP type check;
  FThenB computes the same loss and gradients): losses rtol 1e-5, every
  rank's first-step gradients (gathered over pp and mp) and clip norm
  through `check_grads` (rtol 1e-5), the outer params bitwise equal over
  pp after every step; VPP at tiny(num_hidden_layers=4) against JAX's
  VPP step;
- the cooperative head's loss and gradients against the plain head's
  (rtol 1e-6, gradients within 1e-5 of each leaf's largest element);
- split / chunk / merge of the stage params equal to JAX's, key by key,
  value by value; the timeline, its stats, rendering and chrome trace
  equal to JAX's for every schedule; the passes' configs equal to JAX's
  and driving the step bitwise as the explicit arguments do;
- `pipeline_apply` and `PipelineParallel.train_batch` against
  tests/test_distributed.py::TestPipeline's cases (rtol 1e-5);
- `make_train_step` on {"pp": 2} replicates the step over pp, as JAX's
  does (losses atol 1e-4 of JAX's step on that mesh);
- the communication audit of a pp rank's step: its pp bytes equal the
  hand count (the boundary hops, the cooperative head's reductions, the
  head and input gradients) exactly;
- the errors JAX raises.
"""
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.models import llama_pipe as jpipe
from paddle_tpu.parallel import make_train_step as jax_make_train_step
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import passes as jpasses
from paddle_tpu.parallel.passes import pipeline_scheduler_pass as jsched
from paddle_tpu.parallel import pipeline_spmd as jspmd
from paddle_tpu.parallel import pipeline_viz as jviz
from paddle_tpu_torch.models import LlamaConfig, llama_pipe
from paddle_tpu_torch.parallel import passes as ppasses
from paddle_tpu_torch.parallel import pipeline_viz as pviz
from paddle_tpu_torch.parallel.passes import pipeline_scheduler_pass \
    as psched
from test_torch_zero import check_grads
from torch_rank_pool import (RankPool, coop_errors_rank, mesh_pp_rank,
                             pipeline_apply_rank, ppermute_rank,
                             pp_audit_rank,
                             pp_errors_rank, pp_train_rank,
                             sharded_train_rank, toy_pipeline_rank)

LR = 1e-3
STEPS = 2
N_MICRO = 4
SCHEDULES = ("1F1B", "FThenB", "ZBH1", "Eager1F1B")


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _clear_mesh():
    yield
    jmesh.set_global_mesh(None)


def _batch():
    rng = np.random.default_rng(1)
    return rng.integers(0, 128, (8, 32)), rng.integers(0, 128, (8, 32))


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jmesh.build_mesh(shape, devices=jax.devices()[:n])


def _jax_pp_run(shape, schedule="FThenB", cfg_kw=None, **kw):
    """JAX's pp step on `shape`: (np params, losses, the first step's
    gradients ("outer/<k>", "stages/<k>") and clip norm as its update
    gets them)."""
    paddle.seed(1)
    jm = JaxModel(JaxConfig.tiny(**(cfg_kw or {})))
    np_params = {k: np.array(v) for k, v in jm.raw_state().items()}
    step, p, s = jpipe.make_llama_pp_train_step(
        jm, _jmesh(shape), n_micro=N_MICRO, lr=LR, schedule=schedule, **kw)
    seen = []
    real = jpipe.adamw_update

    def record(grads, norm):
        seen.append(({f"{kind}/{k}": np.array(v, np.float32)
                      for kind in ("outer", "stages")
                      for k, v in grads[kind].items()}, float(norm)))

    def spy(params, grads, state, lr, **k):
        norm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                            for g in jax.tree.leaves(grads)))
        jax.debug.callback(record, grads, norm)
        return real(params, grads, state, lr, **k)

    x, y = _batch()
    losses = []
    jpipe.adamw_update = spy
    try:
        for _ in range(STEPS):
            loss, p, s = step(p, s, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        jax.effects_barrier()
    finally:
        jpipe.adamw_update = real
    return dict(np_params=np_params, losses=losses, grads=seen[0])


@pytest.fixture(scope="module")
def jax_refs():
    return {"pp2": _jax_pp_run({"pp": 2}),
            "dp2pp2": _jax_pp_run({"dp": 2, "pp": 2}),
            "dp2pp2mp2": _jax_pp_run({"dp": 2, "pp": 2, "mp": 2}),
            "pp4": _jax_pp_run({"pp": 4}, cfg_kw={"num_hidden_layers": 4}),
            "vpp": _jax_pp_run({"pp": 2}, "VPP",
                               {"num_hidden_layers": 4})}


def _check_run(runs, ref):
    for r in runs:
        np.testing.assert_allclose(r[0], ref["losses"], rtol=1e-5)
        assert r[0] == runs[0][0]
        assert r[1], "the outer params differ over pp after a step"
        check_grads(r, ref["grads"])


# ---------------------------------------------------------------------------
# the Llama pp step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_llama_pp_step_matches_jax_on_pp2(pool, jax_refs, schedule):
    ref = jax_refs["pp2"]
    x, y = _batch()
    runs = pool.run(2, pp_train_rank, ref["np_params"], x, y, STEPS, LR,
                    {"pp": 2}, {"schedule": schedule, "n_micro": N_MICRO})
    _check_run(runs, ref)
    # the 1F1B family's head is cooperative by default (vocab 128 % 2)
    assert runs[0][3] == (schedule, N_MICRO, schedule != "FThenB")


@pytest.mark.parametrize("name,shape,cfg_kw", [
    ("dp2pp2", {"dp": 2, "pp": 2}, None),
    ("dp2pp2mp2", {"dp": 2, "pp": 2, "mp": 2}, None),
    # middle stages, and the cooperative head's parts hopping from three
    ("pp4", {"pp": 4}, {"num_hidden_layers": 4})])
def test_llama_1f1b_matches_jax_on_hybrid_meshes(pool, jax_refs, name,
                                                 shape, cfg_kw):
    ref = jax_refs[name]
    x, y = _batch()
    world = int(np.prod(list(shape.values())))
    runs = pool.run(world, pp_train_rank, ref["np_params"], x, y, STEPS, LR,
                    shape, {"n_micro": N_MICRO}, cfg_kw)
    _check_run(runs, ref)


def test_llama_vpp_matches_jax_vpp(pool, jax_refs):
    ref = jax_refs["vpp"]
    x, y = _batch()
    runs = pool.run(2, pp_train_rank, ref["np_params"], x, y, STEPS, LR,
                    {"pp": 2}, {"schedule": "VPP", "n_micro": N_MICRO,
                                "vpp_degree": 2},
                    {"num_hidden_layers": 4})
    _check_run(runs, ref)


def test_coop_head_matches_plain_head(pool, jax_refs):
    ref = jax_refs["pp2"]
    x, y = _batch()
    got = {}
    for coop in (True, False):
        got[coop] = pool.run(2, pp_train_rank, ref["np_params"], x, y, 1, LR,
                             {"pp": 2}, {"n_micro": N_MICRO,
                                         "coop_head": coop})[0]
        assert got[coop][3][2] is coop
    np.testing.assert_allclose(got[True][0], got[False][0], rtol=1e-6)
    for k, w in got[False][5].items():
        np.testing.assert_allclose(got[True][5][k], w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)


def test_scheduler_pass_drives_the_step_as_explicit_args(pool, jax_refs):
    ref = jax_refs["pp2"]
    x, y = _batch()
    for name, kw, cfg_kw in (
            ("1F1B", {"schedule": "1F1B", "n_micro": 4}, None),
            ("VPP", {"schedule": "VPP", "n_micro": 4, "vpp_degree": 2},
             {"num_hidden_layers": 4})):
        config, jconfig = {}, {}
        ppasses.PassManager([ppasses.new_pass(
            f"pipeline_scheduler_{name}", {"accumulate_steps": 4})]).apply(
            config)
        jpasses.PassManager([jpasses.new_pass(
            f"pipeline_scheduler_{name}", {"accumulate_steps": 4})]).apply(
            jconfig)
        assert config == jconfig
        params = ref["np_params"] if cfg_kw is None \
            else jax_refs["vpp"]["np_params"]
        by_pass = pool.run(2, pp_train_rank, params, x, y, STEPS, LR,
                           {"pp": 2}, {"strategy": config}, cfg_kw)[0]
        explicit = pool.run(2, pp_train_rank, params, x, y, STEPS, LR,
                            {"pp": 2}, kw, cfg_kw)[0]
        assert by_pass[3] == explicit[3]
        assert by_pass[0] == explicit[0]
        for k in explicit[2]:
            np.testing.assert_array_equal(by_pass[2][k], explicit[2][k])


def test_make_train_step_replicates_over_pp(pool):
    """JAX's make_train_step has no pipeline code: on {"pp": 2} its step
    is replicated over pp. The port's runs the whole step on each pp
    rank, the ranks equal."""
    paddle.seed(1)
    jm = JaxModel(JaxConfig.tiny())
    np_params = {k: np.array(v) for k, v in jm.raw_state().items()}
    crit = JaxCriterion(jm.config)
    step, p, s = jax_make_train_step(jm, lambda lg, lb: crit(lg, lb),
                                     _jmesh({"pp": 2}), lr=LR)
    x, y = _batch()
    want = []
    for _ in range(STEPS):
        loss, p, s = step(p, s, jnp.asarray(x), jnp.asarray(y))
        want.append(float(loss))
    runs = pool.run(2, sharded_train_rank, np_params, x, y, STEPS, LR,
                    {"pp": 2})
    for r in runs:
        np.testing.assert_allclose(r[0], want, atol=1e-4, rtol=0)
        assert r[0] == runs[0][0]
        for k in r[2]:
            np.testing.assert_array_equal(r[2][k], runs[0][2][k])


def test_ppermute_hop_and_its_backward(pool):
    """The ``ppermute`` operator on two gloo CPU ranks: bitwise hops both
    ways, and the ring's backward returns each rank the other's
    cotangent (the transpose of lax.ppermute)."""
    for o in pool.run(2, ppermute_rank, "cpu"):
        assert o["ok"] and o["fwd"] and o["grad"] and o["on_card"], o
        assert o["wire"]["calls"] == 4
        assert o["wire"]["handed_bytes"] == o["wire"]["received_bytes"]


def test_pp_stages_follow_jax_device_order(pool):
    """A rank's pp stage, its pp group and neighbours are those of the
    JAX device of the same index in the mesh's device array (row-major
    over the hybrid axis order)."""
    shape = {"dp": 2, "pp": 2, "mp": 2}
    devs = np.vectorize(lambda d: d.id)(_jmesh(shape).devices)
    pp = list(shape).index("pp")
    got = pool.run(8, mesh_pp_rank, shape)
    for r, (stage, group, (prev, nxt)) in enumerate(got):
        where = tuple(int(i[0]) for i in np.nonzero(devs == r))
        line = [int(devs[where[:pp] + (s,) + where[pp + 1:]])
                for s in range(shape["pp"])]
        assert stage == where[pp] and group == line
        assert prev == (line[stage - 1] if stage > 0 else None)
        assert nxt == (line[stage + 1] if stage + 1 < len(line) else None)


# ---------------------------------------------------------------------------
# the schedule primitives against JAX's, on its toy stages
# ---------------------------------------------------------------------------

def _toy(seed, S=4, M=4, mb=2, d=8):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(S, d, d), scale=0.4).astype(np.float32)
    u = rng.normal(size=(d, 3), scale=0.4).astype(np.float32)
    x = rng.normal(size=(M * mb, d)).astype(np.float32)
    lb = rng.normal(size=(M * mb, 3)).astype(np.float32)
    return w, u, x, lb


@pytest.mark.parametrize("kind", ["1f1b", "zb", "eager"])
def test_one_pass_schedules_match_jax(pool, kind):
    S, M = 4, 4
    w, u, x, lb = _toy({"1f1b": 0, "zb": 1, "eager": 7}[kind])
    fn = {"1f1b": jspmd.pipeline_1f1b, "zb": jspmd.pipeline_zb1f1b,
          "eager": jspmd.pipeline_eager_1f1b}[kind]
    mesh = _jmesh({"dp": 2, "pp": S, "mp": 1})
    loss, d_st, d_hp, d_x = jax.jit(lambda a, b, c, e: fn(
        lambda p, h: jnp.tanh(h @ p["w"]),
        lambda hp, h, y: jnp.mean((h @ hp["u"] - y) ** 2),
        a, b, c, e, mesh=mesh, n_micro=M))(
        {"w": jnp.asarray(w)}, {"u": jnp.asarray(u)}, jnp.asarray(x),
        jnp.asarray(lb))
    runs = pool.run(S, toy_pipeline_rank, kind, w, u, x, lb, M, {"pp": S})
    got_w = np.concatenate([r[1] for r in runs])
    np.testing.assert_allclose(got_w, np.asarray(d_st["w"]), atol=1e-6)
    for r in runs:
        np.testing.assert_allclose(r[0], float(loss), rtol=1e-6)
        np.testing.assert_allclose(r[2], np.asarray(d_hp["u"]), atol=1e-6)
        np.testing.assert_allclose(r[3], np.asarray(d_x), atol=1e-6)


def test_forward_and_vpp_match_jax(pool):
    S, M = 4, 4
    rng = np.random.default_rng(0)
    w = rng.normal(size=(S, 8, 8), scale=0.5).astype(np.float32)
    b = rng.normal(size=(S, 8)).astype(np.float32)
    x = rng.normal(size=(M * 2, 8)).astype(np.float32)
    mesh = _jmesh({"dp": 2, "pp": S, "mp": 1})
    jmesh.set_global_mesh(mesh)

    def loss_fwd(ww):
        out = jspmd.pipeline_forward(
            lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
            {"w": ww, "b": jnp.asarray(b)}, jnp.asarray(x), mesh=mesh,
            n_micro=M)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss_fwd, has_aux=True))(
        jnp.asarray(w))
    runs = pool.run(S, toy_pipeline_rank, "forward", w, b, x, x, M,
                    {"pp": S})
    for r in runs:
        np.testing.assert_allclose(r[0], np.asarray(out), atol=1e-6)
    # a rank's gradient is its stage's row
    got = np.stack([runs[i][1][i] for i in range(S)])
    np.testing.assert_allclose(got, np.asarray(g), atol=1e-6)
    # VPP: chunked [S, V, d, d] weights, n_micro 8
    V = 2
    Ws = rng.standard_normal((S * V, 8, 8)).astype(np.float32) * 0.3
    chunked = np.stack([np.stack([Ws[v * S + r] for v in range(V)])
                        for r in range(S)])
    xv = rng.standard_normal((8, 5, 8)).astype(np.float32)

    def loss_vpp(c):
        out = jspmd.pipeline_vpp_forward(lambda W, h: jnp.tanh(h @ W), c,
                                         jnp.asarray(xv), mesh=mesh,
                                         n_micro=8)
        return out.sum(), out

    (_, outv), gv = jax.jit(jax.value_and_grad(loss_vpp, has_aux=True))(
        jnp.asarray(chunked))
    runs = pool.run(S, toy_pipeline_rank, "vpp", chunked, None, xv, xv, 8,
                    {"pp": S})
    for r in runs:
        np.testing.assert_allclose(r[0], np.asarray(outv), atol=1e-6)
    got = np.stack([runs[i][1][i] for i in range(S)])
    np.testing.assert_allclose(got, np.asarray(gv), atol=1e-6)


def test_pipeline_apply_and_train_batch_match_jax(pool):
    """tests/test_distributed.py::TestPipeline's cases: pipeline_apply
    over pp2 (output and gradient) and PipelineParallel.train_batch."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import (LayerDesc, PipelineLayer,
                                           PipelineParallel)

    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 16))
                   * 0.1, np.float32)
    x = np.random.default_rng(2).normal(size=(8, 16)).astype(np.float32)
    mesh = jdist.build_mesh({"pp": 2, "rest": 4})
    jdist.set_global_mesh(mesh)

    def loss(ww):
        y = jdist.pipeline_apply(lambda p, a: jnp.tanh(a @ p["w"]),
                                 {"w": ww}, jnp.asarray(x),
                                 n_microbatches=4, mesh=mesh, axis="pp")
        return (y ** 2).sum(), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(w))
    runs = pool.run(2, pipeline_apply_rank, w, x, 4)
    for r in runs:
        np.testing.assert_allclose(r[0], np.asarray(y), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(runs[0][1] + runs[1][1], np.asarray(g),
                               rtol=1e-5, atol=1e-6)
    # train_batch: JAX's PipelineLayer of Linear - ReLU - Linear and the
    # port's over the same weights, Adam, accumulate_steps 2
    jdist.set_global_mesh(None)
    paddle.seed(0)
    jlayer = jdist.PipelineLayer(
        layers=[jdist.LayerDesc(jnn.Linear, 8, 8), jdist.LayerDesc(jnn.ReLU),
                jdist.LayerDesc(jnn.Linear, 8, 4)], num_stages=1)
    strategy = jdist.DistributedStrategy()
    strategy.pipeline_configs["accumulate_steps"] = 2
    jpp = jdist.PipelineParallel(jlayer, strategy=strategy)
    jo = jopt.Adam(learning_rate=0.05, parameters=jlayer.parameters())
    layer = PipelineLayer(
        layers=[LayerDesc(torch.nn.Linear, 8, 8), LayerDesc(torch.nn.ReLU),
                LayerDesc(torch.nn.Linear, 8, 4)], num_stages=1)
    with torch.no_grad():
        for tl, jl in ((layer.run_function[0], jlayer.run_function[0]),
                       (layer.run_function[2], jlayer.run_function[2])):
            tl.weight.copy_(torch.from_numpy(jl.weight.numpy().T.copy()))
            tl.bias.copy_(torch.from_numpy(jl.bias.numpy().copy()))
    tpp = PipelineParallel(layer, strategy={"pipeline": {
        "accumulate_steps": 2}})
    assert tpp.accumulate_steps == 2
    assert [len(layer.get_stage_layers(0))] == [3]
    to = Adam(learning_rate=0.05, parameters=list(layer.parameters()))
    rng = np.random.default_rng(3)
    xb = rng.normal(size=(8, 8)).astype(np.float32)
    yb = rng.integers(0, 4, 8)
    for _ in range(2):
        want = float(jpp.train_batch([paddle.to_tensor(xb),
                                      paddle.to_tensor(yb)], jo).numpy())
        got = float(tpp.train_batch([torch.from_numpy(xb),
                                     torch.from_numpy(yb)], to))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    out = tpp.eval_batch([torch.from_numpy(xb), None])
    assert out.shape == (8, 4)


# ---------------------------------------------------------------------------
# the stage params, the timeline, the passes
# ---------------------------------------------------------------------------

def test_split_chunk_merge_match_jax():
    from paddle_tpu_torch.models import params_from_jax

    cfg8 = dataclasses.replace(JaxConfig.tiny(), num_hidden_layers=8)
    paddle.seed(4)
    jstate = dict(JaxModel(cfg8).raw_state())
    state = params_from_jax({k: np.array(v) for k, v in jstate.items()},
                            device="cpu")
    for fn, jfn, args in (
            (llama_pipe.split_llama_state, jpipe.split_llama_state,
             (8, 2)),
            (llama_pipe.chunk_llama_state, jpipe.chunk_llama_state,
             (8, 4, 2))):
        outer, st = fn(state, *args)
        jouter, jst = jfn(jstate, *args, mesh=None)
        assert sorted(outer) == sorted(jouter)
        assert sorted(st) == sorted(jst)
        for k in jst:
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
        merge = llama_pipe.merge_llama_state \
            if fn is llama_pipe.split_llama_state \
            else llama_pipe.merge_llama_chunked_state
        back = merge(outer, st, 8)
        assert set(back) == set(state)
        for k in state:
            np.testing.assert_array_equal(back[k].numpy(),
                                          state[k].numpy())


@pytest.mark.parametrize("sched", pviz.SCHEDULES)
def test_timeline_matches_jax(sched):
    for S, M, V in ((4, 16, 2), (2, 4, 2), (3, 6, 1)):
        tl = pviz.pipeline_timeline(sched, S, M, vpp_degree=V)
        jtl = jviz.pipeline_timeline(sched, S, M, vpp_degree=V)
        assert tl == jtl
        assert pviz.timeline_stats(tl) == jviz.timeline_stats(jtl)
        assert pviz.render_timeline(tl) == jviz.render_timeline(jtl)
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "port.json"), os.path.join(d, "jax.json")
        pviz.save_chrome_trace(tl, a)
        jviz.save_chrome_trace(jtl, b)
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb)
    with pytest.raises(ValueError, match="unknown schedule"):
        pviz.pipeline_timeline("GPipe", 2, 4)


def test_passes_match_jax():
    names = ("auto_parallel_amp", "auto_parallel_fp16",
             "auto_parallel_recompute", "auto_parallel_sharding",
             "auto_parallel_gradient_merge", "fuse_all_reduce",
             "pipeline_scheduler_FThenB", "pipeline_scheduler_ZBH1",
             "pipeline_scheduler_Eager1F1B")
    attrs = {"auto_parallel_sharding": {"stage": 3, "degree": 2},
             "auto_parallel_gradient_merge": {"k_steps": 4},
             "auto_parallel_recompute": {"recompute_skip": 1}}
    for name in names:
        cfg, jcfg = {}, {}
        ctx = ppasses.new_pass(name, attrs.get(name)).apply(cfg)
        jctx = jpasses.new_pass(name, attrs.get(name)).apply(jcfg)
        assert cfg == jcfg, name
        assert ctx.attrs == jctx.attrs
    # two schedules conflict; a bad stage is refused; unknown names raise
    pm = ppasses.PassManager([ppasses.new_pass("pipeline_scheduler_1F1B"),
                              ppasses.new_pass("pipeline_scheduler_VPP")])
    with pytest.raises(ValueError, match="conflicts"):
        pm.apply({})
    with pytest.raises(ValueError, match="attrs invalid"):
        ppasses.new_pass("auto_parallel_sharding", {"stage": 4}).apply({})
    with pytest.raises(ValueError, match="no pass named"):
        ppasses.new_pass("nope")
    ctx = psched.apply_pass({}, {}, "ZBH1", {"accumulate_steps": 8})
    jctx = jsched.apply_pass({}, {}, "ZBH1", {"accumulate_steps": 8})
    assert [p.name for p in ctx.passes] == [p.name for p in jctx.passes]
    with pytest.raises(AssertionError, match="only support"):
        psched.apply_pass({}, {}, "GPipe")


# ---------------------------------------------------------------------------
# the audit and the errors
# ---------------------------------------------------------------------------

def _ring(n):
    return 2.0 * (n - 1) / n


def test_audit_of_a_pp_rank_matches_the_hand_count(pool, jax_refs):
    """tiny() f32, batch 8 x 32, n_micro 4 on pp2: a rank's bytes on the
    pp axis a step (the audit's ring model; a hop costs its sender)."""
    cfg = LlamaConfig.tiny()
    x, y = _batch()
    M, S, H, V = N_MICRO, 32, cfg.hidden_size, cfg.vocab_size
    act = (8 // M) * S * H * 4                 # a microbatch's boundary
    row = (8 // M) * S * 4                      # a [mb, s] f32 reduction
    whole = 8 * S * H * 4                       # the batch's activation
    clip = 9 * 4 * _ring(2)                     # the stage blocks' squares
    for kw, want in (
            # coop: the hops, stage 0's cotangent parts hopping to stage
            # 1, the hidden broadcast and 3 reductions a microbatch, the
            # head's slice gathered, the norm's parts summed, d_x
            # broadcast
            ({"n_micro": M},
             lambda st: M * act * (2 if st == 0 else 1) + M * act * 0.5
             + M * 3 * row * _ring(2) + H * V * 4 * 0.5 + H * 4 * _ring(2)
             + whole * 0.5 + clip),
            # plain head: the hops, the head's grads and d_x broadcast
            # from their rank, the loss from the last
            ({"n_micro": M, "coop_head": False},
             lambda st: M * act + (H * V * 4 + H * 4 + whole + 4) * 0.5
             + clip),
            # FThenB: the hops, the output broadcast, the outer grads
            # summed
            ({"schedule": "FThenB", "n_micro": M},
             lambda st: M * act + whole * 0.5
             + (2 * V * H + H) * 4 * _ring(2) + clip)):
        runs = pool.run(2, pp_audit_rank, jax_refs["pp2"]["np_params"], x,
                        y, {"pp": 2}, kw)
        for stage, (events, per_axis, wire, dead) in enumerate(runs):
            assert per_axis == {"pp": int(want(stage))}, (kw, per_axis)
            assert not dead      # a send-only hop is no dead collective
            sent = sum(e[4] for e in events if e[0] == "ppermute")
            assert wire["ppermute"]["handed_bytes"] == sent


def test_errors_match_jax(pool):
    from paddle_tpu_torch.models import LlamaForCausalLM, init_train_params
    from paddle_tpu_torch.parallel import pipeline_spmd as ps

    with pytest.raises(ValueError, match="eager comm-slack"):
        ps._pipeline_1f1b_impl(None, None, None, None, None, None,
                               mesh=None, axis="pp", n_micro=2,
                               defer_weight_grads=True, eager=True)
    with pytest.raises(ValueError, match="eager comm-slack"):
        jspmd._pipeline_1f1b_impl(None, None, None, None, None, None,
                                  mesh=None, axis="pp", n_micro=2,
                                  defer_weight_grads=True, eager=True)
    tm = LlamaForCausalLM(LlamaConfig.tiny()).load_params(
        init_train_params(LlamaConfig.tiny(), 0, "cpu"), trainable=True)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        llama_pipe.make_llama_pp_train_step(tm, None, schedule="GPipe",
                                            device="cpu")
    with pytest.raises(ValueError, match="coop_head"):
        llama_pipe.make_llama_pp_train_step(tm, None, schedule="1F1B",
                                            coop_head=True, device="cpu")
    if not torch.cuda.is_available():
        # device=None is the card
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            llama_pipe.make_llama_pp_train_step(tm, None)
    with pytest.raises(ValueError, match="not divisible into"):
        llama_pipe.split_llama_state(dict(tm.named_parameters()), 2, 3)
    errs = pool.run(4, pp_errors_rank)
    jm = _jmesh({"dp": 2, "pp": 4, "mp": 1})
    jerrs = []
    for call in (
            lambda: jspmd.pipeline_forward(lambda p, h: h,
                                           {"w": jnp.zeros((4, 2))},
                                           jnp.zeros((6, 2)), mesh=jm,
                                           n_micro=4),
            lambda: jspmd.pipeline_forward(lambda p, h: h,
                                           {"w": jnp.zeros((3, 2))},
                                           jnp.zeros((8, 2)), mesh=jm,
                                           n_micro=4),
            lambda: jspmd.pipeline_vpp_forward(lambda W, h: h,
                                               jnp.zeros((4, 2, 8, 8)),
                                               jnp.zeros((6, 8)), mesh=jm,
                                               n_micro=6)):
        with pytest.raises(ValueError) as e:
            call()
        jerrs.append(str(e.value))
    for r in errs:
        assert r == jerrs
    # coop_head over pp: the JAX validation's messages
    msgs = pool.run(2, coop_errors_rank)
    assert msgs[0] == msgs[1]
    assert "coop_head=True requires" in msgs[0][0]
    assert "divisible" in msgs[0][1]
