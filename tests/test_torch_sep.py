"""The port's sequence and context parallelism over the ``sep`` mesh axis
(`parallel/ring_attention.py`, `parallel/ulysses.py`,
`parallel/sequence_parallel.py`, the tiled ``all_to_all`` with its
gradient, the training step and the Llama attention over sep) and the
saving ``remat_policy`` names, against the JAX package on the CPU.

The port runs one process a rank over gloo (a pool of eight spawned
ranks for the file, tests/torch_rank_pool.py); JAX runs its single
controller over the same mesh on the 8-device CPU host
(tests/conftest.py), each JAX reference built once for the module.
Inputs come from numpy seeds. Tolerances, in f32, are JAX's own tests'
bars where they exist:

- ring attention against JAX's `ring_attention` and `_block_attn`
  (tests/test_ring_attention.py): dp2 x sep4, causal and not (B2 S64 H4
  D16), atol 2e-5; the gradients at sep8, atol 1e-5; the 8k chunked case
  (B1 S8192 HQ2 HK1 D64, sep8), atol 5e-5 of JAX's ring; the no-mesh
  fallback, atol 1e-6;
- `seq_to_head` / `head_to_seq` at dp2 x mp2 x sep2: each rank's block
  is JAX's block of the global array under the head spec (heads over
  (mp, sep), mp major), bitwise, and the round trip is the identity; the
  tiled all-to-all and its gradient bitwise against the exchange worked
  out in numpy;
- `split_seq` / `gather_seq` / `sep_attention_context` (JAX's
  TestSequenceParallel) bitwise, the sep getters of
  `HybridCommunicateGroup`; `SegmentParallel` against JAX's
  `SegmentParallel` on the same mesh, two backward passes accumulating:
  logits, losses and the accumulated gradients within 1e-5, and for a
  model that does not declare ``handles_seq_shard`` (a Linear, whole on
  every rank) the same, with `make_train_step`'s losses against JAX's;
- Llama tiny() training (3 steps, lr 1e-3, batch 4 x 32) on the four
  meshes of JAX's test_sep_matches_serial (nh 8 / nkv 2, the minimal kv
  repeat, included): losses atol 1e-4 of JAX's sharded step on the same
  mesh and atol 2e-3 (JAX's bar) of JAX's serial losses, every rank's
  first-step gradients and clip norm through `check_grads` (rtol 1e-5),
  the gathered params bitwise equal on every rank; ring against Ulysses
  at dp2 x mp2 x sep2 (JAX's 2e-3) and against JAX's ring step (1e-4);
- `make_eval_step` over sep: the global logits atol 1e-5 of JAX's
  `make_eval_step` on the same mesh;
- `make_llama_pp_train_step` and `fit` on a sep mesh: bitwise the same
  step without sep (JAX's replicate over sep);
- each saving remat_policy against JAX's step with the same policy:
  losses atol 1e-5, first-step gradients through `check_grads`; with
  ``save_attn`` the flash forward runs once a layer a step (L), not twice
  (2L): counted where the card counts launches, in the operator's
  implementation (the recompute takes the saved outputs and never calls
  it); every policy at every remat_scope and over dp2 x mp2 x sep2
  within 1e-5 of the plain step's losses.
"""
import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.models.llama import shard_llama as jax_shard_llama
from paddle_tpu.parallel import SegmentParallel as JaxSegmentParallel
from paddle_tpu.parallel import make_eval_step as jax_make_eval_step
from paddle_tpu.parallel import make_train_step as jax_make_train_step
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import ulysses as julysses
from test_torch_zero import check_grads, recording_grads
from torch_rank_pool import (RankPool, all_to_all_rank, eval_rank,
                             fit_dp_rank, pp_train_rank, ring_rank, seq_parallel_rank,
                             segment_parallel_plain_rank,
                             segment_parallel_rank, sharded_train_rank,
                             ulysses_rank)

# the packages export `ring_attention` the function under the module's name
jring = importlib.import_module("paddle_tpu.parallel.ring_attention")
pring = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

LR = 1e-3
STEPS = 3
# JAX's test_sep_matches_serial meshes (tests/test_llama.py:519-524)
SEP_MESHES = {
    "dp4xsep2": ({"dp": 4, "sharding": 1, "mp": 1, "sep": 2}, {}),
    "dp2xsep4": ({"dp": 2, "sharding": 1, "mp": 1, "sep": 4}, {}),
    "dp2xmp2xsep2": ({"dp": 2, "sharding": 1, "mp": 2, "sep": 2}, {}),
    "dp2xmp2xsep2-nh8": ({"dp": 2, "sharding": 1, "mp": 2, "sep": 2},
                         dict(num_attention_heads=8,
                              num_key_value_heads=2)),
}
DP2_MP2_SEP2 = SEP_MESHES["dp2xmp2xsep2"][0]
POLICIES = ("save_attn", "dots_saveable", "dots_with_no_batch_dims_saveable")


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


def _world(shape):
    return int(np.prod(list(shape.values())))


def _jmesh(shape):
    return jmesh.build_mesh(shape, devices=jax.devices()[:_world(shape)])


@contextlib.contextmanager
def _global_mesh(mesh):
    jmesh.set_global_mesh(mesh)
    try:
        yield
    finally:
        jmesh.set_global_mesh(None)


def _batch():
    rng = np.random.default_rng(0)
    return rng.integers(0, 128, (4, 32)), rng.integers(0, 128, (4, 32))


def _jax_full(q, k, v, causal):
    num, m, l = jring._block_attn(q, k, v, 1 / np.sqrt(q.shape[-1]), 0, 0,
                                  causal)
    return np.asarray((num / l).astype(q.dtype))


def _global(blocks, shape, b, s):
    """The ranks' [b/dp, s/sep, ...] blocks (rank order: dp major, sep
    minor) assembled into the global [b, s, ...] array."""
    dp, sep = shape.get("dp", 1), shape.get("sep", 1)
    rows = [np.concatenate(blocks[i * sep:(i + 1) * sep], axis=1)
            for i in range(dp)]
    return np.concatenate(rows, axis=0)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(pool, causal):
    shape = {"dp": 2, "sep": 4}
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 64, 4, 16
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    mesh = _jmesh(shape)
    with _global_mesh(mesh):
        want = np.asarray(jring.ring_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh=mesh,
            causal=causal))
    got = _global(pool.run(8, ring_rank, q, k, v, shape, causal), shape,
                  B, S)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, _jax_full(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), causal),
                               atol=2e-5, rtol=0)


def test_ring_attention_gradients_match_jax(pool):
    shape = {"sep": 8}
    rng = np.random.default_rng(1)
    B, S, H, D = 1, 64, 2, 8
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    mesh = _jmesh(shape)

    def loss_ring(q, k, v):
        return jnp.sum(jring.ring_attention(q, k, v, mesh=mesh, causal=True)
                       * jnp.cos(q))

    with _global_mesh(mesh):
        want = jax.jit(jax.grad(loss_ring, (0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    runs = pool.run(8, ring_rank, q, k, v, shape, True, True)
    for i, w in enumerate(want):
        got = _global([r[1][i] for r in runs], shape, B, S)
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5, rtol=0)


def test_ring_attention_at_8k_matches_jax(pool):
    """The long-context shape: 1024-token chunks around eight ranks."""
    shape = {"sep": 8}
    rng = np.random.default_rng(3)
    B, S, HQ, HK, D = 1, 8192, 2, 1, 64
    q = rng.normal(size=(B, S, HQ, D)).astype(np.float32)
    k = rng.normal(size=(B, S, HK, D)).astype(np.float32)
    v = rng.normal(size=(B, S, HK, D)).astype(np.float32)
    mesh = _jmesh(shape)
    with _global_mesh(mesh):
        want = np.asarray(jax.jit(lambda a, b_, c: jring.ring_attention(
            a, b_, c, mesh=mesh, causal=True))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = _global(pool.run(8, ring_rank, q, k, v, shape, True), shape, B, S)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_ring_attention_without_a_mesh_is_one_block():
    import torch

    rng = np.random.default_rng(2)
    q = rng.normal(size=(1, 16, 2, 8)).astype(np.float32)
    got = pring.ring_attention(*(torch.as_tensor(q),) * 3, mesh=None,
                                   causal=True)
    want = _jax_full(*(jnp.asarray(q),) * 3, True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the block itself, GQA by the grouped einsum, against JAX's
    k = rng.normal(size=(1, 16, 1, 8)).astype(np.float32)
    for causal in (True, False):
        jb = jring._block_attn(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(k), 0.3, 16, 5, causal)
        pb = pring._block_attn(torch.as_tensor(q), torch.as_tensor(k),
                                   torch.as_tensor(k), 0.3, 16, 5, causal)
        for a, b in zip(pb, jb):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the Ulysses swap and the tiled all-to-all
# ---------------------------------------------------------------------------

def test_ulysses_blocks_are_jax_blocks(pool):
    shape = {"dp": 2, "mp": 2, "sep": 2}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    mesh = _jmesh(shape)
    y = julysses.seq_to_head(jnp.asarray(x), mesh)
    assert tuple(y.sharding.spec) == ("dp", None, ("mp", "sep"), None)
    np.testing.assert_array_equal(np.asarray(y), x)
    runs = pool.run(8, ulysses_rank, x, shape)
    for r, (blk, round_trip) in enumerate(runs):
        i, a, j = r // 4, (r // 2) % 2, r % 2     # (dp, mp, sep) digits
        h = a * 2 + j                             # (mp, sep), mp major
        np.testing.assert_array_equal(blk, x[i:i + 1, :, 2 * h:2 * h + 2])
        assert round_trip


@pytest.mark.parametrize("dims", [(2, 1), (1, 0)])
def test_tiled_all_to_all_and_its_gradient(pool, dims):
    split, concat = dims
    rng = np.random.default_rng(5)
    n = 4
    xs = [rng.normal(size=(3, 8, 4)).astype(np.float32) for _ in range(n)]
    ws = [rng.normal(size=(3, 8, 4)).astype(np.float32) for _ in range(n)]
    ws = [np.concatenate(np.split(w, n, axis=split), axis=concat)
          for w in ws]                            # shaped like y
    runs = pool.run(n, all_to_all_rank, xs, ws, split, concat)
    for j, (y, g) in enumerate(runs):
        want = np.concatenate([np.split(x, n, axis=split)[j] for x in xs],
                              axis=concat)
        np.testing.assert_array_equal(y, want)
        back = np.concatenate([np.split(w, n, axis=concat)[j] for w in ws],
                              axis=split)
        np.testing.assert_array_equal(g, back)


# ---------------------------------------------------------------------------
# sequence_parallel
# ---------------------------------------------------------------------------

def test_split_gather_and_attention_context(pool):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 4)).astype(np.float32)
    q = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    w = [rng.normal(size=(2, 4, 4)).astype(np.float32) for _ in range(2)]
    for r, out in enumerate(pool.run(8, seq_parallel_rank, x, q, w)):
        j = out["sep"]
        # rank r = sep digit * 4 + rest digit: its sep group {r % 4, +4}
        group = f"sep@{r % 4},{r % 4 + 4}"
        assert j == r // 4 and out["hcg"] == (j, 2, group, r % 4, group)
        np.testing.assert_array_equal(out["split"], x[:, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(out["gathered"], x)
        np.testing.assert_array_equal(out["grad"],
                                      np.concatenate(w, axis=1))
        np.testing.assert_array_equal(out["q2"], q[:, :, 2 * j:2 * j + 2])
        assert out["kv_same"]
        np.testing.assert_array_equal(out["moved"], x[:, :, 2 * j:2 * j + 2])


def _two_batches():
    rng = np.random.default_rng(7)
    return [tuple(rng.integers(0, 128, (4, 32)) for _ in range(2))
            for _ in range(2)]


def test_segment_parallel_matches_one_process(pool):
    """Against JAX's SegmentParallel (one controller) on {"sep": 2}: each
    backward's gradients are summed over sep once, so two backwards
    accumulate what JAX's two do. One layer keeps JAX's eager passes
    short."""
    cfg_kw = {"num_hidden_layers": 1}
    batches = _two_batches()
    jm, np_params = _jax_params(cfg_kw)
    mesh = _jmesh({"sep": 2})
    crit = JaxCriterion(jm.config)
    logits, losses = [], []
    with _global_mesh(mesh):
        sp = JaxSegmentParallel(jm)
        for x, y in batches:
            lg = sp(paddle.to_tensor(x))
            loss = crit(lg, paddle.to_tensor(y))
            loss.backward()
            logits.append(lg.numpy())
            losses.append(float(loss.numpy()))
    grads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
    for equal, got_lg, got_l, got_g in pool.run(
            2, segment_parallel_rank, np_params, batches, {"sep": 2},
            cfg_kw):
        assert equal
        for a, b in zip(got_lg, logits):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got_l, losses, atol=1e-5, rtol=0)
        assert sorted(got_g) == sorted(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(got_g[k], g, atol=1e-5, rtol=0,
                                       err_msg=k)


def test_segment_parallel_replicates_a_model_without_seq_support(pool):
    """A Linear on [rows, seq, features] computes over the tokens it is
    handed: SegmentParallel and make_train_step on {"sep": 2} keep its
    sequence whole on every rank (no split, no sum over sep), which gives
    JAX's global values, here under a loss that pairs each token with
    the next one's label: JAX's SegmentParallel output and gradients and
    JAX's make_train_step losses on the same mesh."""
    import paddle_tpu.nn as jnn

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 8, 4)).astype(np.float32)
    y = rng.normal(size=(2, 8, 3)).astype(np.float32)
    lin = jnn.Linear(4, 3)
    w, b = (np.array(t.numpy()) for t in (lin.weight, lin.bias))
    mesh = _jmesh({"sep": 2})

    def mse(out, lb):           # each output against the next label
        return ((out[:, :-1] - lb[:, 1:]) ** 2).mean()

    with _global_mesh(mesh):
        out = JaxSegmentParallel(lin)(paddle.to_tensor(x))
        mse(out, paddle.to_tensor(y)).backward()
        grads = {"weight": lin.weight.grad.numpy().T,
                 "bias": lin.bias.grad.numpy()}
        step, p, s = jax_make_train_step(lin, mse, mesh, lr=LR)
        losses = []
        for _ in range(2):
            loss, p, s = step(p, s, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
    for whole, got, got_g, got_l in pool.run(
            2, segment_parallel_plain_rank, w, b, x, y, LR):
        assert whole
        np.testing.assert_allclose(got, out.numpy(), atol=1e-6, rtol=0)
        for k, g in grads.items():
            np.testing.assert_allclose(got_g[k], g, atol=1e-6, rtol=0,
                                       err_msg=k)
        np.testing.assert_allclose(got_l, losses, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Llama training over sep
# ---------------------------------------------------------------------------

def _jax_params(cfg_kw):
    paddle.seed(11)
    jm = JaxModel(dataclasses.replace(JaxConfig.tiny(), **cfg_kw))
    return jm, {k: np.array(v) for k, v in jm.raw_state().items()}


def _jax_train(shape, cfg_kw, steps=STEPS):
    """JAX's step (after shard_llama over `shape`, the global mesh set, as
    its test does; serial without a shape): (losses, the first step's
    gradients and clip norm)."""
    jm, _ = _jax_params(cfg_kw)
    mesh = _jmesh(shape) if shape else None
    x, y = _batch()
    with _global_mesh(mesh):
        if mesh is not None:
            jax_shard_llama(jm, mesh)
        crit = JaxCriterion(jm.config)
        step, p, s = jax_make_train_step(jm, lambda lg, lb: crit(lg, lb),
                                         mesh, lr=LR)
        losses = []
        with recording_grads() as seen:
            for _ in range(steps):
                loss, p, s = step(p, s, jnp.asarray(x), jnp.asarray(y))
                losses.append(float(loss))
    return losses, seen[0]


@pytest.fixture(scope="module")
def jax_runs():
    nh8 = SEP_MESHES["dp2xmp2xsep2-nh8"][1]
    return {
        "np_params": {"": _jax_params({})[1], "nh8": _jax_params(nh8)[1]},
        "serial": {"": _jax_train(None, {})[0],
                   "nh8": _jax_train(None, nh8)[0]},
        "sep": {name: _jax_train(shape, kw)
                for name, (shape, kw) in SEP_MESHES.items()},
        "ring": _jax_train(DP2_MP2_SEP2, {"attention_impl": "ring"}, 2),
    }


def _check_ranks_equal(runs):
    for r in runs[1:]:
        assert r[0] == runs[0][0]
        for which in (1, 2):
            for k in runs[0][which]:
                np.testing.assert_array_equal(r[which][k], runs[0][which][k])


@pytest.mark.parametrize("name", sorted(SEP_MESHES))
def test_sep_training_matches_jax(pool, jax_runs, name):
    shape, cfg_kw = SEP_MESHES[name]
    key = "nh8" if cfg_kw else ""
    x, y = _batch()
    runs = pool.run(8, sharded_train_rank, jax_runs["np_params"][key], x, y,
                    STEPS, LR, shape, None, True, cfg_kw)
    losses, grads = jax_runs["sep"][name]
    np.testing.assert_allclose(runs[0][0], losses, atol=1e-4, rtol=0)
    np.testing.assert_allclose(runs[0][0], jax_runs["serial"][key],
                               atol=2e-3, rtol=0)
    for r in runs:
        check_grads(r, grads)
    _check_ranks_equal(runs)


def test_ring_matches_ulysses_and_jax_ring(pool, jax_runs):
    x, y = _batch()
    np_params = jax_runs["np_params"][""]
    losses = {}
    for impl in ("ulysses", "ring"):
        runs = pool.run(8, sharded_train_rank, np_params, x, y, 2, LR,
                        DP2_MP2_SEP2, None, True, {"attention_impl": impl})
        _check_ranks_equal(runs)
        losses[impl] = runs[0][0]
    np.testing.assert_allclose(losses["ring"], losses["ulysses"], atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(losses["ring"], jax_runs["ring"][0],
                               atol=1e-4, rtol=0)
    for r in runs:
        check_grads(r, jax_runs["ring"][1])


def test_make_eval_step_over_sep(pool, jax_runs):
    """Against JAX's make_eval_step of the shard_llama'd model on the
    same mesh."""
    np_params = jax_runs["np_params"][""]
    x, _ = _batch()
    for shape in ({"sep": 2, "mp": 2, "dp": 2}, {"dp": 2, "sep": 4}):
        jm, _ = _jax_params({})
        mesh = _jmesh(shape)
        with _global_mesh(mesh):
            jax_shard_llama(jm, mesh)
            want = np.asarray(jax_make_eval_step(jm, mesh)(
                jm.raw_state(), jnp.asarray(x)))
        for got in pool.run(8, eval_rank, np_params, x, shape):
            assert got.shape == (4, 32, 128)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_step_binds_parameters_only_and_an_audit_leaves_them():
    """The step takes the model's nn.Parameters; a plain tensor (say a
    checkpoint's, detached) raises as it did before stand-ins were
    allowed, and only a trace's stand-ins take a parameter's slot: after
    the communication audit of a whole step the model holds its own
    parameters again and trains on."""
    import torch

    from paddle_tpu_torch.analysis import comms
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion,
                                         init_train_params)
    from paddle_tpu_torch.parallel import make_train_step

    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, seed=3, device="cpu"), trainable=True)
    crit = LlamaPretrainingCriterion(cfg)
    step, p, s = make_train_step(model, lambda lg, lb: crit(lg, lb), None,
                                 lr=LR, device="cpu")
    x, y = (torch.as_tensor(a[:, :16]) for a in _batch())
    with pytest.raises(TypeError, match="nn.Parameter"):
        step({k: v.detach() for k, v in p.items()}, s, x, y)
    comms.audit_comms(step, p, s, x, y, grad=True)
    live = dict(model.named_parameters())
    assert all(live[k] is v for k, v in p.items())
    before = float(step(p, s, x, y)[0])
    assert np.isfinite(before) and float(step(p, s, x, y)[0]) < before


def test_pp_step_on_a_sep_mesh_replicates_over_sep(pool, jax_runs):
    """JAX's pp step lays the batch over (dp, sharding) only and runs its
    layers without a mesh: sep replicates it. The port's pp step on
    {"pp": 2, "sep": 2} gives the {"pp": 2} step's losses and params."""
    x, y = _batch()
    np_params = jax_runs["np_params"][""]
    kw = {"n_micro": 2}
    alone = pool.run(2, pp_train_rank, np_params, x, y, 2, LR, {"pp": 2},
                     kw)[0]
    for r in pool.run(4, pp_train_rank, np_params, x, y, 2, LR,
                      {"pp": 2, "sep": 2}, kw):
        assert r[0] == alone[0] and r[1]
        for k in alone[2]:
            np.testing.assert_array_equal(r[2][k], alone[2][k])


def test_fit_on_a_sep_mesh_replicates_over_sep(pool, jax_runs):
    """JAX's fit lays its batches over dp only: sep replicates its step.
    The port's fit on {"dp": 2, "sep": 2} gives the {"dp": 2} fit's
    losses and params on every rank."""
    rng = np.random.default_rng(0)
    batches = [(rng.integers(1, 128, (4, 8)).astype(np.int64),
                rng.normal(size=(4, 8, 128)).astype(np.float32))
               for _ in range(2)]
    np_params = jax_runs["np_params"][""]
    alone = pool.run(2, fit_dp_rank, np_params, batches, False)[0]
    for r in pool.run(4, fit_dp_rank, np_params, batches, False, False,
                      {"dp": 2, "sep": 2}):
        assert r[0] == alone[0]
        for k in alone[2]:
            np.testing.assert_array_equal(r[2][k], alone[2][k])


# ---------------------------------------------------------------------------
# the saving remat policies
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_policy_runs():
    return {pol: _jax_train(None, {"recompute": True, "remat_policy": pol},
                            2)
            for pol in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_saving_remat_policy_matches_jax(pool, jax_runs, jax_policy_runs,
                                         policy):
    x, y = _batch()
    np_params = jax_runs["np_params"][""]
    kw = {"recompute": True, "remat_policy": policy}
    losses, grads = jax_policy_runs[policy]
    run = pool.run(1, sharded_train_rank, np_params, x, y, 2, LR,
                   {"dp": 1}, None, False, kw)[0]
    np.testing.assert_allclose(run[0], losses, atol=1e-5, rtol=0)
    check_grads(run, grads)
    # at the sub-block scopes and over sep too
    for scope in ("attn", "mlp"):
        got = pool.run(1, sharded_train_rank, np_params, x, y, 2, LR,
                       {"dp": 1}, None, False,
                       dict(kw, remat_scope=scope))[0][0]
        np.testing.assert_allclose(got, losses, atol=1e-5, rtol=0)
    runs = pool.run(8, sharded_train_rank, np_params, x, y, 2, LR,
                    DP2_MP2_SEP2, None, True, kw)
    np.testing.assert_allclose(runs[0][0], losses, atol=1e-5, rtol=0)
    _check_ranks_equal(runs)


def test_save_attn_runs_the_flash_forward_once_a_layer(monkeypatch):
    """What a step launches on the card, counted on the CPU where the
    flash forward operator runs its plain version: 2L with whole-layer
    recompute (forward and recompute), L with save_attn (the recompute
    takes the saved output and lse), whatever the scope; the losses
    equal."""
    import torch

    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion,
                                         init_train_params)
    from paddle_tpu_torch.parallel import make_train_step

    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    calls = []
    real = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, y = (torch.as_tensor(a[:, :16]) for a in _batch())
    L = 2
    seen = {}
    for policy, scope, want in (("none", "layer", 2 * L),
                                ("save_attn", "layer", L),
                                ("save_attn", "attn", L),
                                ("dots_saveable", "layer", 2 * L)):
        cfg = LlamaConfig.tiny(recompute=True, remat_policy=policy,
                               remat_scope=scope, num_hidden_layers=L)
        model = LlamaForCausalLM(cfg).load_params(
            init_train_params(cfg, seed=3, device="cpu"), trainable=True)
        crit = LlamaPretrainingCriterion(cfg)
        step, p, s = make_train_step(model, lambda lg, lb: crit(lg, lb),
                                     None, lr=LR, device="cpu")
        calls.clear()
        loss, p, s = step(p, s, x, y)
        assert len(calls) == want, (policy, scope, len(calls))
        seen[(policy, scope)] = float(loss)
    assert len(set(seen.values())) == 1, seen


def test_dots_policies_save_the_matmuls():
    """dots_saveable keeps every matmul output through the recompute,
    dots_with_no_batch_dims_saveable the unbatched ones (the
    projections; the attention's batched products live in the flash
    operator): the backward runs no projection again under either, where
    the plain recompute runs q, k, v, o, gate and up again (it stops once
    the tensors the backward needs exist: no one needs down's output)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         init_train_params)

    class Count(TorchDispatchMode):
        mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    x = torch.as_tensor(_batch()[0][:, :16])
    counts = {}
    for policy in ("none",) + POLICIES[1:]:
        cfg = LlamaConfig.tiny(recompute=True, remat_policy=policy)
        model = LlamaForCausalLM(cfg).load_params(
            init_train_params(cfg, seed=3, device="cpu"), trainable=True)
        loss = model(x).float().mean()
        with Count() as c:
            loss.backward()
        counts[policy] = c.mm
    assert counts["dots_saveable"] == counts[
        "dots_with_no_batch_dims_saveable"]
    assert counts["none"] - counts["dots_saveable"] == \
        6 * LlamaConfig.tiny().num_hidden_layers
