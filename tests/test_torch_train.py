"""Parity of the port's training path (paddle_tpu_torch.parallel,
optimizer, models) with the JAX package's, on the CPU.

The JAX model's weights (``raw_state()`` as numpy) carry across by
``params_from_jax``; the same numpy batches go through JAX's jitted
``make_train_step`` (its Pallas kernels in interpret mode) and the port's
eager one. Tolerances:

- losses of the 5-step f32 ``tiny()`` runs: atol 1e-4 (f32; the tiny
  model's grads reach Adam's sign-like first steps, so the trajectories
  drift by more than the 1e-5 of one forward);
- params after step 1: max |port - jax| <= 2 * lr (+ 1e-6 for the f32
  rounding of the param), since Adam's first update is about
  lr * sign(g) and a grad near 0 may take the other sign;
- amp (bf16 forward and backward): the port's plain attention rounds its
  scores to bf16 where JAX's kernel keeps f32: losses atol 5e-3;
- the fused-SwiGLU model (hidden 512, FFN 1024): atol 1e-4 on the losses;
- the clips: f32 atol 1e-6, bf16 equal (one f32 product rounded once);
  the LR schedulers: equal (the same plain Python);
- the Adam / AdamW rule on a bf16 param: f32 state atol 1e-6, the param
  within one bf16 step.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.parallel import make_train_step as jax_make_train_step
from paddle_tpu.parallel.fused_optimizer import (
    FusedOptimizer as JaxFusedOptimizer)
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     init_train_params, params_from_jax)
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as port_lr
from paddle_tpu_torch.parallel import FusedOptimizer, make_train_step

LR = 1e-3
LOSS_ATOL = 1e-4


def _decay(name: str) -> bool:
    # bench.py's apply_decay_param_fun (bench.py:1017-1019)
    return "norm" not in name and not name.endswith(".b_0")


def _models(seed=0, **over):
    jcfg = dataclasses.replace(JaxConfig.tiny(), **over)
    paddle.seed(seed)
    jm = JaxModel(jcfg)
    np_params = {k: np.array(v) for k, v in jm.raw_state().items()}
    cfg = dataclasses.replace(LlamaConfig.tiny(), **over)
    tm = LlamaForCausalLM(cfg).load_params(
        params_from_jax(np_params, device="cpu"), trainable=True)
    return jm, tm


def _batch(cfg_vocab=128, b=4, s=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg_vocab, (b, s)),
            rng.integers(0, cfg_vocab, (b, s)))


def _run_jax(jm, steps, x, y, use_optimizer=True, strategy=None):
    crit = JaxCriterion(jm.config)
    opt = JaxAdamW(learning_rate=LR, weight_decay=0.01,
                   apply_decay_param_fun=_decay,
                   parameters=jm.parameters()) if use_optimizer else None
    step, p, s = jax_make_train_step(jm, lambda lg, lb: crit(lg, lb), None,
                                     lr=LR, optimizer=opt, strategy=strategy)
    losses, first = [], None
    for i in range(steps):
        loss, p, s = step(p, s, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
        if i == 0:
            first = {k: np.array(v, np.float32) for k, v in p.items()}
    return losses, first


def _run_port(tm, steps, x, y, use_optimizer=True, strategy=None):
    crit = LlamaPretrainingCriterion(tm.config)
    opt = AdamW(learning_rate=LR, weight_decay=0.01,
                apply_decay_param_fun=_decay,
                parameters=tm.parameters()) if use_optimizer else None
    step, p, s = make_train_step(tm, lambda lg, lb: crit(lg, lb), None,
                                 lr=LR, optimizer=opt, strategy=strategy,
                                 device="cpu")
    losses, first = [], None
    for i in range(steps):
        loss, p, s = step(p, s, x, y)
        assert loss.dtype == torch.float32 and loss.ndim == 0
        losses.append(float(loss))
        if i == 0:
            first = {k: v.detach().float().numpy().copy()
                     for k, v in p.items()}
    return losses, first, p


def _assert_same_run(port, jax_run, loss_atol=LOSS_ATOL):
    (tl, tfirst, _), (jl, jfirst) = port, jax_run
    np.testing.assert_allclose(tl, jl, atol=loss_atol, rtol=0)
    assert set(tfirst) == set(jfirst)
    # a sign flip moves a param by 2 * lr * |g| / (|g| + eps) < 2 * lr,
    # plus the rounding of the f32 param itself
    worst = max(float(np.abs(tfirst[k] - jfirst[k]).max()) for k in jfirst)
    assert worst <= 2 * LR + 1e-6, worst


@pytest.mark.parametrize("use_optimizer", [True, False],
                         ids=["adamw_fused_optimizer", "adamw_update"])
def test_five_tiny_steps_match_jax(use_optimizer):
    """bench.py's step on tiny() in f32 at batch 4 x 64: AdamW with
    bench's decay function through FusedOptimizer, and the default
    adamw_update (clip 1.0, decay on ndim > 1)."""
    jm, tm = _models()
    x, y = _batch()
    port = _run_port(tm, 5, x, y, use_optimizer)
    _assert_same_run(port, _run_jax(jm, 5, x, y, use_optimizer))
    assert port[0][-1] < port[0][0]


def test_gradient_merge_matches_jax():
    strategy = {"gradient_merge": {"enable": True, "k_steps": 2}}
    jm, tm = _models(seed=1)
    x, y = _batch(seed=1)
    _assert_same_run(_run_port(tm, 3, x, y, strategy=strategy),
                     _run_jax(jm, 3, x, y, strategy=strategy))


def test_recompute_is_bitwise_neutral_and_matches_jax():
    strategy = {"recompute": {"enable": True}}
    x, y = _batch(seed=2)
    jm, tm = _models(seed=2)
    _, tm_off = _models(seed=2)
    on = _run_port(tm, 3, x, y, strategy=strategy)
    off = _run_port(tm_off, 3, x, y)
    assert on[0] == off[0]
    for k, t in on[2].items():
        assert torch.equal(t, off[2][k]), k
    assert tm.config.recompute is False      # the flip is scoped to a step
    _assert_same_run(on, _run_jax(jm, 3, x, y, strategy=strategy))


@pytest.mark.parametrize("scope", ["attn", "mlp"])
def test_sub_block_recompute_is_bitwise_neutral(scope):
    x, y = _batch(seed=3)
    _, tm = _models(seed=3, recompute=True, remat_scope=scope,
                    recompute_skip=1)
    _, tm_off = _models(seed=3)
    on = _run_port(tm, 2, x, y)
    off = _run_port(tm_off, 2, x, y)
    assert on[0] == off[0]
    for k, t in on[2].items():
        assert torch.equal(t, off[2][k]), k


def test_amp_matches_jax():
    strategy = {"amp": {"enable": True}}
    jm, tm = _models(seed=4)
    x, y = _batch(seed=4)
    port = _run_port(tm, 3, x, y, strategy=strategy)
    assert all(v.dtype == torch.float32 for v in port[2].values())
    _assert_same_run(port, _run_jax(jm, 3, x, y, strategy=strategy),
                     loss_atol=5e-3)


def test_fused_swiglu_model_matches_jax():
    """fused_swiglu=True at aligned widths (hidden 512, FFN 1024, batch x
    seq = 512): the MLP goes through swiglu_matmul's fused route on both
    sides (JAX's Pallas SwiGLU in interpret mode)."""
    over = dict(fused_swiglu=True, hidden_size=512, intermediate_size=1024,
                num_hidden_layers=1)
    jm, tm = _models(seed=5, **over)
    x, y = _batch(b=4, s=128, seed=5)
    _assert_same_run(_run_port(tm, 2, x, y), _run_jax(jm, 2, x, y))


def test_criterion_is_unshifted_mean_cross_entropy():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 7, 128)).astype(np.float32)
    labels = rng.integers(0, 128, (2, 7))
    got = LlamaPretrainingCriterion()(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    ref = JaxCriterion()(paddle.to_tensor(logits), paddle.to_tensor(labels))
    np.testing.assert_allclose(float(got), float(ref.numpy()), atol=1e-6)
    # no shift: label t is scored against logits t, not t - 1
    plain = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits).reshape(-1, 128),
        torch.from_numpy(labels).reshape(-1))
    torch.testing.assert_close(got, plain, atol=1e-6, rtol=0)


def test_decayed_parameter_set_equals_jax():
    """JAX decides decay on auto names ("linear_3.w_0"), the port on the
    structural keys: with bench's predicate both decay every weight but
    the norm scales."""
    jm, tm = _models(seed=7)
    jfused = JaxFusedOptimizer(JaxAdamW(
        learning_rate=LR, weight_decay=0.01, apply_decay_param_fun=_decay,
        parameters=jm.parameters()), jm)
    tfused = FusedOptimizer(AdamW(
        learning_rate=LR, weight_decay=0.01, apply_decay_param_fun=_decay,
        parameters=tm.parameters()), tm)
    jset = {n for n, wd in jfused._wd.items() if wd}
    tset = {n for n, wd in tfused._wd.items() if wd}
    assert tset == jset
    assert tset == {n for n, _ in tm.named_parameters() if "norm" not in n}


def test_eager_backward_and_step_match_jax_eager():
    """loss.backward(); opt.step(); opt.clear_grad() in both packages,
    AdamW over named params (the port feeds the decay function the
    structural keys)."""
    jm, tm = _models(seed=8)
    x, y = _batch(b=2, s=32, seed=8)
    jcrit, tcrit = JaxCriterion(), LlamaPretrainingCriterion()
    jopt = JaxAdamW(learning_rate=LR, weight_decay=0.01,
                    apply_decay_param_fun=_decay, parameters=jm.parameters())
    topt = AdamW(learning_rate=LR, weight_decay=0.01,
                 apply_decay_param_fun=_decay,
                 parameters=tm.named_parameters())
    for _ in range(3):
        jl = jcrit(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tcrit(tm(torch.from_numpy(x)), torch.from_numpy(y))
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                                   atol=LOSS_ATOL)
        assert all(p.grad is None for p in tm.parameters())
    for name, p in tm.named_parameters():
        ref = np.asarray(dict(jm.raw_state())[name], np.float32)
        assert np.abs(p.detach().numpy() - ref).max() <= 2 * LR + 1e-6, name


def test_refused_options_raise():
    _, tm = _models()
    crit = LlamaPretrainingCriterion()
    loss = lambda lg, lb: crit(lg, lb)  # noqa: E731

    # the mp, sharding, pp and sep axes train (tests/test_torch_zero.py,
    # tests/test_torch_tp.py, tests/test_torch_pp.py,
    # tests/test_torch_sep.py): such a mesh needs its ranks
    from paddle_tpu_torch.parallel import build_mesh

    for axis in ("mp", "pp", "sep"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            build_mesh({"dp": 1, axis: 2})
    # the saving policy trains (its parameters restored after each step)
    # and gives the losses of the step that saves nothing
    x, y = _batch(b=1, s=8)
    losses = {}
    for policy in ("save_attn", "none"):
        step, p, s = make_train_step(
            tm, loss, None, device="cpu",
            strategy={"recompute": {"enable": True,
                                    "remat_policy": policy}})
        saved = {k: v.detach().clone() for k, v in p.items()}
        losses[policy] = [float(step(p, s, x, y)[0]) for _ in range(2)]
        with torch.no_grad():
            for k, v in p.items():
                v.copy_(saved[k])
    assert losses["save_attn"] == losses["none"], losses
    assert tm.config.remat_policy == "none"
    # a name the JAX model maps to no saving policy recomputes everything
    step, p, s = make_train_step(
        tm, loss, None, device="cpu",
        strategy={"recompute": {"enable": True, "remat_policy": "full"}})
    assert torch.isfinite(step(p, s, x, y)[0])


def test_init_train_params_are_trainable_and_seeded():
    cfg = LlamaConfig.tiny(dtype="bfloat16")
    a = init_train_params(cfg, seed=3, device="cpu")
    b = init_train_params(cfg, seed=3, device="cpu")
    assert all(isinstance(v, torch.nn.Parameter) and v.requires_grad
               and v.dtype == torch.bfloat16 for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    model = LlamaForCausalLM(cfg).load_params(a, trainable=True)
    # the dict's Parameters are the module's own, so their .grad fills
    assert model.lm_head.weight is a["lm_head.weight"]
    if not torch.cuda.is_available():     # the step defaults to the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(model, lambda lg, lb: lg.sum(), None)


@pytest.mark.parametrize("name", ["ClipGradByGlobalNorm", "ClipGradByNorm",
                                  "ClipGradByValue"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_clips_match_jax(name, dtype):
    """The clips on the same gradients (norms above and below the bound):
    f32 atol 1e-6; bf16 results are the same f32 product rounded once,
    so equal."""
    rng = np.random.default_rng(9)
    gs = [rng.standard_normal(shape).astype(np.float32) * scale
          for shape, scale in (((4, 5), 3.0), ((7,), 0.01), ((3, 3), 1.0))]
    arg = 0.5 if name == "ClipGradByValue" else 1.0
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    ref = getattr(jax_clip, name)(arg).apply([jnp.asarray(g, jd) for g in gs])
    got = getattr(clip, name)(arg).apply([torch.from_numpy(g).to(td)
                                          for g in gs])
    for g, r in zip(got, ref):
        assert g.dtype == td
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32),
                                   atol=1e-6 if dtype == "float32" else 0)


@pytest.mark.parametrize("name,kw", [
    ("StepDecay", dict(learning_rate=0.1, step_size=3, gamma=0.5)),
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=10)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=4, start_lr=0.0,
                          end_lr=0.1)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=20)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=5, cycle=True)),
])
def test_lr_schedulers_match_jax(name, kw):
    """The port's copy of the schedulers gives JAX's learning rates,
    exactly, over 15 steps."""
    j, t = getattr(jax_lr, name)(**kw), getattr(port_lr, name)(**kw)
    for _ in range(15):
        assert t() == j()
        j.step()
        t.step()


def test_lr_schedule_through_train_step_matches_jax():
    """A StepDecay inside AdamW through make_train_step(optimizer=):
    FusedOptimizer ticks the schedule once per step, as in JAX."""
    jm, tm = _models(seed=10)
    x, y = _batch(seed=10)
    runs = []
    for m, opt_cls, lr_mod, make in (
            (jm, JaxAdamW, jax_lr, jax_make_train_step),
            (tm, AdamW, port_lr, make_train_step)):
        sched = lr_mod.StepDecay(learning_rate=LR, step_size=2, gamma=0.1)
        opt = opt_cls(learning_rate=sched, weight_decay=0.01,
                      apply_decay_param_fun=_decay, parameters=m.parameters())
        crit = (JaxCriterion if m is jm else LlamaPretrainingCriterion)()
        kw = {} if m is jm else {"device": "cpu"}
        step, p, s = make(m, lambda lg, lb, c=crit: c(lg, lb), None,
                          optimizer=opt, **kw)
        losses = []
        for _ in range(4):
            loss, p, s = step(p, s, *((jnp.asarray(x), jnp.asarray(y))
                                      if m is jm else (x, y)))
            losses.append(float(loss))
        assert sched() == pytest.approx(LR * 0.01)
        runs.append(losses)
    np.testing.assert_allclose(runs[1], runs[0], atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("multi_precision", [False, True])
@pytest.mark.parametrize("decoupled", [False, True], ids=["adam", "adamw"])
def test_update_rule_on_bf16_matches_jax(multi_precision, decoupled):
    """Adam / AdamW's per-tensor rule on a bf16 param over three steps:
    without multi_precision the param is updated in f32 from its bf16
    value and rounded back (no master copy); with it an f32 master
    carries the update. f32 state atol 1e-6; the bf16 param within one
    bf16 step (the same f32 update, rounded once)."""
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal((8, 16)).astype(np.float32)
    grads = [rng.standard_normal((8, 16)).astype(np.float32)
             for _ in range(3)]
    jcls, tcls = (JaxAdamW, AdamW) if decoupled else (JaxAdam, Adam)
    jp = paddle.to_tensor(jnp.asarray(p0, jnp.bfloat16))
    tp = torch.nn.Parameter(torch.from_numpy(p0).to(torch.bfloat16))
    jopt = jcls(learning_rate=LR, parameters=[jp],
                multi_precision=multi_precision)
    topt = tcls(learning_rate=LR, parameters=[tp],
                multi_precision=multi_precision)
    ja, js = jp._array, jopt._create_accumulators(jp)
    ta, ts = tp.detach(), topt._create_accumulators(tp)
    assert set(ts) == set(js)
    for step, g in enumerate(grads, start=1):
        ja, js = jopt._update_rule_arr(ja, jnp.asarray(g, jnp.bfloat16), js,
                                       LR, 0.01, step)
        ta, ts = topt._update_rule_arr(ta, torch.from_numpy(g).to(
            torch.bfloat16), ts, LR, 0.01, step)
    assert ta.dtype == torch.bfloat16
    ref = np.asarray(ja, np.float32)
    err = np.abs(ta.float().numpy() - ref)
    assert (err <= 2.0 ** -7 * np.maximum(np.abs(ref), 1.0)).all()
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=1e-6, rtol=0)
