"""The port's trainer API (paddle_tpu_torch.hapi, io, metric, the
optimizer's state, framework.io) against the JAX package's, on the CPU.

The same numpy batches go through JAX's ``paddle.Model`` and the port's
``hapi.Model``:

- ``tiny()`` Llama in f32 cut to one layer, the port's weights from the
  JAX model's by ``params_from_jax``: fit for 2 epochs x 3 steps (AdamW,
  bench's decay rule), then evaluate and predict on one batch. One JAX
  run serves the file: JAX's eager ``paddle.Model`` takes 5-7 s a step
  here at tiny()'s two layers, which would put the file past 60 s, so
  the cut halves it; the trainer loop under test does not depend on the
  depth. Tolerances: every step's
  loss and the evaluate loss atol 1e-4 (as tests/test_torch_train.py:
  Adam's sign-like first steps drift by more than one forward's 1e-5),
  predict's logits atol 1e-3 (the same drift, six steps on);
- ``accumulate_grad_batches=2`` and the callbacks (the hook order,
  EarlyStopping, LRScheduler, ModelCheckpoint) on a 4 -> 1 linear model
  in paddle's layout: losses rtol 1e-5, hook lists and file lists equal;
- Accuracy / Precision / Recall / Auc / accuracy(): equal (the same
  numpy arithmetic on the host; Accuracy's top-k on torch);
- BatchSampler / DistributedBatchSampler(shuffle=False): equal index
  lists;
- the optimizer's state_dict: JAX's keys, and a round trip both ways
  byte-equal;
- Model.save / load: JAX's ``paddle.load(return_numpy=True)`` reads the
  port's .pdparams byte-equal, and the port's load keeps every
  parameter's identity;
- summary's counts equal; the refused trainer options raise.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import hapi, io, metric, set_flags
from paddle_tpu_torch.framework.io import load as port_load
from paddle_tpu_torch.framework.io import save as port_save
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     params_from_jax)
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as port_lr

LR = 1e-3
LOSS_ATOL = 1e-4
TINY_OVER = {"num_hidden_layers": 1}


def _port_cfg():
    return dataclasses.replace(LlamaConfig.tiny(), **TINY_OVER)


def _decay(name: str) -> bool:
    # bench.py's apply_decay_param_fun
    return "norm" not in name and not name.endswith(".b_0")


def _llama_batches(vocab, n=3, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (b, s)), rng.integers(0, vocab, (b, s)))
            for _ in range(n)]


class _PortTape(hapi.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


class _JaxTape(paddle.hapi.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


@pytest.fixture(scope="module")
def llama_runs():
    """One JAX and one port fit / evaluate / predict of tiny() Llama in
    f32 from the same weights and batches."""
    cfg = dataclasses.replace(JaxConfig.tiny(), **TINY_OVER)
    paddle.seed(0)
    jm = JaxModel(cfg)
    np_params = {k: np.array(v) for k, v in jm.raw_state().items()}
    batches = _llama_batches(cfg.vocab_size)

    jmodel = paddle.Model(jm)
    jcrit = JaxCriterion(cfg)
    jmodel.prepare(optimizer=jopt.AdamW(LR, weight_decay=0.01,
                                        apply_decay_param_fun=_decay,
                                        parameters=jm.parameters()),
                   loss=lambda lg, lb: jcrit(lg, lb))
    jtape = _JaxTape()
    jmodel.fit(batches, epochs=2, verbose=0, callbacks=[jtape])
    jeval = jmodel.evaluate(batches[:1], verbose=0)
    jpred = jmodel.predict(batches[:1])

    pcfg = _port_cfg()
    net = LlamaForCausalLM(pcfg).load_params(
        params_from_jax(np_params, device="cpu"), trainable=True)
    pmodel = hapi.Model(net, device="cpu")
    pmodel.prepare(optimizer=AdamW(LR, weight_decay=0.01,
                                   apply_decay_param_fun=_decay,
                                   parameters=net.named_parameters()),
                   loss=LlamaPretrainingCriterion(pcfg))
    ptape = _PortTape()
    pmodel.fit(batches, epochs=2, verbose=0, callbacks=[ptape])
    peval = pmodel.evaluate(batches[:1], verbose=0)
    ppred = pmodel.predict(batches[:1])
    return dict(batches=batches, np_params=np_params, jmodel=jmodel,
                pmodel=pmodel, jlosses=jtape.losses, plosses=ptape.losses,
                jeval=jeval, peval=peval, jpred=jpred, ppred=ppred)


def test_llama_fit_matches_jax(llama_runs):
    r = llama_runs
    assert len(r["plosses"]) == 6
    np.testing.assert_allclose(r["plosses"], r["jlosses"], atol=LOSS_ATOL,
                               rtol=0)


def test_llama_evaluate_and_predict_match_jax(llama_runs):
    r = llama_runs
    np.testing.assert_allclose(r["peval"]["loss"], r["jeval"]["loss"],
                               atol=LOSS_ATOL, rtol=0)
    (pout,), (jout,) = r["ppred"], r["jpred"]
    assert isinstance(pout[0], np.ndarray) and pout[0].dtype == np.float32
    assert pout[0].shape == jout[0].shape == (2, 32, 128)
    np.testing.assert_allclose(pout[0], jout[0], atol=1e-3, rtol=0)


def test_optimizer_state_dict_keys_and_round_trips(llama_runs):
    r = llama_runs
    jsd = r["jmodel"]._optimizer.state_dict()
    psd = r["pmodel"]._optimizer.state_dict()
    assert sorted(psd) == sorted(jsd)
    assert psd["global_step"] == jsd["global_step"] == 6
    # port -> port: a fresh optimizer over a fresh model, byte-equal
    net = LlamaForCausalLM(_port_cfg()).load_params(
        params_from_jax(r["np_params"], device="cpu"), trainable=True)
    opt = AdamW(LR, parameters=net.named_parameters())
    opt.set_state_dict(psd)
    back = opt.state_dict()
    assert sorted(back) == sorted(psd)
    for k, v in psd.items():
        if isinstance(v, torch.Tensor):
            assert back[k].dtype == torch.float32 and torch.equal(back[k], v)
    # JAX -> port: its moments (numpy) load under the same keys
    opt.set_state_dict({k: (np.asarray(v.numpy()) if hasattr(v, "numpy")
                            else v) for k, v in jsd.items()})
    for k, v in jsd.items():
        if k.startswith("param_"):
            np.testing.assert_array_equal(opt.state_dict()[k].numpy(),
                                          np.asarray(v.numpy()))


def test_summary_counts_match_jax(llama_runs):
    r = llama_runs
    n = sum(v.size for v in r["np_params"].values())
    assert r["pmodel"].summary() == paddle.hapi.summary(
        r["jmodel"].network) == {"total_params": n, "trainable_params": n}


def test_resume_and_load_keep_parameter_identity(llama_runs, tmp_path):
    r = llama_runs
    net = LlamaForCausalLM(_port_cfg()).load_params(
        params_from_jax(r["np_params"], device="cpu"), trainable=True)
    model = hapi.Model(net, device="cpu")
    model.prepare(optimizer=AdamW(LR, parameters=net.named_parameters()),
                  loss=LlamaPretrainingCriterion())
    model.fit(r["batches"], epochs=1, verbose=0,
              checkpoint_dir=str(tmp_path / "ck"))
    model.save(str(tmp_path / "m" / "final"))
    fresh = LlamaForCausalLM(_port_cfg()).load_params(
        params_from_jax({k: np.zeros_like(v) for k, v in
                         r["np_params"].items()}, device="cpu"),
        trainable=True)
    other = hapi.Model(fresh, device="cpu")
    opt = AdamW(LR, parameters=fresh.named_parameters())
    other.prepare(optimizer=opt, loss=LlamaPretrainingCriterion())
    ids = {n: id(p) for n, p in fresh.named_parameters()}
    other.fit(r["batches"], epochs=1, verbose=0,
              checkpoint_dir=str(tmp_path / "ck"), resume=True)
    assert other.restored_generation == 1
    assert ids == {n: id(p) for n, p in fresh.named_parameters()}
    for (n, p), (_, q) in zip(net.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(p, q), n
        st = opt._accumulators[id(q)]
        assert st["moment1"].dtype == torch.float32
    fresh2 = LlamaForCausalLM(_port_cfg()).load_params(
        params_from_jax(r["np_params"], device="cpu"), trainable=True)
    third = hapi.Model(fresh2, device="cpu")
    third.prepare(optimizer=AdamW(LR, parameters=fresh2.named_parameters()),
                  loss=LlamaPretrainingCriterion())
    ids = [id(p) for p in fresh2.parameters()]
    third.load(str(tmp_path / "m" / "final"))
    assert ids == [id(p) for p in fresh2.parameters()]
    assert all(torch.equal(p, q) for p, q in zip(net.parameters(),
                                                 fresh2.parameters()))
    assert third._optimizer._global_step == 3


# ---------------------------------------------------------------------------
# a 4 -> 1 linear model in paddle's layout, in both packages
# ---------------------------------------------------------------------------

class _Lin(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x):
        return x @ self.weight + self.bias


def _lin_init():
    rng = np.random.default_rng(11)
    return (rng.uniform(-0.5, 0.5, (4, 1)).astype(np.float32),
            np.zeros(1, np.float32))


def _lin_batches(n=8):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 1)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(4, 4)).astype(np.float32)
        out.append((x, (x @ w).astype(np.float32)))
    return out


def _models(lr=0.01):
    """(jax Model, port Model) over the same linear weights, Adam(lr)
    (a number or a (jax, port) pair of schedulers)."""
    w, b = _lin_init()
    jnet = jnn.Linear(4, 1)
    jnet.set_state_dict({"weight": w, "bias": b})
    jlr, plr = lr if isinstance(lr, tuple) else (lr, lr)
    jm = paddle.Model(jnet)
    jm.prepare(optimizer=jopt.Adam(learning_rate=jlr,
                                   parameters=jnet.parameters()),
               loss=lambda p, l: jnn.MSELoss()(p, l))
    pnet = _Lin(w, b)
    pm = hapi.Model(pnet, device="cpu")
    pm.prepare(optimizer=Adam(learning_rate=plr,
                              parameters=pnet.parameters()),
               loss=lambda p, l: torch.mean((p - l) ** 2))
    return jm, pm


def test_accumulate_grad_batches_matches_jax():
    jm, pm = _models()
    jt, pt = _JaxTape(), _PortTape()
    jm.fit(_lin_batches(), epochs=2, verbose=0, callbacks=[jt],
           accumulate_grad_batches=2)
    pm.fit(_lin_batches(), epochs=2, verbose=0, callbacks=[pt],
           accumulate_grad_batches=2)
    np.testing.assert_allclose(pt.losses, jt.losses, rtol=1e-5)
    assert pm._optimizer._global_step == jm._optimizer._global_step == 8
    np.testing.assert_allclose(pm.network.weight.detach().numpy(),
                               jm.network.weight.numpy(), rtol=1e-5)


def _recorder(base):
    hooks = ("on_train_begin", "on_train_end", "on_epoch_begin",
             "on_epoch_end", "on_train_batch_begin", "on_train_batch_end",
             "on_eval_begin", "on_eval_end", "on_eval_batch_begin",
             "on_eval_batch_end")

    class Rec(base):
        def __init__(self):
            super().__init__()
            self.calls = []

    def make(name):
        def hook(self, *args, logs=None):
            self.calls.append((name,) + tuple(
                a for a in args if isinstance(a, int)))
        return hook

    for h in hooks:
        setattr(Rec, h, make(h))
    return Rec()


def test_callback_order_matches_jax():
    jm, pm = _models()
    jr, pr = _recorder(paddle.hapi.Callback), _recorder(hapi.Callback)
    data = _lin_batches(3)
    jm.fit(data, eval_data=data[:2], epochs=2, verbose=0, callbacks=[jr])
    pm.fit(data, eval_data=data[:2], epochs=2, verbose=0, callbacks=[pr])
    assert pr.calls == jr.calls and len(pr.calls) > 20


def test_early_stopping_matches_jax():
    jm, pm = _models()
    data = _lin_batches(3)
    # mode="max" on a falling eval loss: the second eval does not improve
    jm.fit(data, eval_data=data[:2], epochs=5, verbose=0, callbacks=[
        paddle.hapi.EarlyStopping(monitor="loss", mode="max", patience=1,
                                  verbose=0)])
    jt, pt = _JaxTape(), _PortTape()
    pm.fit(data, eval_data=data[:2], epochs=5, verbose=0, callbacks=[
        hapi.EarlyStopping(monitor="loss", mode="max", patience=1,
                           verbose=0), pt])
    assert pm.stop_training and jm.stop_training
    assert len(pt.losses) == 6  # two epochs of 3, then stopped


def test_lr_scheduler_callback_matches_jax():
    jsched = jopt.lr.StepDecay(learning_rate=0.05, step_size=2, gamma=0.5)
    psched = port_lr.StepDecay(learning_rate=0.05, step_size=2, gamma=0.5)
    jm, pm = _models((jsched, psched))
    jt, pt = _JaxTape(), _PortTape()
    jm.fit(_lin_batches(), epochs=1, verbose=0,
           callbacks=[paddle.hapi.LRScheduler(by_step=True), jt])
    pm.fit(_lin_batches(), epochs=1, verbose=0,
           callbacks=[hapi.LRScheduler(by_step=True), pt])
    assert pm._optimizer.get_lr() == jm._optimizer.get_lr() == 0.05 / 16
    np.testing.assert_allclose(pt.losses, jt.losses, rtol=1e-5)


def test_model_checkpoint_callback_matches_jax(tmp_path):
    jm, pm = _models()
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jm.fit(_lin_batches(2), epochs=3, verbose=0,
           callbacks=[paddle.hapi.ModelCheckpoint(save_freq=2,
                                                  save_dir=jd)])
    pm.fit(_lin_batches(2), epochs=3, verbose=0,
           callbacks=[hapi.ModelCheckpoint(save_freq=2, save_dir=pd)])
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == [
        "0.pdopt", "0.pdparams", "2.pdopt", "2.pdparams", "final.pdopt",
        "final.pdparams"]
    # JAX reads the port's file, and the port JAX's
    got = paddle.load(os.path.join(pd, "final.pdparams"), return_numpy=True)
    assert sorted(got) == ["bias", "weight"]
    np.testing.assert_array_equal(got["weight"],
                                  pm.network.weight.detach().numpy())
    back = port_load(os.path.join(jd, "final.pdparams"))
    np.testing.assert_allclose(back["weight"].detach().numpy(),
                               jm.network.weight.numpy(), rtol=1e-5)


def test_save_load_pickle_layout_both_ways(tmp_path):
    t = {"w": torch.nn.Parameter(torch.arange(6.0).reshape(2, 3)),
         "b16": torch.arange(4, dtype=torch.bfloat16),
         "i": torch.arange(3), "n": 7, "nest": [torch.ones(2), ("x", 1.5)]}
    path = str(tmp_path / "a.pdparams")
    port_save(t, path)
    got = paddle.load(path, return_numpy=True)
    np.testing.assert_array_equal(got["w"], np.arange(6.0, dtype=np.float32)
                                  .reshape(2, 3))
    np.testing.assert_array_equal(got["b16"], np.arange(4, dtype=np.float32))
    assert got["n"] == 7 and got["nest"][1] == ("x", 1.5)
    back = port_load(path)
    assert back["w"].requires_grad and torch.equal(back["w"], t["w"])
    assert back["b16"].dtype == torch.bfloat16
    assert torch.equal(back["b16"], t["b16"])
    assert torch.equal(back["i"], t["i"])
    jpath = str(tmp_path / "j.pdparams")
    paddle.save({"w": paddle.to_tensor(np.full((2, 2), 3.0, np.float32))},
                jpath)
    assert torch.equal(port_load(jpath)["w"], torch.full((2, 2), 3.0))


# ---------------------------------------------------------------------------
# metrics, samplers, the loader
# ---------------------------------------------------------------------------

def test_metrics_equal_jax():
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((64, 10)).astype(np.float32)
    label = rng.integers(0, 10, (64, 1))
    jacc, pacc = jmetric.Accuracy(topk=(1, 3)), metric.Accuracy(topk=(1, 3))
    for sl in (slice(0, 40), slice(40, 64)):
        jr = jacc.update(jacc.compute(pred[sl], label[sl]))
        pr = pacc.update(pacc.compute(torch.from_numpy(pred[sl]),
                                      torch.from_numpy(label[sl])))
        assert pr == jr
    assert pacc.accumulate() == jacc.accumulate()
    assert pacc.name() == jacc.name() == ["acc_top1", "acc_top3"]
    prob = rng.uniform(size=(200, 1)).astype(np.float32)
    bl = rng.integers(0, 2, (200, 1))
    for J, P in ((jmetric.Precision, metric.Precision),
                 (jmetric.Recall, metric.Recall)):
        j, p = J(), P()
        j.update(prob, bl)
        p.update(torch.from_numpy(prob), torch.from_numpy(bl))
        assert p.accumulate() == j.accumulate()
    j, p = jmetric.Auc(), metric.Auc()
    two = np.concatenate([1 - prob, prob], axis=1)
    j.update(two, bl)
    p.update(torch.from_numpy(two), torch.from_numpy(bl))
    assert p.accumulate() == j.accumulate() and 0.0 < p.accumulate() < 1.0
    for k in (1, 2):
        got = metric.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                              k=k)
        want = jmetric.accuracy(pred, label, k=k)
        assert got.shape == (1,) and got.dtype == torch.float32
        assert float(got[0]) == float(np.asarray(want.numpy())[0])


@pytest.mark.parametrize("n,bs,drop", [(10, 3, False), (10, 3, True),
                                       (8, 4, False)])
def test_batch_samplers_equal_jax(n, bs, drop):
    data = list(range(n))
    assert list(io.BatchSampler(data, batch_size=bs, drop_last=drop)) == \
        list(jio.BatchSampler(data, batch_size=bs, drop_last=drop))
    for nranks in (1, 2, 3):
        for rank in range(nranks):
            kw = dict(num_replicas=nranks, rank=rank, drop_last=drop)
            p = io.DistributedBatchSampler(data, bs, **kw)
            j = jio.DistributedBatchSampler(data, bs, **kw)
            assert list(p) == list(j) and len(p) == len(j)


def test_loader_collates_torch_and_prefetches_in_order():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10)
    ds = io.TensorDataset([torch.from_numpy(x), y])
    single = list(io.DataLoader(ds, batch_size=3))
    assert isinstance(single[0][0], torch.Tensor)
    assert single[0][1].dtype == torch.int64 and len(single) == 4
    threads = list(io.DataLoader(ds, batch_size=3, num_workers=2,
                                 use_shared_memory=False))
    assert all(torch.equal(a, b) for s, t in zip(single, threads)
               for a, b in zip(s, t))
    jbatches = list(jio.DataLoader(jio.TensorDataset([x, y]), batch_size=3))
    for (px, py), (jx, jy) in zip(single, jbatches):
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx.numpy()))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy.numpy()))
    # the shared-memory worker processes are not ported: no quiet fallback
    with pytest.raises(NotImplementedError, match="shared-memory"):
        iter(io.DataLoader(ds, batch_size=3, num_workers=2))
    g = torch.Generator().manual_seed(0)
    parts = io.random_split(ds, [6, 4], generator=g)
    assert sorted(parts[0].indices + parts[1].indices) == list(range(10))


# ---------------------------------------------------------------------------
# what the trainer refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,flags,match", [
    ({"audit_memory": True}, {}, "item 6"),
    ({"audit_comms": True}, {}, "item 6"),
    ({"audit_roofline": True}, {}, "item 6"),
    ({}, {"tpu_lint": True}, "item 6"),
    ({}, {"audit_roofline": True}, "item 6"),
    ({"quantized_collectives": True}, {}, "item 5"),
    ({}, {"quantized_collectives": True}, "item 5"),
])
def test_refused_trainer_options_raise(kw, flags, match):
    _, pm = _models()
    set_flags(flags)
    try:
        with pytest.raises(NotImplementedError, match=match):
            pm.fit(_lin_batches(2), epochs=1, verbose=0, **kw)
    finally:
        set_flags({k: False for k in flags})
    # an explicit False wins over the flags
    off = {k: False for k in (kw or flags)}
    if "tpu_lint" in off:
        off = dict.fromkeys(("audit_memory", "audit_comms",
                             "audit_roofline"), False)
    set_flags(flags)
    try:
        pm.fit(_lin_batches(1), epochs=1, verbose=0, **off)
    finally:
        set_flags({k: False for k in flags})


def test_model_device_must_hold_the_network():
    w, b = _lin_init()
    with pytest.raises(ValueError, match="lives on meta"):
        hapi.Model(_Lin(w, b).to("meta"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hapi.Model(_Lin(w, b))
