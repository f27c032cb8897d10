"""The port's static memory auditor (paddle_tpu_torch/analysis/memory.py)
against the JAX package's (twins of tests/test_memory_audit.py): the
liveness peak, views, in-place updates where JAX donates, the
TPU701/702/703 rules, the engine's audit (warm(audit_memory=), the flag
composition, the programs= filter) and fit's.

The port updates pools in place where the JAX programs donate them: the
in-place / out-of-place pair of a toy decode chunk twins JAX's donated /
undonated pair. Every trace runs on fake tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis import memory as jmemory
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.analysis import analyze, audit_memory, memory
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.serving import ContinuousBatchingEngine

N_PAGES = 128           # a 128-page pool of [2, 16, 16] f32 = 256 KiB


def diags(report, rule):
    return [d for d in report if d.rule == rule]


def _jax_chunk(steps=4):
    def chunk(pool, tok):
        def body(carry, _):
            pool, tok = carry
            pool = pool.at[tok % N_PAGES].set(pool[tok % N_PAGES] + 1.0)
            return (pool, tok + 1), tok

        (pool, tok), ys = jax.lax.scan(body, (pool, tok), None,
                                       length=steps)
        return pool, ys

    return chunk


def _port_chunk(in_place, steps=4):
    """The toy decode chunk: one page of the pool updated per step, in
    place (the port's programs) or out of place (returned)."""
    def chunk(pool, tok):
        for _ in range(steps):
            i = (tok % N_PAGES).reshape(1)
            if in_place:
                pool.index_put_((i,), pool[i] + 1.0)
            else:
                pool = pool.index_put((i,), pool[i] + 1.0)
            tok = tok + 1
        return (tok,) if in_place else (pool, tok)

    return chunk


def _pool():
    return np.zeros((N_PAGES, 2, 16, 16), np.float32)


def test_peak_simple_chain_equals_jax():
    def f(x):
        return x * 2.0 + 1.0

    t = audit_memory(f, torch.zeros(256))
    j = jmemory.audit_memory(f, jnp.zeros((256,), jnp.float32))
    assert t.peak_bytes == j.peak_bytes == 3 * 256 * 4
    assert t.n_eqns == j.n_eqns == 2


def test_dead_value_freed_equals_jax():
    def f(x):
        z = x * 2.0 + 1.0
        for _ in range(4):
            z = z + 1.0
        return z

    t = audit_memory(f, torch.zeros(256))
    j = jmemory.audit_memory(f, jnp.zeros((256,), jnp.float32))
    assert t.peak_bytes == j.peak_bytes == 3 * 256 * 4


def test_in_place_pool_counted_once():
    """The twin of JAX's donated pool: updated in place, the pool counts
    once and as donated, with no miss. (The JAX side is not asserted
    here: whether its trace recovers the donation depends on the
    installed jax.)"""
    pool = _pool()
    t = audit_memory(_port_chunk(True), torch.from_numpy(pool),
                     torch.tensor(0))
    assert t.peak_bytes < 1.2 * pool.nbytes
    assert t.donation["donated_bytes"] == pool.nbytes
    assert not [m for m in t.donation["misses"] if m["bytes"] == pool.nbytes]


def test_out_of_place_pool_doubles_and_reports_miss_as_jax_undonated():
    pool = _pool()
    t = audit_memory(_port_chunk(False), torch.from_numpy(pool),
                     torch.tensor(0))
    j = jmemory.audit_memory(jax.jit(_jax_chunk()), jnp.asarray(pool),
                             jnp.asarray(0))
    for rep in (t, j):
        assert rep.peak_bytes >= 2 * pool.nbytes
        misses = [m for m in rep.donation["misses"]
                  if m["bytes"] == pool.nbytes]
        assert len(misses) == 1 and misses[0]["input_index"] == 0


@pytest.mark.parametrize("view", ["reshape", "select", "slice", "expand",
                                  "t"])
def test_views_alias_their_base(view):
    nb = 64 * 32 * 4
    fns = {"reshape": lambda x: x.reshape(64, 32).sum(1),
           "select": lambda x: x.reshape(64, 32)[3] * 2,
           "slice": lambda x: x[100:1900] * 2,
           "expand": lambda x: x.reshape(1, 2048).expand(4, 2048).sum(),
           "t": lambda x: x.reshape(64, 32).t().sum(0)}
    rep = audit_memory(fns[view], torch.zeros(2048))
    assert rep.peak_bytes < 2 * nb
    if view == "reshape":
        j = jmemory.audit_memory(lambda x: (jnp.sum(x.reshape(64, 32), 1),
                                            x), jnp.zeros((2048,)))
        assert j.peak_bytes < 2 * nb


def test_report_json_schema_equals_jax():
    pool = _pool()
    t = audit_memory(_port_chunk(True), torch.from_numpy(pool),
                     torch.tensor(0))
    j = jmemory.audit_memory(jax.jit(_jax_chunk(), donate_argnums=(0,)),
                             jnp.asarray(pool), jnp.asarray(0))
    dt, dj = t.to_dict(), j.to_dict()
    assert set(dt) == set(dj)
    assert set(dt["donation"]) == set(dj["donation"])
    assert set(dt["peak_buffers"][0]) == set(dj["peak_buffers"][0])
    assert set(dt["timeline"][0]) == set(dj["timeline"][0])
    assert t.to_json() == audit_memory(
        _port_chunk(True), torch.from_numpy(pool), torch.tensor(0)).to_json()


def test_tpu701_fires_out_of_place_and_is_silent_in_place():
    pool = torch.from_numpy(_pool())
    bad = analyze(_port_chunk(False), pool, torch.tensor(0),
                  rules=["TPU701"])
    good = analyze(_port_chunk(True), pool, torch.tensor(0),
                   rules=["TPU701"])
    assert diags(bad, "TPU701") and not diags(good, "TPU701")
    assert diags(bad, "TPU701")[0].severity.name == "ERROR"


def test_tpu702_budget_fires_over_and_silent_under():
    pool = torch.from_numpy(_pool())
    args = (_port_chunk(True), pool, torch.tensor(0))
    over = analyze(*args, rules=["TPU702"],
                   rule_config={"TPU702.hbm_budget_bytes": 1024})
    under = analyze(*args, rules=["TPU702"],
                    rule_config={"TPU702.hbm_budget_bytes": 1 << 30})
    off = analyze(*args, rules=["TPU702"],
                  rule_config={"TPU702.hbm_budget_bytes": 0})
    assert diags(over, "TPU702") and not diags(under, "TPU702")
    assert not diags(off, "TPU702")
    with pytest.raises(ValueError, match="integer byte count"):
        analyze(*args, rules=["TPU702"],
                rule_config={"TPU702.hbm_budget_bytes": "lots"})


def test_tpu703_long_lived_intermediate():
    def f(x):
        big = x * 2.0                   # 1 MiB, read again at the end
        y = x
        for _ in range(200):
            y = y + 1.0
        return y + big

    def g(x):
        y = x
        for _ in range(200):
            y = y + 1.0
        return y + x * 2.0

    x = torch.zeros(1 << 18)
    assert diags(analyze(f, x, rules=["TPU703"]), "TPU703")
    assert not diags(analyze(g, x, rules=["TPU703"]), "TPU703")


# ---------------------------------------------------------------------------
# the engine's and fit's audits
# ---------------------------------------------------------------------------

KW = dict(slots=2, prompt_bucket=16, max_prompt_len=32, max_new_tokens=8,
          block_size=16, steps_per_sync=4, unified_step=False,
          decode_megakernel="off")


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxConfig.tiny()
    paddle.seed(0)
    raw = dict(JaxModel(jcfg).raw_state())
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    port = ContinuousBatchingEngine(LlamaConfig.tiny(), p, device="cpu",
                                    dtype=torch.float32, **KW)
    port.warm(buckets=[16, 32])
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, **KW)
    jeng.warm([16, 32])
    return port, jeng


def test_decode_peak_within_10pct_of_params_and_pools(engines):
    port, jeng = engines
    ref = memory.pytree_local_bytes(port.p) \
        + memory.pytree_local_bytes((port.kcs, port.vcs))
    rep = port.audit_memory(programs=["decode"])
    peak = rep["programs"]["decode"]["peak_hbm_bytes"]
    assert abs(peak - ref) / ref <= 0.10, (peak, ref)
    # the JAX reference's hand count: the same params and pools, in f32
    jref = jmemory.pytree_local_bytes(jeng.p) \
        + jmemory.pytree_local_bytes((jeng.kcs, jeng.vcs))
    assert ref == jref


def test_engine_audit_is_clean_and_lands_on_metrics(engines):
    port, jeng = engines
    fleet = port.audit_memory()
    assert fleet["programs_audited"] == len(port.compile_stats())
    assert set(fleet["programs"]) == set(jeng.audit_memory()["programs"])
    assert fleet["donation_clean"] and not fleet["partial"]
    for prog in fleet["programs"].values():
        assert prog["donation_coverage"] == 1.0 and prog["donated_bytes"]
        assert not [d for d in prog["diagnostics"] if d["rule"] == "TPU701"]
    assert port.metrics()["memory_audit"] is fleet
    keys = set(jeng.audit_memory())
    assert set(fleet) == keys


def test_programs_filter_is_partial_and_raises_on_unknown(engines):
    port, _ = engines
    full = port.audit_memory()
    part = port.audit_memory(programs=["decode"])
    assert part["partial"] and list(part["programs"]) == ["decode"]
    assert port.metrics()["memory_audit"] is full
    with pytest.raises(ValueError, match="not in the inventory"):
        port.audit_memory(programs=["decoed"])


def test_warm_audits_off_by_default_and_flag_composition():
    p = params_from_jax({k: np.asarray(v) for k, v in dict(
        JaxModel(JaxConfig.tiny()).raw_state()).items()}, device="cpu")

    def engine():
        return ContinuousBatchingEngine(LlamaConfig.tiny(), p, device="cpu",
                                        dtype=torch.float32, **KW)

    eng = engine()
    eng.warm(buckets=[16])
    assert eng.metrics()["memory_audit"] is None
    assert eng.metrics()["roofline_audit"] is None
    for flags, mem, roof in (({"audit_memory": True}, True, False),
                             ({"tpu_lint": True}, True, True)):
        set_flags(flags)
        try:
            eng = engine()
            eng.warm(buckets=[16])
        finally:
            set_flags({k: False for k in flags})
        assert (eng.metrics()["memory_audit"] is not None) == mem
        assert (eng.metrics()["roofline_audit"] is not None) == roof
    # an explicit False wins over the flags
    set_flags({"tpu_lint": True})
    try:
        eng = engine()
        eng.warm(buckets=[16], audit_memory=False, audit_roofline=False)
    finally:
        set_flags({"tpu_lint": False})
    assert eng.metrics()["memory_audit"] is None


def test_audit_comms_is_refused_naming_item_5(engines):
    """The communication audit is ported (the item 5 refusal is gone): a
    one-device engine audits to zero collectives through audit_comms(),
    warm(audit_comms=True) and FLAGS_audit_comms, sharing the memory
    audit's trace (tests/test_torch_comms_audit.py holds the sharded
    engines)."""
    port, _ = engines
    rep = port.audit_comms()
    assert rep["total_bytes_on_wire"] == 0 and rep["comms_clean"]
    port._comms_audit = None
    port.warm(buckets=[16], audit_comms=True, audit_memory=True)
    assert port.metrics()["comms_audit"]["programs_audited"] \
        == port.metrics()["memory_audit"]["programs_audited"]
    port._comms_audit = None
    set_flags({"audit_comms": True})
    try:
        port.warm(buckets=[16])
    finally:
        set_flags({"audit_comms": False})
    assert port.metrics()["comms_audit"]["n_diagnostics"] == 0


def _fit_model(seed=0):
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion,
                                         init_train_params)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    net = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, seed, "cpu"), trainable=True)
    model = hapi.Model(net, device="cpu")
    model.prepare(AdamW(1e-3, parameters=net.named_parameters()),
                  LlamaPretrainingCriterion(cfg))
    return model


def test_fit_audit_touches_nothing_and_keeps_the_first_step():
    """fit(audit_memory=True, audit_roofline=True) traces the step on
    fakes: the parameters are bitwise untouched by the audit, and the
    trained step equals a run without it; the reports land on the
    model."""
    rng = np.random.default_rng(1)
    ids = rng.integers(1, LlamaConfig.tiny().vocab_size, (2, 33))
    batch = [(torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:]))]
    audited, plain = _fit_model(), _fit_model()
    before = {k: v.clone() for k, v in audited.network.state_dict().items()}
    ins, labs = audited._split_batch(batch[0])
    audited._audit_step(ins, labs, True, True)
    assert all(torch.equal(v, before[k])
               for k, v in audited.network.state_dict().items())
    assert audited._optimizer._accumulators == {}
    audited.fit(batch, epochs=1, verbose=0, audit_memory=True,
                audit_roofline=True)
    plain.fit(batch, epochs=1, verbose=0)
    for a, b in zip(audited.network.state_dict().values(),
                    plain.network.state_dict().values()):
        assert torch.equal(a, b)
    mem = audited.memory_audit
    assert mem["peak_hbm_bytes"] > 0 and "diagnostics" in mem
    assert not [d for d in mem["diagnostics"] if d["rule"] == "TPU701"]
    assert audited.roofline_audit["kernels"]["flash_attention_bwd_dq"] == 1
    assert plain.memory_audit is None and plain.roofline_audit is None
