"""The port's static roofline auditor (paddle_tpu_torch/analysis/
roofline.py), its device table (device_specs.py, the H100 row) and
hapi.flops against the JAX package's (twins of
tests/test_roofline_audit.py).

Parity on LlamaConfig.tiny() in f32 at decode_megakernel="off", one
device: the products' FLOPs of the decode chunk, the cold prefills and a
train step equal the JAX programs' dot_general FLOPs exactly (JAX
amplifies its scan bodies by their length; the port's graphs unroll),
and the kernel nodes equal the JAX programs' pallas_call count where the
kernels correspond one to one (the port's delta pre-pass has no JAX
twin). HBM bytes differ by what each pass assumes, within the bounds the
tests state: the JAX pass models XLA fusion (an elementwise chain moves
no bytes), the port's runs every operator as a kernel of its own.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis import memory as jmemory
from paddle_tpu.analysis import roofline as jroofline
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.analysis import (analyze, audit_roofline,
                                       count_kernel_launches,
                                       kernel_launches, roofline,
                                       trace_graph)
from paddle_tpu_torch.analysis.device_specs import (DEVICE_SPECS,
                                                    auto_hbm_budget,
                                                    get_spec,
                                                    spec_for_device_kind)
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.serving import ContinuousBatchingEngine

H100 = DEVICE_SPECS["h100-sxm"]


def diags(report, rule):
    return [d for d in report if d.rule == rule]


# ---------------------------------------------------------------------------
# the device table
# ---------------------------------------------------------------------------

def test_h100_row_holds_the_published_figures():
    assert H100.peak_for("bfloat16") == H100.peak_for("float16") == 989e12
    assert H100.peak_for("int8") == H100.peak_for("float8_e4m3fn") \
        == 1979e12
    assert H100.peak_for("float32") == 67e12    # CUDA cores: no TF32
    assert H100.hbm_gbs == 3.35e12 and H100.ici_gbs == 900e9
    assert H100.hbm_bytes == 80 << 30 and H100.launch_overhead_s > 0
    assert set(DEVICE_SPECS) == {"h100-sxm", "cpu-container"}


def test_spec_resolution():
    assert spec_for_device_kind("NVIDIA H100 80GB HBM3") is H100
    assert get_spec("cpu-container") is DEVICE_SPECS["cpu-container"]
    assert get_spec(H100) is H100
    # the tracing host is no target: no card here resolves to the card row
    assert get_spec(None) is H100
    with pytest.raises(KeyError, match="h100-sxm"):
        get_spec("tpu-v5e")
    assert auto_hbm_budget("h100-sxm") == int((80 << 30) * 0.9)
    with pytest.raises(ValueError):
        auto_hbm_budget("h100-sxm", headroom=1.5)


# ---------------------------------------------------------------------------
# hand references
# ---------------------------------------------------------------------------

def test_matmul_hand_reference_equals_jax():
    t = audit_roofline(lambda x, w: x @ w, torch.zeros(128, 256),
                       torch.zeros(256, 512), device="h100-sxm")
    j = jroofline.audit_roofline(lambda x, w: x @ w,
                                 jnp.zeros((128, 256)), jnp.zeros((256, 512)),
                                 device="cpu-container")
    assert t.total_flops == j.total_flops == 2 * 128 * 256 * 512
    assert t.total_hbm_bytes == j.total_hbm_bytes \
        == (128 * 256 + 256 * 512 + 128 * 512) * 4
    assert t.kernel_launches == j.kernel_launches == 1
    assert t.padding_waste_flops == 0
    # 36.6 FLOP/B, above the H100 row's f32 ridge of 67e12 / 3.35e12 = 20
    assert t.bound == "compute"


def test_weight_only_gemv_counts_one_int8_weight_read():
    """The port's weight-only product at M <= 64 is one kernel node whose
    model reads the int8 weight once (the JAX dequant chain's contract),
    plus its f32 scales (the JAX dot reads them after the fused mul)."""
    from paddle_tpu_torch.kernels.int4_matmul import int8_weight_matmul

    x = torch.zeros(8, 256, dtype=torch.bfloat16)
    wq = torch.zeros(512, 256, dtype=torch.int8)
    sc = torch.zeros(512)
    t = audit_roofline(int8_weight_matmul, x, wq, sc)
    ker = [e for e in t.events if "paddle_tpu" in e.prim]
    assert len(ker) == 1 and ker[0].dtype == "int8"
    assert ker[0].hbm_bytes == 8 * 256 * 2 + 512 * 256 + 512 * 4 + 8 * 512 * 2

    def g(x, wq, sc):
        return jnp.einsum("mk,nk->mn", x, wq.astype(jnp.bfloat16)) * sc

    j = jroofline.audit_roofline(g, jnp.zeros((8, 256), jnp.bfloat16),
                                 jnp.zeros((512, 256), jnp.int8),
                                 jnp.zeros((512,), jnp.float32))
    dot = [e for e in j.events if e.prim == "dot_general"][0]
    assert ker[0].hbm_bytes - dot.hbm_bytes == 512 * 4
    assert ker[0].flops == dot.flops


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_paged_decode_counts_table_pages(pools):
    """Paged decode streams the B x W pages its table names, not the
    pool: the hand reference of JAX's test_gqa_paged_attention_counts_
    pool_pages and test_int8_paged_attention_prices_at_pool_dtype (FLOPs
    4·B·Hq·D·ctx; K and V pages, their scale rows on int8 pools, q in
    and out), plus the table and the lengths the port's model also
    counts; int8 pools price at int8."""
    from paddle_tpu_torch.kernels.decode_attention import (
        paged_decode_attention)

    int8 = pools == "int8"
    B, HQ, HKV, D, BS, W, P = 2, 4, 2, 128, 16, 2, 64
    dt = torch.int8 if int8 else torch.bfloat16
    args = [torch.zeros(P, HKV, BS, D, dtype=dt)] * 2 + [
        torch.zeros(B, W, dtype=torch.int32),
        torch.zeros(B, dtype=torch.int32)]
    kw = dict(k_scale=torch.zeros(P, HKV), v_scale=torch.zeros(P, HKV)) \
        if int8 else {}
    t = audit_roofline(lambda q: paged_decode_attention(q, *args, **kw),
                       torch.zeros(B, HQ, D, dtype=torch.bfloat16))
    ker = [e for e in t.events if "paddle_tpu" in e.prim]
    assert len(ker) == 1
    ctx = W * BS
    kv = 2 * B * ctx * HKV * D * (1 if int8 else 2) \
        + (2 * B * W * HKV * 4 if int8 else 0)
    assert ker[0].flops == 4 * B * HQ * D * ctx
    assert ker[0].hbm_bytes == kv + 2 * B * HQ * D * 2 + B * W * 4 + B * 4
    assert ker[0].hbm_bytes < 2 * P * HKV * BS * D
    assert ker[0].dtype == ("int8" if int8 else "bfloat16")


def test_prefix_prefill_counts_pages_not_the_pool():
    from paddle_tpu_torch.kernels.prefix_prefill import (
        prefix_prefill_attention)

    B, SB, NH, NKV, DH, BS, W, P = 2, 64, 4, 2, 128, 16, 4, 256
    q = torch.zeros(B, SB, NH, DH, dtype=torch.bfloat16)
    ksuf = torch.zeros(B, SB, NKV, DH, dtype=torch.bfloat16)
    kc = torch.zeros(P, NKV, BS, DH, dtype=torch.bfloat16)
    tbl = torch.zeros(B, W, dtype=torch.int32)
    plens = torch.full((B,), W * BS, dtype=torch.int32)
    t = audit_roofline(lambda q_: prefix_prefill_attention(
        q_, ksuf, ksuf, kc, kc, tbl, plens), q)
    ker = [e for e in t.events if "paddle_tpu" in e.prim][0]
    cached = 2 * B * W * BS * NKV * DH * 2
    assert ker.hbm_bytes == 2 * q.nbytes + 2 * ksuf.nbytes + cached \
        + tbl.nbytes + 2 * 4 * B
    assert ker.hbm_bytes < 2 * P * NKV * BS * DH * 2


def test_report_json_schema_holds_the_jax_keys():
    t = audit_roofline(lambda x, w: x @ w, torch.zeros(64, 64),
                       torch.zeros(64, 64))
    j = jroofline.audit_roofline(lambda x, w: x @ w, jnp.zeros((64, 64)),
                                 jnp.zeros((64, 64)), device="cpu-container")
    dt, dj = t.to_dict(), j.to_dict()
    assert set(dj) <= set(dt) and set(dt) - set(dj) == {"kernels"}
    assert set(dt["bottlenecks"][0]) == set(dj["bottlenecks"][0])
    assert t.to_json() == audit_roofline(
        lambda x, w: x @ w, torch.zeros(64, 64),
        torch.zeros(64, 64)).to_json()


def test_roofline_terms_and_a_custom_spec():
    t = audit_roofline(lambda x, w: x @ w, torch.zeros(128, 256),
                       torch.zeros(256, 512))
    assert t.predicted_step_s == pytest.approx(
        max(t.compute_s, t.bandwidth_s) + H100.launch_overhead_s)
    slow = dataclasses.replace(H100, launch_overhead_s=1.0)
    g = trace_graph(lambda x, w: x @ w, torch.zeros(128, 256),
                    torch.zeros(256, 512))
    assert roofline.audit_graph(g, slow).predicted_step_s > 1.0
    assert roofline.audit_graph(g).predicted_step_s < 1e-3


# ---------------------------------------------------------------------------
# TPU901 / 902 / 903
# ---------------------------------------------------------------------------

def _elementwise_layers(n):
    def f(x):
        for _ in range(n):
            x = x * 1.5
        return x

    return f


def test_tpu901_fires_on_a_repeated_low_intensity_call():
    x = torch.zeros(16 << 20)
    r = analyze(_elementwise_layers(40), x, rules=["TPU901"])
    assert diags(r, "TPU901")
    r = analyze(_elementwise_layers(1), x, rules=["TPU901"])
    assert not diags(r, "TPU901")
    r = analyze(_elementwise_layers(40), x, rules=["TPU901"],
                rule_config={"TPU901.min_amplified_ms": 0})
    assert not diags(r, "TPU901")


def test_tpu902_padding_pair():
    x = torch.zeros(1, 4096, dtype=torch.bfloat16)
    w = torch.zeros(4096, 4096, dtype=torch.bfloat16)
    assert diags(analyze(lambda x, w: x @ w, x, w, rules=["TPU902"]),
                 "TPU902")
    x16 = torch.zeros(16, 4096, dtype=torch.bfloat16)
    assert not diags(analyze(lambda x, w: x @ w, x16, w, rules=["TPU902"]),
                     "TPU902")


def test_tpu903_launch_bound_pair():
    x = torch.zeros(8)
    assert diags(analyze(_elementwise_layers(200), x, rules=["TPU903"]),
                 "TPU903")
    assert not diags(analyze(_elementwise_layers(3), x, rules=["TPU903"]),
                     "TPU903")


# ---------------------------------------------------------------------------
# parity on tiny(), engine and train step
# ---------------------------------------------------------------------------

KW = dict(slots=2, prompt_bucket=16, max_prompt_len=32, max_new_tokens=8,
          block_size=16, steps_per_sync=4, unified_step=False,
          prefix_cache=False, decode_megakernel="off")


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxConfig.tiny()
    paddle.seed(0)
    raw = dict(JaxModel(jcfg).raw_state())
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    port = ContinuousBatchingEngine(LlamaConfig.tiny(), p, device="cpu",
                                    dtype=torch.float32, **KW)
    port.warm(buckets=[32])
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, **KW)
    jeng.warm([32])
    return port, jeng


def test_engine_programs_match_jax_flops_and_kernels(engines):
    port, jeng = engines
    tg = dict(port._traced_inventory())
    jg = dict(jeng._traced_inventory())
    assert set(tg) == set(jg) and "decode" in tg
    for name in tg:
        t = roofline.audit_graph(tg[name])
        j = jroofline.audit_graph(jg[name], "cpu-container")
        jdot = sum(e.total_flops for e in j.events
                   if e.prim == "dot_general")
        jpallas = sum(e.count for e in j.events if e.prim == "pallas_call")
        assert t.matmul_flops == jdot, name
        assert sum(t.kernels.values()) == jpallas, name
        # the port moves every elementwise result through HBM where XLA
        # fuses the chain; nothing else differs in kind
        assert 1.0 <= t.total_hbm_bytes / j.total_hbm_bytes <= 1.6, name


def test_engine_roofline_audit_report_and_sinks(engines):
    from paddle_tpu_torch.observability import MetricsRegistry

    port, jeng = engines
    port._metrics = mt = MetricsRegistry()
    try:
        full = port.audit_roofline()
        part = port.audit_roofline(programs=["decode"])
    finally:
        port._metrics = None
    assert set(jeng.audit_roofline(device="cpu-container")) == set(full)
    assert full["device"] == "h100-sxm" and not full["partial"]
    assert part["partial"] and list(part["programs"]) == ["decode"]
    assert port.metrics()["roofline_audit"] is full
    dec = full["programs"]["decode"]
    assert dec["kernels"] == {"rms_norm": 20, "paged_decode_attention": 8}
    assert full["predicted_ms_per_token"] == pytest.approx(
        dec["predicted_step_ms"] / (4 * 2))
    snap = mt.snapshot()
    assert snap["gauges"]["predicted_step_ms"] == dec["predicted_step_ms"]
    with pytest.raises(ValueError, match="not in the inventory"):
        port.audit_roofline(programs=["nope"])


def test_kernel_launch_inventory(engines):
    port, _ = engines
    g = dict(port._traced_inventory(["decode"]))["decode"]
    assert kernel_launches(g) == {"rms_norm": 20,
                                  "paged_decode_attention": 8}
    mm = sum(1 for c in g.nodes() if roofline.matmul_dims(c) is not None)
    assert count_kernel_launches(g) == 28 + mm


def test_train_step_flops_match_jax():
    """fit's traced step (forward, backward, AdamW) on a 2-layer tiny():
    the products' FLOPs equal the JAX step's (value_and_grad) exactly;
    the kernel nodes equal its pallas_calls but for the delta pre-pass,
    one a layer. Bytes are not compared: the port's step also holds the
    optimizer's update."""
    from paddle_tpu import hapi as jhapi
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.models import LlamaPretrainingCriterion as JaxCrit
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    jcfg = JaxConfig.tiny(num_hidden_layers=2)
    paddle.seed(0)
    jm = JaxModel(jcfg)
    raw = {k: np.asarray(v) for k, v in dict(jm.raw_state()).items()}
    jmodel = jhapi.Model(jm)
    jmodel.prepare(jopt.AdamW(1e-3, parameters=jm.parameters()),
                   JaxCrit(jcfg))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, jcfg.vocab_size, (2, 33)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    target, name, params, batch = jmodel._audit_step_program([x], [y], "t")
    j = jroofline.audit_graph(jmemory.trace_auto(target, params, *batch),
                              "cpu-container")
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    net = LlamaForCausalLM(cfg).load_params(
        params_from_jax(raw, device="cpu"), trainable=True)
    model = hapi.Model(net, device="cpu")
    model.prepare(AdamW(1e-3, parameters=net.named_parameters()),
                  LlamaPretrainingCriterion(cfg))
    g = trace_graph(model._step_program(1), dict(net.named_parameters()),
                    [None] * len(list(net.parameters())),
                    torch.from_numpy(x).long(), torch.from_numpy(y).long(),
                    grad=True)
    t = roofline.audit_graph(g)
    assert t.matmul_flops == sum(e.total_flops for e in j.events
                                 if e.prim == "dot_general")
    kernels = dict(t.kernels)
    assert kernels.pop("flash_attention_bwd_delta") == 2
    assert sum(kernels.values()) == sum(e.count for e in j.events
                                        if e.prim == "pallas_call")


# ---------------------------------------------------------------------------
# hapi.flops
# ---------------------------------------------------------------------------

def test_flops_mlp_within_2pct_of_jax():
    """XLA's cost analysis counts the bias adds and the relu where the
    port's addmm holds the bias; the products agree."""
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch import hapi

    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(64, 128), jnn.ReLU(), jnn.Linear(128, 10))
    tm = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.ReLU(),
                             torch.nn.Linear(128, 10))
    jf = paddle.flops(jm, input_size=(8, 64))
    tf = hapi.flops(tm, input_size=(8, 64))
    assert tf >= 2 * 8 * (64 * 128 + 128 * 10)
    assert abs(tf - jf) / jf <= 0.02


def test_flops_tiny_llama_within_5pct_of_jax():
    """The kernels' closed forms (flash attention counts its causal
    pairs) against XLA's count of the interpreted kernels' bodies and
    the elementwise work."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.models import LlamaForCausalLM

    paddle.seed(0)
    jm = JaxModel(JaxConfig.tiny())
    raw = {k: np.asarray(v) for k, v in dict(jm.raw_state()).items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny()).load_params(
        params_from_jax(raw, device="cpu"))
    ids = np.ones((2, 32), np.int32)
    jf = paddle.flops(jm, inputs=[paddle.to_tensor(ids)])
    tf = hapi.flops(tm, inputs=[torch.from_numpy(ids).long()])
    assert abs(tf - jf) / jf <= 0.05, (tf, jf)
