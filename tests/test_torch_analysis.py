"""The port's lint pipeline (paddle_tpu_torch/analysis) against the JAX
package's (twins of tests/test_analysis.py).

Each rule has a case that fires it and a near-identical one that must
not. Where the hazard is the same on both devices the JAX analyzer sees
the twin function on the same seeded numpy inputs and must reach the
same verdict; where the card's version of a rule differs from the TPU's
(the tile of TPU101, the kernels' limits of TPU102) the test says so.
Tracing runs on fake tensors: no case executes a program.
"""
import json
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.analysis as janalysis
import paddle_tpu_torch.analysis as analysis
from paddle_tpu_torch.analysis import LintError, Severity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def diags(report, rule):
    return [d for d in report if d.rule == rule]


def _inputs(*shapes, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def both(fn_t, fn_j, arrays, rule, t_dtype=torch.float32,
         j_dtype=jnp.float32, extra=()):
    """(port report, JAX report) of one rule on twin functions."""
    rt = analysis.analyze(fn_t, *[torch.from_numpy(a).to(t_dtype)
                                  for a in arrays], *extra, rules=[rule])
    rj = janalysis.analyze(fn_j, *[jnp.asarray(a, j_dtype)
                                   for a in arrays], *extra, rules=[rule])
    return diags(rt, rule), diags(rj, rule)


# ---------------------------------------------------------------------------
# TPU101 / TPU102: the card's tiles and the kernels' limits
# ---------------------------------------------------------------------------

def test_tpu101_fires_on_a_ragged_bf16_product_as_jax_does():
    t, j = both(lambda x, w: x @ w, lambda x, w: x @ w,
                _inputs((100, 100), (100, 100)), "TPU101",
                torch.bfloat16, jnp.bfloat16)
    assert t and j
    assert any("tensor-core tile" in d.message for d in t)


def test_tpu101_silent_on_an_aligned_bf16_product_as_jax_is():
    t, j = both(lambda x, w: x @ w, lambda x, w: x @ w,
                _inputs((128, 256), (256, 512)), "TPU101",
                torch.bfloat16, jnp.bfloat16)
    assert not t and not j


def test_tpu101_f32_products_have_no_card_tile():
    """A divergence on purpose: the TPU pads an f32 100 x 100 product to
    its (8, 128) tile, the card runs f32 on CUDA cores with no tile."""
    t, j = both(lambda x, w: x @ w, lambda x, w: x @ w,
                _inputs((100, 100), (100, 100)), "TPU101")
    assert j and not t


def _flash(dtype, dh):
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    q, k, v = (torch.zeros(1, 128, h, dh, dtype=dtype) for h in (4, 2, 2))
    return analysis.analyze(lambda a, b, c: flash_attention(a, b, c,
                                                            causal=True),
                            q, k, v, rules=["TPU102"])


@pytest.mark.parametrize("dtype,dh,fires", [
    (torch.bfloat16, 128, False), (torch.bfloat16, 96, True),
    (torch.float32, 128, True)])
def test_tpu102_flash_kernel_limits(dtype, dh, fires):
    """TPU102 holds the kernel node to the card kernel's own checks:
    bfloat16 q/k/v and head_dim 64 or 128 (JAX's TPU102 checks its
    Pallas blocks instead)."""
    found = diags(_flash(dtype, dh), "TPU102")
    assert bool(found) == fires
    if fires:
        assert all(d.severity == Severity.ERROR for d in found)


def test_tpu102_and_101_do_not_double_report_kernel_shapes():
    """A kernel node's shape limits are TPU102's alone: a ragged head_dim
    at the flash kernel is no TPU101 finding."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    q, k, v = (torch.zeros(1, 128, h, 96, dtype=torch.bfloat16)
               for h in (4, 2, 2))
    r = analysis.analyze(lambda a, b, c: flash_attention(a, b, c), q, k, v,
                         rules=["TPU101", "TPU102"])
    assert diags(r, "TPU102") and not diags(r, "TPU101")


# ---------------------------------------------------------------------------
# TPU103 / TPU105: pools and launches
# ---------------------------------------------------------------------------

def _paged(pool_dtype, scales):
    from paddle_tpu_torch.kernels.decode_attention import (
        paged_decode_attention)

    q = torch.zeros(2, 4, 128, dtype=torch.bfloat16)
    kc = torch.zeros(8, 2, 64, 128, dtype=pool_dtype)
    t = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    sc = [torch.zeros(8, 2)] * 2 if scales else []

    def f(q, kc, vc, t, lens, *s):
        kw = dict(k_scale=s[0], v_scale=s[1]) if s else {}
        return paged_decode_attention(q, kc, vc, t, lens, **kw)

    return analysis.analyze(f, q, kc, kc.clone(), t, lens, *sc,
                            rules=["TPU103"])


@pytest.mark.parametrize("pool,fires", [("float32", True),
                                        ("bfloat16", False),
                                        ("int8", False)])
def test_tpu103_pool_dtypes(pool, fires):
    r = _paged(getattr(torch, pool), pool == "int8")
    assert bool(diags(r, "TPU103")) == fires


def _layer(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def test_tpu105_many_distinct_small_launches_fire():
    x = torch.zeros(2, 128)
    ws = [torch.zeros(128, n) for n in (136, 144, 152, 160, 168, 176, 184)]

    def f(x, *ws):
        return [torch.tanh(x @ w) for w in ws]

    r = analysis.analyze(f, x, *ws, rules=["TPU105"])
    assert diags(r, "TPU105")


def test_tpu105_repeated_layers_count_once():
    x = torch.zeros(2, 128)
    w = torch.zeros(128, 128)
    r = analysis.analyze(lambda x, w: _layer(x, [w] * 32), x, w,
                         rules=["TPU105"])
    assert not diags(r, "TPU105")


# ---------------------------------------------------------------------------
# TPU201 / TPU202: what a capture bakes in
# ---------------------------------------------------------------------------

def test_tpu201_python_scalar_argument_fires_as_in_jax():
    t, j = both(lambda x, lr: x * lr, lambda x, lr: x * lr,
                _inputs((8, 128)), "TPU201", extra=(0.77,))
    assert t and j and "CUDA graph" in t[0].message


def test_tpu201_tensor_scalar_silent_as_in_jax():
    rt = analysis.analyze(lambda x, lr: x * lr, torch.ones(8, 128),
                          torch.tensor(0.77), rules=["TPU201"])
    rj = janalysis.analyze(lambda x, lr: x * lr, jnp.ones((8, 128)),
                           jnp.asarray(0.77), rules=["TPU201"])
    assert not diags(rt, "TPU201") and not diags(rj, "TPU201")


def test_tpu201_int_step_fires_and_float_does_not_match_int_literal():
    r = analysis.analyze(lambda x, step: x * step, torch.ones(8, 128), 3,
                         rules=["TPU201"])
    assert diags(r, "TPU201")
    r = analysis.analyze(lambda x, s: (x * 2).to(torch.int32),
                         torch.ones(8, 128, dtype=torch.int32), 2.5,
                         rules=["TPU201"])
    assert not diags(r, "TPU201")


def test_tpu201_closure_constant_silent():
    theta = 1.0 / 10000.0 ** 0.3
    r = analysis.analyze(lambda x: x * theta, torch.ones(8, 128),
                         rules=["TPU201"])
    assert not diags(r, "TPU201")


def test_tpu202_large_closure_tensor_fires_as_in_jax():
    big_np = np.ones((512, 600), np.float32)        # 1.2 MiB
    big = torch.from_numpy(big_np)
    jbig = jnp.asarray(big_np)
    rt = analysis.analyze(lambda x: x @ big, torch.ones(4, 512),
                          rules=["TPU202"])
    rj = janalysis.analyze(lambda x: x @ jbig, jnp.ones((4, 512)),
                           rules=["TPU202"])
    assert diags(rt, "TPU202") and diags(rj, "TPU202")


def test_tpu202_module_parameters_ride_as_inputs():
    net = torch.nn.Linear(600, 600)                 # 1.4 MiB of weight
    r = analysis.analyze(net, torch.ones(2, 600), rules=["TPU202"])
    assert not diags(r, "TPU202")


# ---------------------------------------------------------------------------
# TPU301: promotion
# ---------------------------------------------------------------------------

def test_tpu301_upcast_feeding_compute_fires_as_in_jax():
    def ft(x, y):
        return x.float() * y

    def fj(x, y):
        return x.astype(jnp.float32) * y

    a, b = _inputs((8, 128), (8, 128))
    rt = analysis.analyze(ft, torch.from_numpy(a).bfloat16(),
                          torch.from_numpy(b), rules=["TPU301"])
    rj = janalysis.analyze(fj, jnp.asarray(a, jnp.bfloat16),
                           jnp.asarray(b), rules=["TPU301"])
    assert diags(rt, "TPU301") and diags(rj, "TPU301")


def test_tpu301_f32_product_of_a_widened_operand_fires():
    a, b = _inputs((16, 128), (128, 128))
    rt = analysis.analyze(lambda x, w: x.float() @ w,
                          torch.from_numpy(a).bfloat16(),
                          torch.from_numpy(b), rules=["TPU301"])
    rj = janalysis.analyze(lambda x, w: x @ w, jnp.asarray(a, jnp.bfloat16),
                           jnp.asarray(b), rules=["TPU301"])
    assert any("CUDA-core" in d.message for d in diags(rt, "TPU301"))
    assert diags(rj, "TPU301")


@pytest.mark.parametrize("case", ["bf16", "reduction"])
def test_tpu301_silent_on_pure_bf16_and_upcast_into_reduction(case):
    x = torch.ones(8, 128, dtype=torch.bfloat16)
    fn = (lambda x: x * x) if case == "bf16" \
        else (lambda x: x.float().sum(-1))
    assert not diags(analysis.analyze(fn, x, rules=["TPU301"]), "TPU301")


# ---------------------------------------------------------------------------
# TPU501 / 601 / 602: host calls inside a program
# ---------------------------------------------------------------------------

def test_tpu501_item_inside_a_program_is_an_error():
    r = analysis.analyze(lambda x: x * x.sum().item(), torch.ones(4),
                         rules=["TPU501"])
    found = diags(r, "TPU501")
    assert found and found[0].severity == Severity.ERROR
    assert not diags(analysis.analyze(lambda x: x * x.sum(), torch.ones(4),
                                      rules=["TPU501"]), "TPU501")


def test_tpu601_checkpoint_save_inside_a_program(tmp_path):
    from paddle_tpu_torch.resilience.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path))

    def step(x):
        y = x * 2
        mgr.save({"y": y}, step=1, blocking=True)
        return y

    r = analysis.analyze(step, torch.ones(4), rules=["TPU601", "TPU602"])
    assert diags(r, "TPU601") and not diags(r, "TPU602")
    assert mgr.generations() == []          # the trace wrote nothing


def test_tpu602_trace_span_inside_a_program():
    from paddle_tpu_torch.observability import Tracer

    tr = Tracer()

    def step(x):
        with tr.span("step"):
            return x + 1

    r = analysis.analyze(step, torch.ones(4), rules=["TPU601", "TPU602"])
    assert diags(r, "TPU602") and not diags(r, "TPU601")
    r = analysis.analyze(lambda x: x + 1, torch.ones(4),
                         rules=["TPU601", "TPU602"])
    assert not r.diagnostics


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_report_raise_on_error_and_warn_below():
    report = analysis.analyze(lambda x: x * x.sum().item(), torch.ones(4))
    with pytest.raises(LintError) as ei:
        report.raise_or_warn()
    assert ei.value.report.errors
    report = analysis.analyze(lambda x, w: x @ w,
                              torch.ones(100, 100, dtype=torch.bfloat16),
                              torch.ones(100, 100, dtype=torch.bfloat16),
                              rules=["TPU101"])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        report.raise_or_warn()
    assert any("TPU101" in str(x.message) for x in w)


def test_severity_overrides_and_custom_rule():
    from paddle_tpu_torch.analysis import Rule, register_rule
    from paddle_tpu_torch.analysis.rules import RULES

    args = (torch.ones(100, 100, dtype=torch.bfloat16),) * 2
    r = analysis.analyze(lambda x, w: x @ w, *args,
                         severity_overrides={"TPU101": None})
    assert not diags(r, "TPU101")
    r = analysis.analyze(lambda x, w: x @ w, *args,
                         severity_overrides={"TPU101": Severity.ERROR})
    assert any(d.severity == Severity.ERROR for d in diags(r, "TPU101"))

    @register_rule
    class NoTanhRule(Rule):
        id = "TST901"
        name = "no-tanh"

        def check(self, graph):
            for ctx in graph.nodes():
                if ctx.packet == "tanh":
                    yield self.diag("tanh spotted", where=ctx.path)

    try:
        r = analysis.analyze(torch.tanh, torch.ones(4), rules=["TST901"])
        assert diags(r, "TST901")
    finally:
        RULES.pop("TST901", None)


def test_prefixed_rule_config_keys_route_to_one_rule():
    big = torch.ones(512, 600)
    fn = lambda x: x @ big  # noqa: E731
    r = analysis.analyze(fn, torch.ones(4, 512), rules=["TPU202"],
                         rule_config={"TPU202.threshold_bytes": 1 << 30})
    assert not diags(r, "TPU202")
    r = analysis.analyze(fn, torch.ones(4, 512), rules=["TPU202"],
                         rule_config={"TPU901.threshold_bytes": 1 << 30})
    assert diags(r, "TPU202")
    with pytest.raises(ValueError, match="TPU999"):
        analysis.analyze(fn, torch.ones(4, 512),
                         rule_config={"TPU999.x": 1})
    with pytest.raises(ValueError, match="severity"):
        analysis.analyze(fn, torch.ones(4, 512),
                         rule_config={"severity": 1})


def test_report_json_schema_equals_jax():
    args = (torch.ones(100, 100, dtype=torch.bfloat16),) * 2
    rt = analysis.analyze(lambda x, w: x @ w, *args, rules=["TPU101"])
    rj = janalysis.analyze(lambda x, w: x @ w,
                           *(jnp.ones((100, 100), jnp.bfloat16),) * 2,
                           rules=["TPU101"])
    dt, dj = json.loads(rt.to_json()), json.loads(rj.to_json())
    assert set(dt) == set(dj)
    assert set(dt["counts"]) == set(dj["counts"])
    assert set(dt["diagnostics"][0]) == set(dj["diagnostics"][0])
    assert rt.to_json() == analysis.analyze(
        lambda x, w: x @ w, *args, rules=["TPU101"]).to_json()


def test_tiny_llama_forward_has_no_error_on_the_card_dtype():
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         init_train_params)

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512)
    model = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, 0, "cpu")).to(torch.bfloat16)
    report = analysis.analyze(model, torch.zeros(1, 128, dtype=torch.int64),
                              name="models.llama tiny forward")
    assert not report.errors, report.format(Severity.ERROR)


def test_cli_json_and_unported_modes():
    """The CLI's JSON holds the report, memory and roofline keys of the
    JAX CLI's schema; --comms raises naming its item (--tune runs:
    tests/test_torch_tuner.py)."""
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", "--memory",
         "--roofline", "--device", "cpu", "--format", "json",
         "--fail-on", "never"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    d = json.loads(out.stdout)
    assert {"target", "counts", "diagnostics", "memory", "roofline"} <= set(d)
    assert d["roofline"]["device"] == "h100-sxm"
    assert d["roofline"]["kernels"]["paged_decode_attention"] > 0
    assert d["memory"]["donation"]["donated_bytes"] > 0
    from paddle_tpu_torch.analysis.__main__ import main

    with pytest.raises(NotImplementedError, match="item 5"):
        main(["--comms", "--device", "cpu"])
