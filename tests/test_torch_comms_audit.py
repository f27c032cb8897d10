"""The port's communication audit (`analysis/comms.py`, TPU401 and
TPU801-803, the engine's `audit_comms`, the `--comms` CLI and the tuner's
sharded candidates) against the JAX package's (tests/test_comms_audit.py),
on the CPU in f32 on ``LlamaConfig.tiny()``.

A sharded engine is built as rank 0 with no live process group
(`parallel.ranks.traced_rank`): its programs trace, nothing is exchanged.
The JAX engines run their single controller on the 8-device CPU host
(tests/conftest.py); a pool of two spawned ranks (tests/torch_rank_pool.py)
builds the same engine on a live gloo group, whose audits must equal the
traced rank's. Every number compared with JAX is compared exactly: the
two passes price the same collectives by the same ring model (the port's
sites are the decode chunk's unrolled steps folded onto one step, JAX's
the scan's equations).
"""
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.analysis import comms as jcomms
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.parallel.shard_map_compat import shard_map
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.analysis import analyze, comms
from paddle_tpu_torch.analysis.comms import resolve_audit_comms
from paddle_tpu_torch.analysis.diagnostics import Severity
from paddle_tpu_torch.analysis.graph import trace_graph
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.observability import MetricsRegistry, Tracer
from paddle_tpu_torch.parallel.collectives import (all_gather, all_reduce,
                                                   all_to_all,
                                                   quantized_all_gather)
from paddle_tpu_torch.parallel.ranks import GroupRef, traced_rank
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from torch_rank_pool import RankPool, audit_engine_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(slots=4, prompt_bucket=16, max_prompt_len=32, max_new_tokens=8,
          block_size=16, steps_per_sync=4, prefill_batch=2,
          unified_step=False)
DECODE_KEYS = ("bytes_on_wire", "quantized_wire_bytes", "n_quantized_sites",
               "n_collective_sites", "n_collectives", "n_implicit_reshards",
               "mp", "per_axis", "per_kind")


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def model():
    paddle.seed(7)
    jm = JaxModel(JaxConfig.tiny())
    return jm, {k: np.asarray(v) for k, v in jm.raw_state().items()}


def _engine(np_params, **kw):
    with traced_rank(0), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ContinuousBatchingEngine(
            LlamaConfig.tiny(), params_from_jax(np_params, device="cpu"),
            device="cpu", **{**KW, **kw})


def _ref(n, axis="mp"):
    return GroupRef(f"{axis}@" + ",".join(map(str, range(n))), n, 0)


def _smap(fn, n, out_specs=P("mp")):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("mp",))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=P("mp"),
                             out_specs=out_specs, check_vma=False))


# ---------------------------------------------------------------------------
# the pass and its cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_cost_model_matches_jax(n):
    """An all-reduce moves 2(n-1)/n of its operand, an all-gather and an
    all-to-all (n-1)/n of the full payload: the port's per-rank bytes,
    kinds and axes equal JAX's on the same local shapes."""
    ref = _ref(n)

    def port(x):
        return (all_reduce(x * 1.0, ref), all_gather(x, ref, 0),
                all_to_all(x.reshape(n, -1, 128), ref))

    rep = comms.audit_comms(port, torch.zeros(8, 128))

    def jfn(x):
        return (jax.lax.psum(x * 1.0, "mp"),
                jax.lax.all_gather(x, "mp", axis=0, tiled=True),
                jax.lax.all_to_all(x, "mp", 0, 0, tiled=True))

    jrep = jcomms.audit_comms(
        _smap(jfn, n, out_specs=(P("mp"), P(None), P("mp"))),
        jnp.zeros((8 * n, 128), jnp.float32))
    for key in ("bytes_on_wire", "float_payload_bytes", "n_collective_sites",
                "n_collectives", "mp", "per_axis", "per_kind"):
        assert rep.to_dict()[key] == jrep.to_dict()[key], key
    assert comms._wire_factor("psum", n) == 2 * (n - 1) / n
    assert comms._wire_factor("all_gather", n) == (n - 1) / n
    assert comms._wire_factor("psum", 1) == 0.0


def test_single_rank_program_and_int_payloads():
    rep = comms.audit_comms(lambda x: x * 2, torch.zeros(4, 4))
    assert rep.n_collective_sites == 0 and rep.total_wire_bytes == 0
    rep = comms.audit_comms(
        lambda i, f: (all_gather(i, _ref(2), 0), all_gather(f, _ref(2), 0)),
        torch.zeros(4, 128, dtype=torch.int32), torch.zeros(4, 128))
    assert rep.total_float_payload_bytes == 4 * 128 * 4
    assert [e.float_payload_bytes for e in rep.events] == [0, 4 * 128 * 4]


def _loop(steps):
    ref = _ref(2)

    def loop(x):
        for _ in range(steps):
            x = x + all_reduce(x * 1.0, ref)
        return x

    return loop


def test_unrolled_steps_fold_into_sites():
    rep = comms.audit_comms(_loop(8), torch.zeros(4, 4096), steps=8)
    assert rep.n_collective_sites == 1 and rep.n_collectives == 8
    assert rep.events[0].in_loop and rep.events[0].count == 8
    flat = comms.audit_comms(_loop(8), torch.zeros(4, 4096))
    assert flat.n_collective_sites == 8
    assert flat.total_wire_bytes == rep.total_wire_bytes
    # a sequence that does not repeat `steps` times stays unfolded
    odd = comms.audit_comms(_loop(6), torch.zeros(4, 4096), steps=4)
    assert odd.n_collective_sites == 6


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _graph(fn, *args, steps=1):
    g = trace_graph(fn, *args)
    g.unrolled_steps = steps
    return g


def test_tpu801_fire_and_silent_pairs():
    g = _graph(_loop(8), torch.zeros(4, 4096), steps=8)
    hits = analyze(None, graph=g, rules=["TPU801"],
                   rule_config={"TPU801.max_step_wire_bytes": 1 << 18})
    assert len(hits) == 1 and "8 loop iterations" in hits.diagnostics[0]\
        .message
    assert hits.diagnostics[0].severity == Severity.WARNING
    assert len(analyze(None, graph=g, rules=["TPU801"])) == 0
    top = _graph(lambda x: all_reduce(x * 1.0, _ref(2)),
                 torch.zeros(4, 1 << 20))
    assert len(analyze(None, graph=top, rules=["TPU801"], rule_config={
        "TPU801.max_step_wire_bytes": 1})) == 0


def test_tpu802_silent_on_every_sharded_program(model):
    _, np_params = model
    for kw in (dict(serving_mp=2), dict(serving_cp=2),
               dict(serving_mp=2, quantized_collectives=True),
               dict(serving_mp=2, serving_cp=2),
               dict(serving_mp=2, decode_megakernel="attn")):
        eng = _engine(np_params, **kw)
        for name, g in eng._traced_inventory():
            assert comms.audit_graph(g).reshards == []
            assert len(analyze(None, graph=g, rules=["TPU802"],
                               rule_config={"TPU802.min_bytes": 0})) == 0


def test_tpu803_fires_on_float_silent_on_int8():
    ref = _ref(2)
    fire = analyze(None, graph=_graph(lambda x: all_gather(x, ref, 0),
                                      torch.zeros(8, 1 << 17,
                                                  dtype=torch.bfloat16)),
                   rules=["TPU803"])
    assert len(fire) == 1 and "int8" in fire.diagnostics[0].hint
    quiet = _graph(lambda x: quantized_all_gather(x, ref, dim=0),
                   torch.zeros(8, 1 << 17, dtype=torch.bfloat16))
    rep = comms.audit_graph(quiet)
    assert rep.n_quantized_sites == 1 and rep.quantized_wire_bytes > 0
    assert len(analyze(None, graph=quiet, rules=["TPU803"])) == 0
    small = _graph(lambda x: all_gather(x, ref, 0),
                   torch.zeros(8, 1 << 12, dtype=torch.bfloat16))
    assert len(analyze(None, graph=small, rules=["TPU803"])) == 0
    # amplification by the unrolled steps crosses the threshold
    amp = _graph(_loop(64), torch.zeros(8, 2048), steps=64)
    hits = analyze(None, graph=amp, rules=["TPU803"])
    assert len(hits) == 1 and "x 64 iterations" in hits.diagnostics[0]\
        .message


def test_tpu401_dead_duplicate_axis_and_size():
    ref = _ref(2)

    def bad(x):
        all_reduce(x * 1.0, ref)                 # dead
        a = all_gather(x, ref, 0)
        b = all_gather(x, ref, 0)                # duplicate
        return a + b

    r = analyze(None, graph=_graph(bad, torch.zeros(4, 4)),
                rules=["TPU401"], rule_config={"mesh_axes": ("dp",)})
    msgs = [d.message for d in r]
    assert any("never used" in m for m in msgs)
    assert any("duplicate all_gather" in m for m in msgs)
    assert sum(d.severity == Severity.ERROR for d in r) == 3
    clean = analyze(None, graph=_graph(lambda x: all_gather(x, ref, 0),
                                       torch.zeros(4, 4)),
                    rules=["TPU401"], rule_config={"mesh_axes": ("mp",)})
    assert len(clean) == 0
    amp = _graph(_loop(64), torch.zeros(8, 2048), steps=64)
    loud = [d for d in analyze(None, graph=amp, rules=["TPU401"],
                               rule_config={"max_collective_bytes": 1 << 20})
            if "float payload" in d.message]
    assert len(loud) == 1 and "loop body" in loud[0].message
    assert loud[0].severity == Severity.WARNING
    # the default pipeline reports a large payload once (TPU803's)
    big = _graph(lambda x: all_gather(x, ref, 0),
                 torch.zeros(8, 1 << 18, dtype=torch.bfloat16))
    sized = [d for d in analyze(None, graph=big) if "float payload"
             in d.message]
    assert [d.rule for d in sized] == ["TPU803"]


def test_report_schema_and_memoization():
    ref = _ref(2)
    a = comms.audit_comms(lambda x: all_reduce(x * 1.0, ref),
                          torch.zeros(8, 128)).to_json()
    jfn = _smap(lambda x: jax.lax.psum(x * 1.0, "mp"), 2)
    j = json.loads(jcomms.audit_comms(jfn, jnp.zeros((16, 128),
                                                      jnp.float32)).to_json())
    d = json.loads(a)
    assert set(d) == set(j)
    assert set(d["top_talkers"][0]) == set(j["top_talkers"][0])
    g = _graph(lambda x: all_reduce(x * 1.0, ref), torch.zeros(8, 128))
    assert comms.audit_graph(g) is comms.audit_graph(g)
    with pytest.raises(RuntimeError, match="not registered"):
        all_gather(torch.zeros(2), GroupRef("mp@0,1", 2, 0), 0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(serving_mp=2), dict(serving_mp=2, quantized_collectives=True),
    dict(serving_mp=2, serving_cp=2)], ids=["mp2", "mp2-int8", "cp2xmp2"])
def test_mp2_decode_wire_matches_hand_reference(model, kw):
    jm, np_params = model
    cfg = LlamaConfig.tiny()
    eng = _engine(np_params, **kw)
    fleet = eng.audit_comms(programs=("decode",))
    jeng = JaxEngine(jm.config, dict(jm.raw_state()), **KW, **kw)
    jfleet = jeng.audit_comms(programs=("decode",))
    dec, jdec = fleet["programs"]["decode"], jfleet["programs"]["decode"]
    for key in DECODE_KEYS:
        assert dec[key] == jdec[key], key
    assert fleet["predicted_bytes_on_wire_per_token"] \
        == jfleet["predicted_bytes_on_wire_per_token"]
    if kw == dict(serving_mp=2):
        ref = cfg.num_hidden_layers * cfg.num_attention_heads \
            * cfg.head_dim * 2 * (2 - 1) / 2
        got = fleet["predicted_bytes_on_wire_per_token"]
        assert abs(got - ref) / ref <= 0.10
        assert dec["n_collective_sites"] == cfg.num_hidden_layers
        assert dec["n_collectives"] == cfg.num_hidden_layers * eng.steps
        assert set(dec["per_kind"]) == {"all_gather"}
        assert dec["n_implicit_reshards"] == 0
    assert fleet["partial"] and eng.metrics()["comms_audit"] is None


def test_mp1_engine_audits_clean_zero_collectives(model):
    _, np_params = model
    eng = _engine(np_params)
    eng.warm([16])
    fleet = eng.audit_comms()
    assert fleet["comms_clean"] and fleet["total_bytes_on_wire"] == 0
    assert fleet["predicted_bytes_on_wire_per_token"] == 0
    for name, prog in fleet["programs"].items():
        assert prog["n_collectives"] == 0 and prog["diagnostics"] == []
    assert eng.metrics()["comms_audit"] is fleet


def test_audit_emits_observability_sinks(model):
    _, np_params = model
    mt, tr = MetricsRegistry(), Tracer()
    eng = _engine(np_params, serving_mp=2, metrics=mt, tracer=tr)
    assert eng.audit_comms(programs=("decode",))["partial"]
    assert mt.events("comms.audit") == []
    with pytest.raises(ValueError, match="nonesuch"):
        eng.audit_comms(programs=("nonesuch",))
    full = eng.audit_comms()
    assert not full["partial"] and eng.metrics()["comms_audit"] is full
    events = mt.events("comms.audit")
    assert len(events) == 1 and events[0]["total_bytes_on_wire"] > 0
    assert "predicted_bytes_on_wire_per_token" in mt.snapshot()["gauges"]
    assert [e for e in tr.events() if e.get("name") == "comms.audit"]
    # the sharded engine's memory and roofline audits: per-rank reports
    mem = eng.audit_memory()
    roof = eng.audit_roofline()
    assert mem["mp"] == 2 and mem["fleet_peak_hbm_bytes"] > 0
    assert roof["mp"] == 2
    assert roof["programs"]["decode"]["wire_bytes"] \
        == full["programs"]["decode"]["bytes_on_wire"]
    assert roof["programs"]["decode"]["wire_ms"] > 0


def test_flag_composition():
    prev = get_flags(["tpu_lint", "audit_comms"])
    try:
        set_flags({"tpu_lint": True, "audit_comms": False})
        assert resolve_audit_comms(None)
        set_flags({"tpu_lint": False})
        assert not resolve_audit_comms(None)
        set_flags({"audit_comms": True})
        assert resolve_audit_comms(None)
        assert not resolve_audit_comms(False)
    finally:
        set_flags({k.replace("FLAGS_", ""): v for k, v in prev.items()})


def test_mp2_warm_hook_on_live_ranks_equals_the_traced_rank(pool, model):
    """On a live gloo group of two ranks: warm(audit_comms=True) over the
    split fleet (the prefill programs carry their own gathers), the
    decode chunk's report equal to the traced rank 0's, TPU803 at a
    tightened threshold, and the memory / roofline audits per rank."""
    _, np_params = model
    kw = dict(KW, serving_mp=2)
    outs = pool.run(2, audit_engine_rank, np_params, kw)
    traced = _engine(np_params, serving_mp=2).audit_comms(
        programs=("decode",))
    for fleet, mem, roof in outs:
        dec = fleet["programs"]["decode"]
        for key in DECODE_KEYS:
            assert dec[key] == traced["programs"]["decode"][key], key
        assert fleet["programs_audited"] >= 3 and fleet["mp"] == 2
        for name, prog in fleet["programs"].items():
            assert set(prog["per_kind"]) == {"all_gather"}, name
            assert prog["bytes_on_wire"] > 0, name
        assert fleet["comms_clean"]
        assert "TPU803" in fleet["tight"]
        assert mem["mp"] == 2 and roof["programs"]["decode"]["wire_ms"] > 0


# ---------------------------------------------------------------------------
# the CLI and the tuner
# ---------------------------------------------------------------------------

def test_cli_comms_json_schema_and_gate(capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", "--comms",
         "--device", "cpu", "--format", "json"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    d = json.loads(proc.stdout)
    assert sorted(d) == ["comms", "counts", "diagnostics", "target"]
    c = d["comms"]
    for key in ("bytes_on_wire", "per_axis", "per_kind", "mp",
                "n_collective_sites", "n_collectives", "top_talkers",
                "per_chip"):
        assert key in c
    assert c["mp"] == 2 and c["bytes_on_wire"] > 0
    assert set(c["per_kind"]) == {"all_gather"}
    q = c["quantized_decode"]
    assert q["n_quantized_sites"] == c["n_collective_sites"]
    assert 0 < q["wire_bytes_ratio_vs_unquantized"] < 1
    from paddle_tpu_torch.analysis.__main__ import main

    capsys.readouterr()
    rc = main(["--comms", "--device", "cpu", "--format", "json",
               "--rule-config", "TPU803.min_bytes=256", "--fail-on",
               "warning"])
    assert rc == 1
    gd = json.loads(capsys.readouterr().out)
    assert "TPU803" in [x["rule"] for x in gd["diagnostics"]]


def test_tuner_scores_an_mp2_candidate_with_the_audits_wire(model):
    from paddle_tpu_torch.analysis import autotune

    _, np_params = model
    cfg = LlamaConfig.tiny()
    params = params_from_jax(np_params, device="cpu")
    geo = dict(slots=4, prompt_bucket=16, max_prompt_len=32,
               max_new_tokens=8, block_size=16, steps_per_sync=4,
               device="cpu", dtype=torch.float32)
    space = {"block_size": [16], "decode_megakernel": ["off"],
             "kv_cache_dtype": ["bf16"], "quantized_collectives": [False],
             "serving_cp": [1], "serving_mp": [1, 2], "spec_k": [4],
             "speculative": ["off"], "token_budget": [16],
             "unified_step": [False]}
    report = autotune(cfg, params, engine_kwargs=geo, space=space,
                      hbm_budget_bytes=1 << 40)
    scored = {c.config["serving_mp"]: c for c in report.ranking}
    assert set(scored) == {1, 2} and not report.pruned
    want = _engine(np_params, serving_mp=2).audit_comms(
        programs=("decode",))["predicted_bytes_on_wire_per_token"]
    assert scored[2].predicted_wire_bytes_per_token == want > 0
    assert scored[1].predicted_wire_bytes_per_token == 0.0
