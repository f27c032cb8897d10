"""The port's static autotuner (paddle_tpu_torch/analysis/tuner.py), the
engine's config= / FLAGS_tuned_config, and warm_compile_stats over the
kernel build cache, against the JAX package's (twins of
tests/test_tuner.py).

Parity with JAX, exact, on LlamaConfig.tiny() with the same seeded
weights carried across by params_from_jax in f32: the pure functions
(model_signature, space_hash, canonical_config over every point of JAX's
default space, enumerate_candidates), the static bounds (the port counts
the scan rung's stacked copy of the layer weights, the one named
difference), the set pruned before tracing under one budget, TunedConfig
apply / stale_reason, and artifacts saved by either package. The JAX
tuner's ranking is no oracle here (its prune-stage test fails under the
installed jax), so the ranking tests hold the port's own contract: two
runs equal, both prune stages firing under the port's demo budget with
the baseline feasible, the winner no slower than the baseline, int8
twins no larger than bf16 ones, the caller's params unchanged, and the
report byte-identical without the program memo. The ranking runs in bf16
(weights cast from the same f32 values): the static bound prices the
"bf16" pools at two bytes an element, as JAX's does, which is what an
f32 engine's pools hold only in bf16.

The engine applies one artifact as the JAX engine does (explicit kwargs
win, a stale explicit artifact raises, a stale or unreadable flag one
warns and is ignored, config=False beats the flag), and both engines give
the same knobs and greedy tokens from it. The build cache counts one miss
per kernel source on a cold build (nvcc stubbed by a script on PATH) and
none in a fresh process over the same directory.
"""
import dataclasses
import functools
import json
import os
import stat
import subprocess
import sys
import textwrap
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis import tuner as jtuner
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.analysis import TunedConfig, autotune, tuner
from paddle_tpu_torch.analysis.__main__ import demo_budget, main
from paddle_tpu_torch.framework import get_flags, set_flags
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models.llama import STACKED_LAYER_NAMES
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from paddle_tpu_torch.serving import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX demo's geometry (tests/test_tuner.py _KW): a larger page class
# (16) above the baseline's 8, the split path
KW = dict(slots=2, prompt_bucket=16, max_prompt_len=32, max_new_tokens=8,
          block_size=8, steps_per_sync=4, unified_step=False)


@functools.lru_cache(maxsize=None)
def _weights(seed=21):
    """The JAX tiny model's raw state (numpy) and the port's f32 params."""
    paddle.seed(seed)
    raw = {k: np.asarray(v)
           for k, v in JaxModel(JaxConfig.tiny()).raw_state().items()}
    return raw, params_from_jax(raw, device="cpu")


def _pinned(space):
    """JAX's _demo_runs pins: one device, no speculation, off / attn."""
    return dict(space, serving_mp=[1], serving_cp=[1], speculative=["off"],
                spec_k=[0], decode_megakernel=["off", "attn"])


def _jax_default_space():
    return jtuner.default_space(JaxConfig.tiny(), KW)


# ---------------------------------------------------------------------------
# parity with JAX: pure functions, bounds, artifacts
# ---------------------------------------------------------------------------

def test_pure_functions_match_jax():
    """model_signature, _engine_geometry, space_hash and canonical_config
    over every point of JAX's default-space product; baseline_config with
    unified_step pinned (under 'auto' the port serves split, JAX turns
    the unified step on off its TPU)."""
    import itertools

    for over in ({}, {"num_key_value_heads": 4}, {"hidden_size": 128}):
        assert tuner.model_signature(LlamaConfig.tiny(**over)) \
            == jtuner.model_signature(
                dataclasses.replace(JaxConfig.tiny(), **over))
    assert tuner.model_signature(LlamaConfig.llama3_8b()) \
        == jtuner.model_signature(JaxConfig.llama3_8b())
    geo = tuner._engine_geometry(KW)
    assert geo == jtuner._engine_geometry(KW)
    space = _jax_default_space()
    assert tuner.space_hash(space) == jtuner.space_hash(space)
    names = sorted(space)
    n = 0
    for values in itertools.product(*(space[k] for k in names)):
        point = dict(zip(names, values))
        assert tuner.canonical_config(point, geo) \
            == jtuner.canonical_config(point, geo), point
        n += 1
    assert n == 4096           # 8 host devices: mp [1, 2], cp [1, 2, 4, 8]
    cfg = LlamaConfig.tiny()
    assert tuner.baseline_config(cfg, KW) \
        == jtuner.baseline_config(JaxConfig.tiny(), KW)
    auto = dict(KW, unified_step="auto")
    assert tuner.baseline_config(cfg, auto)["unified_step"] is False
    assert jtuner.baseline_config(JaxConfig.tiny(), auto)["unified_step"]


def test_default_space_and_enumeration_match_jax():
    """The port's default space is JAX's with the mesh degrees the one
    device admits ([1]); the card's page rule gives JAX's pages here; the
    same space enumerates to the same candidates in the same order."""
    space = _jax_default_space()
    ours = tuner.default_space(LlamaConfig.tiny(), KW)
    assert ours == dict(space, serving_mp=[1], serving_cp=[1])
    assert ours["block_size"] == [8, 16]
    geo = tuner._engine_geometry(KW)
    for sp in (space, ours, _pinned(space)):
        assert tuner.enumerate_candidates(sp, geo) \
            == jtuner.enumerate_candidates(sp, geo)


def test_static_bounds_match_jax_but_the_scan_copy():
    """static_candidate_bound equals JAX's for every candidate of JAX's
    default space but the scan rung's, which adds the stacked copy of
    every layer's weights (the card holds it beside the caller's)."""
    raw, params = _weights()
    cfg = LlamaConfig.tiny()
    geo = tuner._engine_geometry(KW)
    stacked = sum(params[f"llama.layers.{i}.{n}"].nbytes
                  for i in range(cfg.num_hidden_layers)
                  for n in STACKED_LAYER_NAMES)
    seen = 0
    for c in tuner.enumerate_candidates(_jax_default_space(), geo):
        ours = tuner.static_candidate_bound(cfg, params, c, KW)
        theirs = jtuner.static_candidate_bound(JaxConfig.tiny(), raw, c, KW)
        scan = c["decode_megakernel"] == "scan"
        assert ours - theirs == (stacked if scan else 0), c
        seen += scan
    assert seen > 0


def test_pre_trace_prune_set_matches_jax():
    """Under one budget (the baseline's static bound) the port prunes
    before tracing exactly the candidates JAX's static bound exceeds it
    for, plus the scan candidates the stacked copy puts over it."""
    raw, params = _weights()
    cfg = LlamaConfig.tiny()
    base = tuner.baseline_config(cfg, KW)
    space = {k: [v] for k, v in base.items()}
    space.update(block_size=[8, 16], kv_cache_dtype=["bf16", "int8"],
                 decode_megakernel=["off", "scan"])
    geo = tuner._engine_geometry(KW)
    budget = jtuner.static_candidate_bound(JaxConfig.tiny(), raw, base, KW)
    jax_set = {jtuner._config_key(c)
               for c in jtuner.enumerate_candidates(space, geo)
               if jtuner.static_candidate_bound(JaxConfig.tiny(), raw, c,
                                                KW) > budget}
    rep = autotune(cfg, params, engine_kwargs=dict(KW, device="cpu",
                                                   dtype=torch.float32),
                   space=space, hbm_budget_bytes=budget)
    ours = {tuner._config_key(p.config) for p in rep.pruned
            if "before tracing" in p.pruned_reason}
    assert jax_set and jax_set <= ours
    extra = [json.loads(k) for k in ours - jax_set]
    assert extra and all(c["decode_megakernel"] == "scan" for c in extra)


def test_tuned_config_apply_and_staleness_match_jax():
    knobs = {"kv_cache_dtype": "int8", "block_size": 16,
             "decode_megakernel": "scan"}
    ours = TunedConfig(knobs=knobs, device="h100-sxm",
                       model=tuner.model_signature(LlamaConfig.tiny()),
                       space_hash="x")
    theirs = jtuner.TunedConfig(**{f.name: getattr(ours, f.name)
                                   for f in dataclasses.fields(ours)})
    for kw in ({}, {"kv_cache_dtype": "bf16", "block_size": None},
               {"decode_megakernel": None, "slots": 4}):
        assert ours.apply(kw) == theirs.apply(kw)
    grown = LlamaConfig.tiny(hidden_size=128)
    jgrown = dataclasses.replace(JaxConfig.tiny(), hidden_size=128)
    space = {"kv_cache_dtype": ["bf16"]}
    for o, t in ((ours, theirs),
                 (TunedConfig.from_dict(dict(ours.to_dict(),
                                             schema_version=0)),
                  jtuner.TunedConfig.from_dict(dict(theirs.to_dict(),
                                                    schema_version=0)))):
        assert o.stale_reason() == t.stale_reason()
        assert o.stale_reason(cfg=LlamaConfig.tiny()) \
            == t.stale_reason(cfg=JaxConfig.tiny())
        assert o.stale_reason(cfg=grown) == t.stale_reason(cfg=jgrown)
        assert o.stale_reason(space=space) == t.stale_reason(space=space)
    # device rows are each package's own
    assert "device row" in ours.stale_reason(device="cpu-container")
    assert ours.stale_reason(device="h100-sxm") is None


def test_artifacts_cross_between_packages(tmp_path):
    """A JAX-saved artifact loads in the port to the same dict, and the
    reverse; both use the same file name in a directory."""
    assert tuner.TUNE_FILENAME == jtuner.TUNE_FILENAME
    assert tuner.SCHEMA_VERSION == jtuner.SCHEMA_VERSION
    assert tuner.KNOBS == jtuner.KNOBS
    d = dict(schema_version=1, device="tpu-v5e", model="m",
             space_hash="abc", knobs={"block_size": 16,
                                      "decode_megakernel": "full"},
             predicted={"step_ms": 1.5})
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jtuner.TunedConfig.from_dict(d).save(str(tmp_path / "jax"))
    assert TunedConfig.load(str(tmp_path / "jax")).to_dict() == d
    TunedConfig.from_dict(d).save(str(tmp_path / "port"))
    assert jtuner.TunedConfig.load(str(tmp_path / "port")).to_dict() == d


# ---------------------------------------------------------------------------
# the port's ranking (tiny, h100-sxm row, JAX's pinned space)
# ---------------------------------------------------------------------------

RANK_KW = dict(KW, device="cpu", dtype=torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _demo_runs():
    """Two identical autotune runs under the port's demo budget (the
    baseline's traced peak), shared by the ranking tests; the params'
    bytes before and after."""
    raw, _ = _weights()
    params = params_from_jax(raw, device="cpu", dtype=torch.bfloat16)
    before = {k: v.clone() for k, v in params.items()}
    cfg = LlamaConfig.tiny()
    space = _pinned(tuner.default_space(cfg, RANK_KW))
    runs = [autotune(cfg, params, engine_kwargs=RANK_KW, device="h100-sxm",
                     hbm_budget_bytes=demo_budget, space=space)
            for _ in range(2)]
    budget = runs[0].hbm_budget_bytes
    return cfg, params, before, space, budget, runs


def test_ranking_is_deterministic_and_leaves_params_unchanged():
    _, params, before, _, _, (r1, r2) = _demo_runs()
    assert r1.to_dict(top_k=0) == r2.to_dict(top_k=0)
    assert r1.to_json() == r2.to_json()
    assert all(torch.equal(params[k], before[k]) for k in before)


def test_both_prune_stages_fire_and_the_baseline_stays_feasible():
    _, _, _, _, budget, (rep, _) = _demo_runs()
    d = rep.to_dict(top_k=0)
    assert d["device"] == "h100-sxm" and d["hbm_budget_bytes"] == budget
    static = [p for p in d["pruned"] if "before tracing" in p["pruned_reason"]]
    traced = [p for p in d["pruned"]
              if "traced per-chip peak" in p["pruned_reason"]]
    assert static and traced
    assert all(p["static_bound_bytes"] > budget for p in static)
    # the larger page class is over the budget statically
    assert {p["config"]["block_size"] for p in static} == {16}
    assert any(p["config"]["unified_step"] for p in traced)
    ranked = {tuner._config_key(c.config) for c in rep.ranking}
    assert not ranked & {tuner._config_key(p["config"]) for p in d["pruned"]}
    assert d["baseline"]["feasible"]
    assert d["best"]["predicted_step_ms"] \
        <= d["baseline"]["predicted_step_ms"]
    assert d["predicted_speedup_vs_default"] >= 1.0
    # no communication pass on one device: the schema's key reads 0.0
    assert all(c.predicted_wire_bytes_per_token == 0.0
               and c.n_programs == 1 + c.config["unified_step"]
               for c in rep.ranking)


def test_int8_twins_bound_no_more_than_bf16():
    _, _, _, _, _, (rep, _) = _demo_runs()
    results = rep.ranking + rep.pruned
    by_key = {tuner._config_key(r.config): r for r in results}
    pairs = 0
    for r in results:
        if r.config["kv_cache_dtype"] != "int8":
            continue
        twin = by_key.get(tuner._config_key(dict(r.config,
                                                 kv_cache_dtype="bf16")))
        if twin is None:
            continue
        pairs += 1
        assert r.static_bound_bytes <= twin.static_bound_bytes
        if r.peak_hbm_bytes is not None and twin.peak_hbm_bytes is not None:
            assert r.peak_hbm_bytes <= twin.peak_hbm_bytes
    assert pairs > 0


def test_budget_candidates_keeps_the_baseline():
    cfg, params, _, _, _, _ = _demo_runs()
    rep = autotune(cfg, params, engine_kwargs=RANK_KW, device="h100-sxm",
                   budget_candidates=2)
    d = rep.to_dict()
    assert d["n_candidates"] <= 3 and d["baseline"]["feasible"]
    assert rep.baseline.config == tuner.baseline_config(cfg, RANK_KW)


def test_report_is_byte_identical_without_the_program_memo(monkeypatch):
    """Candidates that share their decode chunk (the split path and two
    unified windows, for each pool dtype): every program traced anew
    gives the report the memo gave, which traced each decode chunk
    once."""
    cfg, params, _, _, budget, _ = _demo_runs()
    base = tuner.baseline_config(cfg, RANK_KW)
    space = {k: [v] for k, v in base.items()}
    space.update(kv_cache_dtype=["bf16", "int8"], unified_step=[False, True],
                 token_budget=[16, 32])
    traced = []
    real = ContinuousBatchingEngine._traced_inventory

    def counted(self, programs=None):
        out = real(self, programs)
        traced.extend(name for name, _ in out)
        return out

    def tune():
        return autotune(cfg, params, engine_kwargs=RANK_KW,
                        device="h100-sxm", hbm_budget_bytes=budget,
                        space=space)

    monkeypatch.setattr(ContinuousBatchingEngine, "_traced_inventory",
                        counted)
    memo = tune()
    assert memo.n_candidates == 6
    assert sorted(traced) == ["decode"] * 2 + ["unified"] * 4
    traced.clear()
    # a key that never repeats: every program misses the memo
    monkeypatch.setattr(tuner, "_program_key",
                        lambda program, config: object())
    assert tune().to_json() == memo.to_json()
    assert sorted(traced) == ["decode"] * 6 + ["unified"] * 4


def test_mesh_candidates_are_pruned_by_name(monkeypatch):
    """A caller's space asking for serving_mp / serving_cp above 1 prunes
    those candidates naming ROADMAP item 5, without building them."""
    cfg, params, _, _, _, _ = _demo_runs()
    base = tuner.baseline_config(cfg, RANK_KW)
    space = {k: [v] for k, v in base.items()}
    space.update(serving_mp=[1, 2], serving_cp=[1, 2])
    built = []
    real = tuner._fake_engine
    monkeypatch.setattr(tuner, "_fake_engine",
                        lambda c, p, kw: built.append(kw) or real(c, p, kw))
    rep = autotune(cfg, params, engine_kwargs=RANK_KW, space=space)
    assert rep.n_candidates == 4 and len(rep.ranking) == 1
    assert all("item 5" in p.pruned_reason for p in rep.pruned)
    assert len(built) == 1 and built[0]["serving_mp"] == 1


# ---------------------------------------------------------------------------
# the engine's config= and FLAGS_tuned_config
# ---------------------------------------------------------------------------

ENGINE_KW = dict(slots=2, prompt_bucket=16, max_prompt_len=32,
                 max_new_tokens=8, steps_per_sync=4, device="cpu",
                 dtype=torch.float32)


def _tuned():
    """An artifact for tiny() asking for every knob away from its
    default."""
    return TunedConfig(
        knobs=dict(block_size=16, decode_megakernel="attn",
                   kv_cache_dtype="int8", quantized_collectives=False,
                   serving_cp=1, serving_mp=1, spec_k=0, speculative="off",
                   token_budget=32, unified_step=True),
        device="h100-sxm", model=tuner.model_signature(LlamaConfig.tiny()),
        space_hash="0", predicted={"step_ms": 1.0})


@pytest.fixture
def flags():
    old = get_flags(["tuned_config", "compile_cache"])
    yield set_flags
    set_flags(old)


@pytest.mark.parametrize("form", ["object", "dict", "path"])
def test_engine_applies_the_artifact(form, tmp_path):
    """config= takes the artifact, its dict or a path: every knob
    resolves, metrics() reports it, warm_compile_stats is None until
    warm() and then holds JAX's five keys, and compile_stats() stays
    steady under traffic after warm(buckets=)."""
    _, params = _weights()
    tc = _tuned()
    config = {"object": tc, "dict": tc.to_dict(),
              "path": tc.save(str(tmp_path))}[form]
    eng = ContinuousBatchingEngine(LlamaConfig.tiny(), params, config=config,
                                   **ENGINE_KW)
    assert (eng.block_size, eng.use_megakernel, eng.megakernel_rung,
            eng.kv_dtype, eng.token_budget, eng.unified, eng.speculative) \
        == (16, "attn", "attn", "int8", 32, True, "off")
    m = eng.metrics()
    assert m["tuned_config"] == tc.to_dict()
    assert m["warm_compile_stats"] is None
    eng.warm(buckets=(16, 32))
    stats = eng.warm_compile_stats
    assert sorted(stats) == sorted(["persistent_cache_dir",
                                    "counters_available", "compile_requests",
                                    "cache_hits", "cache_misses"])
    # the CPU loads no kernel library
    assert stats["compile_requests"] == stats["cache_misses"] == 0
    before = eng.compile_stats()
    for n in (3, 9, 14):
        eng.add_request(list(range(1, n + 1)), max_new=3)
    eng.run(max_iters=120)
    assert len(eng.finished) == 3
    assert eng.compile_stats() == before
    assert eng.metrics()["warm_compile_stats"] == stats


def test_explicit_kwarg_beats_the_artifact():
    _, params = _weights()
    eng = ContinuousBatchingEngine(LlamaConfig.tiny(), params, config=_tuned(),
                                   kv_cache_dtype="bf16", block_size=8,
                                   **ENGINE_KW)
    assert (eng.kv_dtype, eng.block_size, eng.token_budget) \
        == ("bf16", 8, 32)


def test_stale_and_unreadable_artifacts(tmp_path, flags):
    """A stale explicit artifact raises; through the flag a stale or
    unreadable one warns and builds with the flags' defaults."""
    _, params = _weights()
    cfg = LlamaConfig.tiny()
    stale = TunedConfig.from_dict(dict(_tuned().to_dict(),
                                       model="llama:other"))
    with pytest.raises(ValueError, match="stale TunedConfig"):
        ContinuousBatchingEngine(cfg, params, config=stale, **ENGINE_KW)
    (tmp_path / "bad").write_text("{not json")
    for path, word in ((stale.save(str(tmp_path)), "stale"),
                       (str(tmp_path / "bad"), "unreadable")):
        flags({"tuned_config": path})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = ContinuousBatchingEngine(cfg, params, block_size=8,
                                           **ENGINE_KW)
        assert any(word in str(w.message) for w in caught)
        assert eng.tuned_config is None and eng.kv_dtype == "bf16"
        assert eng.metrics()["tuned_config"] is None


def test_config_false_beats_the_flag(tmp_path, flags):
    _, params = _weights()
    cfg = LlamaConfig.tiny()
    flags({"tuned_config": _tuned().save(str(tmp_path))})
    assert ContinuousBatchingEngine(cfg, params, **ENGINE_KW) \
        .tuned_config.to_dict() == _tuned().to_dict()
    eng = ContinuousBatchingEngine(cfg, params, config=False, block_size=8,
                                   **ENGINE_KW)
    assert eng.tuned_config is None and eng.kv_dtype == "bf16"


def test_one_artifact_gives_both_engines_the_same_knobs_and_tokens():
    """One artifact (unified step pinned on) applied to the JAX engine and
    to the port's: equal resolved knobs and identical greedy streams."""
    raw, params = _weights()
    d = dict(_tuned().to_dict(), knobs=dict(
        block_size=8, decode_megakernel="off", kv_cache_dtype="bf16",
        quantized_collectives=False, serving_cp=1, serving_mp=1, spec_k=0,
        speculative="off", token_budget=16, unified_step=True))
    geo = dict(slots=2, prompt_bucket=16, max_prompt_len=32,
               max_new_tokens=6, steps_per_sync=3, prefix_cache=False)
    jeng = JaxEngine(JaxConfig.tiny(), dict(raw), config=d,
                     dtype=jnp.float32, **geo)
    teng = ContinuousBatchingEngine(LlamaConfig.tiny(), params, config=d,
                                    device="cpu", dtype=torch.float32, **geo)
    knobs = ("block_size", "use_megakernel", "kv_dtype", "unified",
             "token_budget", "speculative", "spec_k")
    assert [getattr(teng, k) for k in knobs] \
        == [getattr(jeng, k) for k in knobs]
    assert teng.metrics()["tuned_config"] == jeng.metrics()["tuned_config"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 128, (n,)).tolist() for n in (5, 21, 9, 30)]
    for e in (jeng, teng):
        for p in prompts:
            e.add_request(p)
        e.run(max_iters=200)
    assert {r.req_id: r.tokens for r in teng.finished} \
        == {r.req_id: r.tokens for r in jeng.finished}


# ---------------------------------------------------------------------------
# the kernel build cache
# ---------------------------------------------------------------------------

_STUB_NVCC = """\
#!{python}
import sys
open(sys.argv[sys.argv.index("-o") + 1], "wb").write(b"stub")
"""

_WARM_PROCESS = textwrap.dedent("""\
    import json
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import compile_cache
    snap = compile_cache.snapshot()
    _build.build_all()
    print(json.dumps(compile_cache.stats_since(snap)))
""")


def test_build_cache_counts_a_cold_build_and_a_fresh_process(
        tmp_path, monkeypatch, flags):
    """With FLAGS_compile_cache at a fresh directory, a cold build counts
    one miss per kernel source (the compiler stubbed by a script named
    nvcc on PATH); a fresh process over the same directory builds
    nothing: cache_misses 0 and cache_hits == compile_requests > 0."""
    bindir, cache = tmp_path / "bin", tmp_path / "cache"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(_STUB_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    assert compile_cache.enable_compile_cache(str(cache)) == str(cache)
    assert compile_cache.cache_dir() == str(cache)
    snap = compile_cache.snapshot()
    _build.build_all()
    cold = compile_cache.stats_since(snap)
    assert cold == {"persistent_cache_dir": str(cache),
                    "counters_available": True,
                    "compile_requests": len(_build.SIGNATURES),
                    "cache_hits": 0, "cache_misses": len(_build.SIGNATURES)}
    out = subprocess.run(
        [sys.executable, "-c", _WARM_PROCESS], capture_output=True,
        text=True, cwd=str(tmp_path), timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT,
                 PADDLE_TPU_COMPILE_CACHE=str(cache)))
    assert out.returncode == 0, out.stderr[-2000:]
    hot = json.loads(out.stdout.strip().splitlines()[-1])
    assert hot["cache_misses"] == 0
    assert hot["cache_hits"] == hot["compile_requests"] \
        == len(_build.SIGNATURES)
    # with the flag empty the build cache is the package's _build/ (the
    # JAX module returns None while its cache is off)
    flags({"compile_cache": ""})
    assert compile_cache.cache_dir() == str(_build.BUILD_DIR)
    assert compile_cache.enable_compile_cache("") is None


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

# every key the JAX CLI test's _assert_schema lists
TUNING_KEYS = ("device", "model", "space", "space_hash", "hbm_budget_bytes",
               "n_candidates", "n_feasible", "n_pruned", "ranking", "pruned",
               "baseline", "best", "predicted_speedup_vs_default",
               "engine_geometry")


def test_cli_tune_json_schema_and_artifact(tmp_path):
    """`--tune --format json --device cpu-container --budget-candidates
    24` (the JAX CLI test's cap: the page-8 prefix of the default space,
    off rung, both pool dtypes, so its prunes are the traced ones; the
    static stage is held by the ranking tests): exit 0, JAX's schema, a
    feasible baseline no faster than the winner; --tune-out writes an
    artifact config= loads."""
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", "--tune",
         "--format", "json", "--device", "cpu-container",
         "--budget-candidates", "24", "--tune-out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    d = json.loads(out.stdout)
    assert sorted(d) == ["counts", "diagnostics", "target", "tuning"]
    t = d["tuning"]
    assert all(k in t for k in TUNING_KEYS)
    assert t["device"] == "cpu-container" and t["n_candidates"] == 24
    assert any("traced per-chip peak" in p["pruned_reason"]
               for p in t["pruned"])
    assert t["baseline"]["feasible"]
    assert t["best"]["predicted_step_ms"] \
        <= t["baseline"]["predicted_step_ms"]
    assert t["predicted_speedup_vs_default"] >= 1.0
    assert d["counts"]["error"] == 0
    tc = TunedConfig.load(str(tmp_path))
    assert tc.knobs == t["best"]["config"]
    _, params = _weights()
    eng = ContinuousBatchingEngine(LlamaConfig.tiny(), params,
                                   config=str(tmp_path), **ENGINE_KW)
    assert eng.metrics()["tuned_config"] == tc.to_dict()
    assert eng.block_size == tc.knobs["block_size"]
    assert eng.kv_dtype == tc.knobs["kv_cache_dtype"]


def test_cli_tune_fail_on_warning_exits_1(capsys):
    """The tiny decode program lints with warnings, so --fail-on warning
    exits 1 on the winner's program."""
    assert main(["--tune", "--device", "cpu-container",
                 "--budget-candidates", "2", "--fail-on", "warning"]) == 1
    assert "autotune:" in capsys.readouterr().out
