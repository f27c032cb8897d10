"""The port's speculative decoding against the JAX package, on the CPU, in
f32 on ``LlamaConfig.tiny()`` with two kv heads.

Pieces: the verify window's logits and window K/V against JAX
``_make_verify_window`` + head (its ragged Pallas kernel run as the JAX
tests run it on the CPU) to 1e-5, over f32 pools, int8 pools and the scan
rung's layer-major pool; the pools after the verify scatter byte-identical
to the JAX engine's ``_verify_scatter`` on the same window K/V (f32, int8
ints and scales, the scan layout with its per-layer table offset); the
resolvers, ``NGramDrafter`` proposals on seeded random histories and the
``AdaptiveSpecPolicy`` trajectory equal to JAX's.

Engines: each run serves the same traffic (prefix-cache churn through two
slots: repetitive rows the n-gram drafter accepts on, and cold rows) through
the JAX engine and the port's, on the same weights (``params_from_jax``):
tokens equal up to the JAX model's near-ties (tests/test_torch_engine.py's
rule) and equal spec_steps, spec_drafted, spec_accepted, device_steps and
prefill_calls. The runs cover split and unified, double-buffered, bf16
(f32 here) and int8 pools, dense and int4 weights, each megakernel rung
(plain versions on the CPU), an oracle drafter whose drafts are the
spec-off tokens (every draft accepted), ``DraftModelDrafter`` and adaptive
depth; int8 weights at n-gram depth 8 run in
tests/test_torch_disaggregated.py (speculative and disaggregated). Then
the validation errors, the flags (FLAGS_speculative with speculative=None
builds a speculating engine; the port used to ignore it) and the module
smoke.
"""
import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import speculative as jspec
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models import llama as pl
from paddle_tpu_torch.serving import (AdaptiveSpecPolicy,
                                      ContinuousBatchingEngine, Drafter,
                                      DraftModelDrafter, NGramDrafter)
from paddle_tpu_torch.serving import speculative as pspec

NEAR_TIE = 1e-4
SPEC_COUNTERS = ("spec_steps", "spec_drafted", "spec_accepted",
                 "device_steps", "prefill_calls")


def _setup(nkv=2, seed=21):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=nkv)
    paddle.seed(seed)
    jm = JaxModel(jcfg)
    raw = dict(jm.raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=nkv)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, jm, raw, cfg, p


@pytest.fixture(scope="module")
def model():
    return _setup()


def _np_pairs(dec):
    return {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v) for k, v in dec.items()}


def _weights(jm, raw, weights):
    """(JAX decode params, the port's) for 'dense' or a weight-only kind."""
    jdec = raw if weights == "dense" else jm._decode_params(raw, weights)
    return jdec, params_from_jax(_np_pairs(jdec), device="cpu")


def _port(cfg, p, **kw):
    return ContinuousBatchingEngine(cfg, p, device="cpu",
                                    dtype=torch.float32, **kw)


ENGINE_KW = dict(slots=2, prompt_bucket=8, max_prompt_len=32,
                 max_new_tokens=8, block_size=8, steps_per_sync=3,
                 prefix_cache=True)


def _churn_prompts(vocab, rng):
    """tests/test_speculative.py's trace: a shared 8-token head and a
    repeated phrase (the n-gram drafter's food), and cold rows."""
    shared = rng.integers(1, vocab, (8,)).tolist()
    phrase = rng.integers(1, vocab, (6,)).tolist()
    return ([shared + phrase * 3 + rng.integers(1, vocab, (n,)).tolist()
             for n in (3, 5)]
            + [rng.integers(1, vocab, (n,)).tolist() for n in (5, 2, 17)])


def _serve(eng, prompts, max_new=8):
    reqs = [eng.add_request(pr, max_new=max_new) for pr in prompts]
    eng.run(max_iters=1000)
    assert all(r.done for r in reqs)
    assert eng.mgr.n_available == eng.mgr.max_pages - 1   # drained
    return {r.req_id: list(r.tokens) for r in reqs}


def _jax_logits(jcfg, jdec, ids):
    h, _ = jl._make_prefill(jcfg, 1, len(ids))(jdec,
                                              jnp.asarray([ids], jnp.int32))
    return np.asarray(jl._make_head_logits(jcfg)(h, jdec))[0, -1]


def _assert_same_up_to_ties(jcfg, jdec, prompts, ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for rid, prompt in enumerate(prompts):
        a, b = ours[rid], theirs[rid]
        assert len(a) == len(b)
        if a != b:
            i = next(j for j in range(len(a)) if a[j] != b[j])
            row = np.sort(_jax_logits(jcfg, jdec, prompt + b[:i]))
            assert float(row[-1] - row[-2]) < NEAR_TIE, (rid, i)


# ---------------------------------------------------------------------------
# the verify window and its scatter
# ---------------------------------------------------------------------------

# three slots: no cache, a window from a page edge, a window straddling
# two pages; new lengths 1, 5 and 3 of a 5-row window
CACHED, NEW, W_ROWS, PAGE, TBL_W = [0, 8, 13], [1, 5, 3], 5, 8, 4


def _pools(jcfg, kind, rng):
    """Per-layer (or, for 'scan', one layer-major) pools as numpy: f32
    arrays, or (int8, f32 scale) pairs for 'int8'."""
    L, nkv, dh = (jcfg.num_hidden_layers, jcfg.num_key_value_heads,
                  jcfg.head_dim)
    n_pages = len(CACHED) * TBL_W + 1
    scan = kind.endswith("scan")
    rows, n = (n_pages * L, 1) if scan else (n_pages, L)

    def one():
        if kind.startswith("int8"):
            return (rng.integers(-127, 128, (rows, nkv, PAGE, dh))
                    .astype(np.int8),
                    rng.uniform(0.001, 0.02, (rows, nkv)).astype(np.float32))
        return rng.standard_normal((rows, nkv, PAGE, dh)).astype(np.float32)

    return [one() for _ in range(n)], [one() for _ in range(n)], n_pages


def _tables(rng, n_pages):
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    return perm[:len(CACHED) * TBL_W].reshape(len(CACHED), TBL_W)


def _as_jax(pools):
    return [tuple(jnp.asarray(a) for a in e) if isinstance(e, tuple)
            else jnp.asarray(e) for e in pools]


def _as_torch(pools):
    return [tuple(torch.from_numpy(a.copy()) for a in e)
            if isinstance(e, tuple) else torch.from_numpy(e.copy())
            for e in pools]


@pytest.mark.parametrize("kind", ["f32", "int8-scan"])
def test_verify_window_matches_jax(model, kind):
    """Every row's logits (pad rows included: their attention is exactly
    zero in both) and every layer's window K/V within 1e-5 of JAX
    `_make_verify_window` + head at token-granular cached lengths."""
    jcfg, _, raw, cfg, p = model
    rng = np.random.default_rng(3)
    kc, vc, n_pages = _pools(jcfg, kind, rng)
    tables = _tables(rng, n_pages)
    ids = rng.integers(1, cfg.vocab_size, (len(CACHED), W_ROWS))
    jdec, pdec = raw, p
    if kind.endswith("scan"):
        L = cfg.num_hidden_layers
        jdec = jl.stack_decode_layer_params(raw, L)
        pdec = pl.stack_decode_layer_params(p, L)
    b = len(CACHED)
    jh, jkv = jl._make_verify_window(jcfg, b, W_ROWS)(
        jdec, _as_jax(kc), _as_jax(vc), jnp.asarray(ids, jnp.int32),
        jnp.asarray(tables), jnp.asarray(CACHED, jnp.int32),
        jnp.asarray(NEW, jnp.int32))
    jlog = np.asarray(jl._make_head_logits(jcfg)(jh, jdec))
    th, tkv = pl._make_verify_window(cfg, b, W_ROWS)(
        pdec, _as_torch(kc), _as_torch(vc), torch.from_numpy(ids),
        torch.from_numpy(tables), torch.tensor(CACHED, dtype=torch.int32),
        torch.tensor(NEW, dtype=torch.int32))
    tlog = pl._make_head_logits(cfg)(th, pdec).numpy()
    assert tlog.shape == (b, W_ROWS, cfg.vocab_size)
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5, atol=1e-5)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def _spec_engines(jcfg, raw, cfg, p, kv, rung, slots=3):
    kw = dict(slots=slots, prompt_bucket=8, max_prompt_len=16,
              max_new_tokens=16, block_size=PAGE, kv_cache_dtype=kv,
              decode_megakernel=rung, speculative="ngram", spec_k=4,
              unified_step=False)
    return (JaxEngine(jcfg, dict(raw), dtype=jnp.float32, **kw),
            _port(cfg, p, **kw))


@pytest.mark.parametrize("kind", ["f32", "int8", "scan", "int8-scan"])
def test_verify_scatter_matches_jax_bytes(model, kind):
    """The same window K/V through the JAX engine's `_verify_scatter` and
    the port's, as the verify program calls it (the scan rung: one
    layer-major pool, each layer's table offset by its rows): identical
    pools, int8 ints and scales included. Slot 0 is dead (scratch table,
    new_len 1); slot 1's window crosses a page edge with two pad columns;
    slot 2's five columns share one page, so each int8 column's rescale
    reads the one before."""
    jcfg, _, raw, cfg, p = model
    kv = "int8" if kind.startswith("int8") else "bf16"
    rung = "scan" if kind.endswith("scan") else "off"
    jeng, peng = _spec_engines(jcfg, raw, cfg, p, kv, rung)
    assert peng.megakernel_rung == jeng.megakernel_rung == rung
    rng = np.random.default_rng(4)
    L, nkv, dh = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim)
    pools = [np.asarray(x) for x in jl_leaves(jeng.kcs + jeng.vcs)]
    filled = []
    for a in pools:
        if a.dtype == np.int8:
            filled.append(rng.integers(-127, 128, a.shape).astype(np.int8))
        elif a.ndim == 2:
            filled.append(rng.uniform(0.001, 0.02, a.shape)
                          .astype(np.float32))
        else:
            filled.append(rng.standard_normal(a.shape).astype(np.float32))
    w, W = W_ROWS, peng.table_width
    tables = np.full((3, W), peng.scratch_page, np.int32)
    pages = rng.permutation([i for i in range(peng.mgr.max_pages)
                             if i != peng.scratch_page]).astype(np.int32)
    tables[1], tables[2] = pages[:W], pages[W:2 * W]
    cached = np.asarray([0, 6, 16], np.int32)
    new = np.asarray([1, 3, 5], np.int32)
    kvs = [(rng.standard_normal((3, w, nkv, dh)).astype(np.float32),
            rng.standard_normal((3, w, nkv, dh)).astype(np.float32))
           for _ in range(L)]
    stride = peng._page_stride
    assert stride == (peng.mgr.max_pages if rung == "scan" else 0)
    n_pool = len(peng.kcs)
    per = 2 if kv == "int8" else 1

    def split(arrs, make):
        it = iter(arrs)
        entries = [tuple(make(next(it)) for _ in range(per)) if per == 2
                   else make(next(it)) for _ in range(2 * n_pool)]
        return entries[:n_pool], entries[n_pool:]

    jk, jv = split(filled, jnp.asarray)
    tk, tv = split(filled, lambda a: torch.from_numpy(a.copy()))
    jscatter = jeng._verify_scatter(w)
    tscatter = peng._verify_scatter(w)
    for i, (k, v) in enumerate(kvs):
        j = 0 if stride else i
        tbl = tables + i * stride
        jk[j], jv[j] = jscatter(jk[j], jv[j], jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(tbl),
                                jnp.asarray(cached), jnp.asarray(new))
        tscatter(tk[j], tv[j], torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(tbl), torch.from_numpy(cached),
                 torch.from_numpy(new))
    got = [t.numpy() for t in jl_leaves(tk + tv)]
    want = [np.asarray(a) for a in jl_leaves(jk + jv)]
    changed = 0
    for g, wnt, before in zip(got, want, filled):
        assert g.dtype == wnt.dtype and np.array_equal(g, wnt)
        changed += int((g != before).sum())
    assert changed > 0


def jl_leaves(entries):
    out = []
    for e in entries:
        out.extend(e if isinstance(e, tuple) else (e,))
    return out


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [None, "off", "NGRAM ", "", "draft",
                                   "treeverify"])
def test_resolve_speculative_matches_jax(value):
    def run(fn):
        try:
            return fn(value)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(pspec.resolve_speculative) == run(jspec.resolve_speculative)


@pytest.mark.parametrize("value", [None, 1, 8, 0, -2])
def test_resolve_spec_k_matches_jax(value):
    def run(fn):
        try:
            return fn(value)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(pspec.resolve_spec_k) == run(jspec.resolve_spec_k)


@pytest.mark.parametrize("value", [None, True, False, "on", "0", " Yes",
                                   "no", 1])
def test_resolve_spec_adaptive_matches_jax(value):
    assert pspec.resolve_spec_adaptive(value) \
        == jspec.resolve_spec_adaptive(value)


@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1), (1, 1)])
def test_ngram_proposals_match_jax(ngram):
    """Seeded random histories over a small alphabet (so n-grams recur),
    every k from 0 to 6: the port's proposals equal JAX's."""
    rng = np.random.default_rng(sum(ngram))
    ours = NGramDrafter(max_ngram=ngram[0], min_ngram=ngram[1])
    theirs = jspec.NGramDrafter(max_ngram=ngram[0], min_ngram=ngram[1])
    hits = 0
    for _ in range(200):
        hist = rng.integers(0, 6, int(rng.integers(0, 40))).tolist()
        k = int(rng.integers(0, 7))
        got = ours.draft(0, 0, hist, k)
        assert got == theirs.draft(0, 0, hist, k)
        hits += bool(got)
    assert hits > 50


def test_ngram_validation_matches_jax():
    for bad in (dict(max_ngram=1, min_ngram=2), dict(min_ngram=0)):
        with pytest.raises(ValueError, match="min_ngram"):
            NGramDrafter(**bad)
        with pytest.raises(ValueError, match="min_ngram"):
            jspec.NGramDrafter(**bad)


@pytest.mark.parametrize("kw", [dict(), dict(patience=1),
                                dict(alpha=0.5, shrink_below=0.3,
                                     grow_above=0.6),
                                dict(spec_k=8, patience=2)])
def test_adaptive_policy_trajectory_matches_jax(kw):
    """The same (offered, accepted) stream: the same effective depth and
    EWMA after every window (empty windows included)."""
    k = kw.pop("spec_k", 4)
    ours = AdaptiveSpecPolicy(k, **kw)
    theirs = jspec.AdaptiveSpecPolicy(k, **kw)
    rng = np.random.default_rng(k)
    depths = set()
    for phase in range(6):
        for _ in range(20):
            offered = int(rng.integers(0, k + 1))
            accepted = offered if phase % 2 else int(
                rng.integers(0, offered + 1)) // 2
            ours.observe(offered, accepted)
            theirs.observe(offered, accepted)
            assert ours.spec_k_effective == theirs.spec_k_effective
            assert ours.acceptance_ewma == theirs.acceptance_ewma
            depths.add(ours.spec_k_effective)
    assert min(depths) == 1 and max(depths) == k
    with pytest.raises(ValueError, match="spec_k"):
        AdaptiveSpecPolicy(0)


# ---------------------------------------------------------------------------
# engines against the JAX engine
# ---------------------------------------------------------------------------

class _OracleDrafter(Drafter):
    """Drafts exactly the tokens a spec-off engine produced: if window row
    j scores what the j-th sequential decode step does, every draft is
    accepted (tests/test_speculative.py)."""

    def __init__(self, answers, prompt_lens):
        self.answers = answers
        self.prompt_lens = prompt_lens

    def draft(self, slot_id, req_id, history, k, table_row=None,
              budget=None):
        emitted = len(history) - self.prompt_lens[req_id]
        return list(self.answers[req_id][emitted:emitted + k])


# (weights, megakernel rung, pool dtype, unified, spec_k, double_buffer,
#  adaptive, drafter)
RUNS = [
    ("dense", "attn", "bf16", True, 4, False, False, "ngram"),
    ("weight_only_int4", "off", "int8", True, 4, False, True, "ngram"),
    ("dense", "full", "int8", True, 3, True, False, "draft"),
    ("dense", "scan", "bf16", False, 3, True, True, "oracle"),
]


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_spec_engines_match_jax(model, run):
    weights, rung, kv, unified, k, db, adaptive, drafter = run
    jcfg, jm, raw, cfg, _ = model
    jdec, p = _weights(jm, raw, weights)
    prompts = _churn_prompts(cfg.vocab_size, np.random.default_rng(5))
    kw = dict(ENGINE_KW, kv_cache_dtype=kv, decode_megakernel=rung,
              unified_step=unified, double_buffer=db,
              speculative="draft" if drafter == "draft" else "ngram",
              spec_k=k, spec_adaptive=adaptive)
    jd = pd = None
    if drafter == "draft":
        # the target's own weights as the draft model, f32 draft pools
        jd = jspec.DraftModelDrafter(jcfg, jdec, dtype=jnp.float32)
        pd = DraftModelDrafter(cfg, p, dtype=torch.float32)
    elif drafter == "oracle":
        off = _port(cfg, p, **dict(kw, speculative="off"))
        answers = _serve(off, prompts)
        lens = {rid: len(pr) for rid, pr in enumerate(prompts)}
        # the port's Drafter carries every hook the JAX engine calls
        jd, pd = _OracleDrafter(answers, lens), _OracleDrafter(answers, lens)
    jeng = JaxEngine(jcfg, jdec, dtype=jnp.float32, drafter=jd, **kw)
    theirs = _serve(jeng, prompts)
    eng = _port(cfg, p, drafter=pd, **kw)
    assert eng.megakernel_rung == jeng.megakernel_rung
    ours = _serve(eng, prompts)
    _assert_same_up_to_ties(jcfg, jdec, prompts, ours, theirs)
    for name in SPEC_COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    m, jm_ = eng.metrics(), jeng.metrics()
    for key in ("speculative", "spec_k", "spec_adaptive", "spec_k_effective",
                "spec_steps", "spec_drafted", "spec_accepted",
                "acceptance_rate", "prefix_hit_tokens"):
        assert m[key] == jm_[key], key
    assert eng.spec_drafted > 0 and eng.spec_accepted > 0
    if drafter == "oracle":
        assert ours == answers          # the spec-off engine's tokens
        assert eng.spec_accepted == eng.spec_drafted
    if drafter == "draft":
        assert pd._bound == [None] * eng.slots   # retire released them
        assert not pd._len.any()
    if adaptive:
        assert eng._spec_policy.acceptance_ewma \
            == jeng._spec_policy.acceptance_ewma is not None
    want = {"decode": 1, "verify": 1}
    if unified:
        want["unified"] = 1
    if drafter == "draft":
        want["draft"] = 1
    # the split path's prefill programs, captured at their first use: the
    # JAX engine's program keys, one capture each
    want.update({k: 1 for k in jeng.compile_stats()
                 if k.startswith("prefill:")})
    assert eng.compile_stats() == want


def test_spec_off_builds_the_engine_as_before(model):
    """speculative='off' builds no verify program and no drafter, and
    metrics() reports a static depth of 0."""
    _, _, _, cfg, p = model
    eng = _port(cfg, p, **ENGINE_KW, speculative="off", spec_k=8,
                drafter=NGramDrafter())
    assert eng._verify is None and eng._drafter is None
    assert set(eng._programs) == {"decode"}
    m = eng.metrics()
    assert (m["speculative"], m["spec_k"], m["spec_k_effective"],
            m["acceptance_rate"]) == ("off", 0, 0, 0.0)
    on = _port(cfg, p, **ENGINE_KW, speculative="ngram", spec_k=3)
    assert on._spec_policy is None and on.metrics()["spec_k_effective"] == 3
    assert isinstance(on._drafter, NGramDrafter)


def test_validation_errors(model):
    jcfg, _, raw, cfg, p = model
    for build in (lambda **kw: _port(cfg, p, **ENGINE_KW, **kw),
                  lambda **kw: JaxEngine(jcfg, dict(raw), dtype=jnp.float32,
                                         **ENGINE_KW, **kw)):
        with pytest.raises(ValueError, match="greedy-only"):
            build(speculative="ngram", do_sample=True)
        with pytest.raises(ValueError, match="DraftModelDrafter"):
            build(speculative="draft")
        with pytest.raises(ValueError, match="spec_k"):
            build(speculative="ngram", spec_k=-1)
        with pytest.raises(ValueError, match="speculative"):
            build(speculative="tree")
    with pytest.raises(RuntimeError, match="attach"):
        DraftModelDrafter(cfg, p).draft(0, 0, [1, 2], 2)
    draft_cpu = {k: v for k, v in p.items()}
    draft_cpu["llama.embed_tokens.weight"] = \
        p["llama.embed_tokens.weight"].to("meta")
    with pytest.raises(ValueError, match="draft params live on meta"):
        _port(cfg, p, **ENGINE_KW, speculative="draft",
              drafter=DraftModelDrafter(cfg, draft_cpu))


def test_speculative_flag_builds_a_speculating_engine(model):
    """FLAGS_speculative / spec_k / spec_adaptive with speculative=None:
    the port's engine speculates as the JAX engine does. Before this port
    the flag was read by nobody and the engine served spec-off."""
    jcfg, _, raw, cfg, p = model
    names = ["speculative", "spec_k", "spec_adaptive"]
    prev, jprev = pflags.get_flags(names), paddle.get_flags(names)
    want = {"speculative": "ngram", "spec_k": 3, "spec_adaptive": True}
    pflags.set_flags(want)
    paddle.set_flags(want)
    try:
        eng = _port(cfg, p, **ENGINE_KW)
        jeng = JaxEngine(jcfg, dict(raw), dtype=jnp.float32, **ENGINE_KW)
        for e in (eng, jeng):
            assert (e.speculative, e.spec_k, e.spec_adaptive) \
                == ("ngram", 3, True)
        assert "verify" in eng.compile_stats()
        prompts = _churn_prompts(cfg.vocab_size, np.random.default_rng(9))
        ours = _serve(eng, prompts)
        assert eng.spec_steps > 0 and eng.spec_drafted > 0
    finally:
        pflags.set_flags({k.replace("FLAGS_", ""): v
                          for k, v in prev.items()})
        paddle.set_flags({k.replace("FLAGS_", ""): v
                          for k, v in jprev.items()})
    off = _port(cfg, p, **ENGINE_KW)
    assert off.speculative == "off" and off.spec_k == 0
    assert ours == _serve(off, prompts)


def test_speculative_env_aliases_build_a_speculating_engine(model,
                                                            monkeypatch):
    """PADDLE_TPU_SPECULATIVE / PADDLE_TPU_SPEC_K / PADDLE_TPU_SPEC_ADAPTIVE,
    read when the registry is made (here: the flags module reloaded under
    the environment, then again without it)."""
    _, _, _, cfg, p = model
    for name, value in (("PADDLE_TPU_SPECULATIVE", "ngram"),
                        ("PADDLE_TPU_SPEC_K", "2"),
                        ("PADDLE_TPU_SPEC_ADAPTIVE", "on")):
        monkeypatch.delenv("FLAGS_" + name[len("PADDLE_TPU_"):].lower(),
                           raising=False)
        monkeypatch.setenv(name, value)
    importlib.reload(pflags)
    try:
        eng = _port(cfg, p, **ENGINE_KW)
        assert (eng.speculative, eng.spec_k, eng.spec_adaptive) \
            == ("ngram", 2, True)
        assert sorted(eng.compile_stats()) == ["decode", "verify"]
    finally:
        monkeypatch.undo()
        importlib.reload(pflags)
    assert pflags.flag("speculative") == "off"


def test_module_smoke_on_the_cpu(capsys):
    """The smoke of `python -m paddle_tpu_torch.serving.speculative
    --device cpu`: exit code 0, one JSON row with token_match 1.0 and
    accepted drafts."""
    assert pspec._smoke(["--device", "cpu", "--requests", "4",
                         "--max-new", "8"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["bench"] == "speculative_smoke" and row["ok"]
    assert row["token_match"] == 1.0 and row["spec_accepted"] > 0
    # on the CPU the smoke serves the split path: one cold prefill
    # program per warmed (bucket, batch), none captured by traffic
    stats = row["compile_stats"]
    assert {k: n for k, n in stats.items() if not k.startswith("prefill:")} \
        == {"decode": 1, "verify": 1}
    prefill = [k for k in stats if k.startswith("prefill:")]
    assert prefill and all(k.startswith("prefill:cold:") and stats[k] == 1
                           for k in prefill)
