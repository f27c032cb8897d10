"""The split path's prefill programs (one per JAX program key, captured by
``warm(buckets=, prefix_widths=)`` or at first use) against the JAX
engine, on the CPU, in f32 on ``LlamaConfig.tiny()``.

Engines: each case warms the JAX engine and the port's engine with the
same buckets and prefix widths, then serves the same traffic (three
prompts sharing a two-page head, so the later two prefill only their
suffixes over the cached pages, and cold prompts of three buckets), with
``unified_step`` pinned. Tokens must match up to the near-tie rule of
tests/test_torch_engine.py (a divergence only where the JAX model's top-2
logit margin is below 1e-4), the scheduling counters must be equal, the
set of ``prefill:`` keys in ``compile_stats()`` must be JAX's, and
neither engine's stats may grow under the warmed traffic. Cases: cold
and prefix cache, batches of 1 and 2, int8 pools, int4 weights, each
megakernel rung (their plain versions here), double-buffered.

Plumbing: warm()'s two ValueErrors are JAX's; the unified path ignores
the buckets; a key reached unwarmed is captured at its admission; a
capture mid-traffic runs over scratch rows (only the scratch page
changes, the sampling generator does not move); and an engine whose
programs replay fake graphs (the card's graph path: static outputs,
launch deltas) gives the eager engine's tokens and launch counts, the
paged prefill kernel launched once a layer per prefix batch.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.framework import cuda_graph
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models import llama as pl
from paddle_tpu_torch.serving import ContinuousBatchingEngine

NEAR_TIE = 1e-4
KW = dict(slots=2, prompt_bucket=8, max_prompt_len=24, max_new_tokens=5,
          block_size=8, steps_per_sync=3, unified_step=False)
BUCKETS, WIDTHS = [8, 16, 24], [2]
COUNTERS = ("prefill_calls", "device_steps", "prompt_tokens",
            "prefix_hit_tokens", "prefix_inserts")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=2)
    paddle.seed(21)
    raw = dict(JaxModel(jcfg).raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, raw, cfg, p


def _np_pairs(dec):
    return {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v) for k, v in dec.items()}


def _port(cfg, p, **kw):
    return ContinuousBatchingEngine(cfg, p, device="cpu",
                                    dtype=torch.float32, **{**KW, **kw})


def _prompts(vocab):
    """Three rows sharing a 16-token head, the first two apart (the later
    ones, admitted after the first commits, hit two cached pages and
    prefill suffixes of bucket 8 at prefix width 2), and cold rows of
    buckets 8, 16 and 24."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, vocab, (16,)).tolist()

    def toks(n):
        return rng.integers(1, vocab, (n,)).tolist()

    return ([shared + toks(3), toks(2)] + [shared + toks(n) for n in (6, 4)]
            + [toks(n) for n in (9, 14, 20, 5)])


def _serve(eng, prompts):
    reqs = [eng.add_request(pr, max_new=2 + i % 4)
            for i, pr in enumerate(prompts)]
    eng.run(max_iters=500)
    assert all(r.done for r in reqs)
    assert eng.mgr.n_available == eng.mgr.max_pages - 1
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


def _prefill_keys(stats):
    return {k for k in stats if k.startswith("prefill:")}


# (name, weights, engine kwargs)
CASES = [
    ("prefix-batch2", "dense", dict(prefill_batch=2)),
    ("cold-int8-pools", "dense", dict(prefix_cache=False,
                                      kv_cache_dtype="int8",
                                      prefill_batch=1)),
    ("attn-double-buffered", "dense", dict(decode_megakernel="attn",
                                           double_buffer=True,
                                           prefill_batch=1)),
    ("full-int8-pools", "dense",
     dict(decode_megakernel="full", kv_cache_dtype="int8",
          prefill_batch=1)),
    ("int4-weights", "weight_only_int4", dict(prefill_batch=1)),
    ("scan", "dense", dict(decode_megakernel="scan", prefill_batch=1)),
]


@pytest.mark.parametrize("weights,kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_warmed_engines_match_jax(model, weights, kw):
    jcfg, raw, cfg, _ = model
    jdec = raw if weights == "dense" \
        else JaxModel(jcfg)._decode_params(raw, weights)
    p = params_from_jax(_np_pairs(jdec), device="cpu")
    prompts = _prompts(cfg.vocab_size)
    jkw = {**KW, **kw}
    jeng = JaxEngine(jcfg, jdec, dtype=jnp.float32, **jkw)
    jeng.warm(buckets=BUCKETS, prefix_widths=WIDTHS)
    jstats = jeng.compile_stats()
    theirs = _serve(jeng, prompts)
    eng = _port(cfg, p, **kw)
    eng.warm(buckets=BUCKETS, prefix_widths=WIDTHS)
    stats = eng.compile_stats()
    assert _prefill_keys(stats) == _prefill_keys(jstats)
    n_batch = 2 if kw["prefill_batch"] == 2 else 1
    n_kinds = 1 + (len(WIDTHS) if eng.prefix_cache else 0)
    assert len(_prefill_keys(stats)) == len(BUCKETS) * n_batch * n_kinds
    assert all(n == 1 for n in stats.values())
    ours = _serve(eng, prompts)
    _assert_same_up_to_ties(jcfg, jdec, prompts, ours, theirs)
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    if eng.prefix_cache:
        assert eng.prefix_hit_tokens > 0
    # warmed traffic captures nothing, in either package
    assert eng.compile_stats() == stats
    assert jeng.compile_stats() == jstats
    assert eng.metrics()["compile_stats"] == stats


def test_warm_errors_match_jax(model):
    jcfg, raw, cfg, p = model
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, **KW)
    eng = _port(cfg, p)
    assert eng._prefix_width_ladder() == jeng._prefix_width_ladder() == [1, 2]
    assert eng._max_prefill_bsz() == jeng._max_prefill_bsz() == 2
    for e in (jeng, eng):
        with pytest.raises(ValueError, match=r"prefix widths \[3\] are not "
                                             r"on the ladder \[1, 2\]"):
            e.warm(buckets=[8], prefix_widths=[3])
        with pytest.raises(ValueError, match="bucket 12 is not a multiple "
                                             "of prompt_bucket 8"):
            e.warm(buckets=[12])
    assert not _prefill_keys(eng.compile_stats())


def test_unified_path_ignores_buckets(model):
    jcfg, raw, cfg, p = model
    kw = {**KW, "unified_step": True}
    eng = ContinuousBatchingEngine(cfg, p, device="cpu", dtype=torch.float32,
                                   **kw)
    eng.warm(buckets=[8, 16], prefix_widths=[99])   # neither is checked
    assert eng.compile_stats() == {"decode": 1, "unified": 1}
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, **kw)
    assert not _prefill_keys(jeng.compile_stats())


def test_unwarmed_key_is_captured_at_its_admission(model):
    """Traffic beyond the warmed buckets captures its program when it is
    first admitted (JAX compiles at first use), once."""
    _, _, cfg, p = model
    eng = _port(cfg, p, prefix_cache=False)
    eng.warm(buckets=[8])
    before = eng.compile_stats()
    rng = np.random.default_rng(3)
    _serve(eng, [rng.integers(1, cfg.vocab_size, (n,)).tolist()
                 for n in (12, 3, 13)])
    new = _prefill_keys(eng.compile_stats()) - _prefill_keys(before)
    key = "prefill:" + ":".join(map(str, eng._prefill_key("cold", 16, 1)))
    assert key in new
    assert all(eng.compile_stats()[k] == 1 for k in new)


def _pool_rows(eng, keep_scratch: bool):
    out = []
    for pool in eng.kcs + eng.vcs:
        for t in (pool if isinstance(pool, tuple) else (pool,)):
            rows = torch.arange(t.shape[0]) % eng.mgr.max_pages \
                != eng.scratch_page
            out.append(t.clone() if keep_scratch else t[rows].clone())
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_capture_mid_traffic_touches_only_the_scratch_page(model, kv):
    """A program captured while requests hold pages runs its warm-up over
    scratch rows: every page but the scratch page keeps its bytes, and a
    sampling engine's generator does not move."""
    _, _, cfg, p = model
    eng = _port(cfg, p, do_sample=True, top_k=3, kv_cache_dtype=kv)
    rng = np.random.default_rng(4)
    for n in (20, 9):
        eng.add_request(rng.integers(1, cfg.vocab_size, (n,)).tolist())
    eng.step()
    assert eng.n_active == 2
    pages, state = _pool_rows(eng, False), eng._gen.get_state()
    n = len(eng._prefill_cache)
    eng._get_prefix_prefill(16, 2, 2)
    eng._get_prefill(24, 2)
    assert len(eng._prefill_cache) == n + 2
    for a, b in zip(pages, _pool_rows(eng, False)):
        assert torch.equal(a, b)
    assert torch.equal(state, eng._gen.get_state())
    eng.run(max_iters=100)
    assert all(len(r.tokens) == 5 for r in eng.finished)


class _FakeGraph:
    """Stands in for a CUDA graph: a replay runs the body with the launch
    counters put back (a replay calls no wrapper) and writes the results
    into the recorded outputs in place."""

    def __init__(self, prog, outputs):
        self.prog, self.outputs = prog, outputs

    def replay(self):
        counts = _build.launch_counts()
        for dst, src in zip(self.outputs, self.prog.body(*self.prog.inputs)):
            dst.copy_(src)
        _build.LAUNCHES.update(counts)


def _fake_capture(monkeypatch):
    def warm_up(self, stream):
        self.body(*self.inputs)

    def record(self, pool, stream):
        outputs = self.body(*self.inputs)
        return _FakeGraph(self, outputs), outputs

    monkeypatch.setattr(cuda_graph._Program, "_warm_up", warm_up)
    monkeypatch.setattr(cuda_graph._Program, "_record", record)


def _counting(monkeypatch):
    """Count the CPU calls of the prefill attention wrappers the way the
    card counts launches."""
    def wrap(fn, name):
        def counted(*a, **k):
            _build.LAUNCHES[name] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(pl, "flash_attention",
                        wrap(pl.flash_attention, "flash_attention_fwd"))
    monkeypatch.setattr(pl, "prefix_prefill_attention",
                        wrap(pl.prefix_prefill_attention,
                             "prefix_prefill_attention"))


def test_fake_graph_prefill_equals_eager(model, monkeypatch):
    """The graph path on the CPU: every program, prefill ones included,
    'replays' a fake graph over its static inputs and outputs. Tokens and
    launch counts equal the eager engine's; each cold batch launches the
    flash forward and each prefix batch the paged prefill kernel once a
    layer, all from the captured deltas."""
    _, _, cfg, p = model
    _counting(monkeypatch)
    _fake_capture(monkeypatch)
    prompts = _prompts(cfg.vocab_size)
    runs = {}
    for graphed in (True, False):
        eng = _port(cfg, p, prefill_batch=2)
        if graphed:
            for site in (eng._site, eng._prefill_site, eng._draft_site):
                site.graphed = True
        eng.warm(buckets=BUCKETS, prefix_widths=WIDTHS)
        stats = eng.compile_stats()
        _build.reset_launch_counts()
        toks = _serve(eng, prompts)
        runs[graphed] = (toks, _build.launch_counts(), eng)
        assert eng.compile_stats() == stats
    (g_toks, g_n, g), (e_toks, e_n, e) = runs[True], runs[False]
    assert all(isinstance(prog.graph, _FakeGraph)
               for prog in g._prefill_cache.values())
    assert all(prog.graph is None for prog in e._prefill_cache.values())
    assert g_toks == e_toks
    assert g_n == e_n
    L = cfg.num_hidden_layers
    cold = g.prefill_calls - g_n["prefix_prefill_attention"] // L
    assert g_n["prefix_prefill_attention"] > 0
    assert g_n["prefix_prefill_attention"] % L == 0
    assert g_n["flash_attention_fwd"] == L * cold > 0
    _build.reset_launch_counts()
