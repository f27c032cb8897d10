"""The port's generation entry points against the JAX package, on the CPU,
in f32 on ``LlamaConfig.tiny()`` (two layers, GQA 4:2).

- ``LlamaForCausalLM.forward(caches=)``: the prompt's forward over
  ``[(None, None)] * L`` and one decode step over the caches it returned
  give logits and caches within 1e-5 of the JAX model's (the same f32
  math in another summation order).
- ``jit_generate`` (each signature one `GenerateProgram`: its eager body
  here) is token-identical to the JAX ``jit_generate`` on greedy streams:
  contiguous caches, weight-only int8 / int4 decode, ``prefill_with_quant``
  (``build_quant_generate``), paged pools over f32 and int8 pools (the
  FLAGS_kv_cache_dtype of both packages), each FLAGS_decode_megakernel
  rung (scan steps down to full with a warning, as in JAX), a ragged
  ``seq_lens`` batch, an ``eos_token_id`` trim and another
  ``bucket_size``.
- ``generate`` (eager, concat caches) is token-identical to the JAX
  ``generate``, with and without an EOS that every row reaches.
- The validation errors are JAX's; the program cache keeps one entry per
  signature and a second call captures nothing; a reload never writes the
  caller's old dict and the next call reads the new weights; a weight
  updated in place reaches the kept programs; every signature shares the
  model's one graph site and one quantized set per quant mode.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     params_from_jax)

B, S0, MAX_NEW = 2, 11, 6


def _pair(seed):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=2)
    paddle.seed(seed)
    jm = JaxModel(jcfg)
    raw = {k: np.asarray(v) for k, v in jm.raw_state().items()}
    m = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2))
    return jm, m.load_jax_params(raw, device="cpu"), raw


@pytest.fixture(scope="module")
def models():
    return _pair(21)


def _ids(vocab, b=B, s=S0, seed=1):
    return np.random.default_rng(seed).integers(1, vocab, (b, s))


def _both(jm, m, ids, **kw):
    want = np.asarray(jm.jit_generate(paddle.to_tensor(ids), **kw).numpy())
    got = m.jit_generate(torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int64
    return want, got.numpy()


class _Flags:
    """Set a serving flag in both packages for one block."""

    def __init__(self, **flags):
        self.flags = flags

    def __enter__(self):
        from paddle_tpu.framework.flags import get_flags

        self.old = {k: get_flags(k)[f"FLAGS_{k}"] for k in self.flags}
        paddle.set_flags(self.flags)
        set_flags(self.flags)

    def __exit__(self, *exc):
        paddle.set_flags(self.old)
        set_flags(self.old)


# ---------------------------------------------------------------------------
# the concat-cache forward
# ---------------------------------------------------------------------------

def test_forward_with_caches_matches_jax(models):
    jm, m, _ = models
    L = m.config.num_hidden_layers
    ids = _ids(m.config.vocab_size)
    jlog, jc = jm(paddle.to_tensor(ids), caches=[(None, None)] * L)
    with torch.no_grad():
        log, c = m(torch.from_numpy(ids), caches=[(None, None)] * L)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog.numpy()),
                               atol=1e-5, rtol=0)
    for (k, v), (jk, jv) in zip(c, jc):
        assert k.shape == (B, S0, 2, m.config.head_dim)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk.numpy()),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv.numpy()),
                                   atol=1e-5, rtol=0)
    # one decode step: Sq 1 against S0 + 1 keys, not causal
    tok = np.asarray(log.numpy()[:, -1].argmax(-1))[:, None]
    jlog2, jc2 = jm(paddle.to_tensor(tok), caches=jc, position_offset=S0)
    with torch.no_grad():
        log2, c2 = m(torch.from_numpy(tok), caches=c, position_offset=S0)
    np.testing.assert_allclose(log2.numpy(), np.asarray(jlog2.numpy()),
                               atol=1e-5, rtol=0)
    for (k, v), (jk, jv) in zip(c2, jc2):
        assert k.shape[1] == S0 + 1
        np.testing.assert_allclose(k.numpy(), np.asarray(jk.numpy()),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv.numpy()),
                                   atol=1e-5, rtol=0)
    # without caches the forward is the plain causal one it always was
    with torch.no_grad():
        torch.testing.assert_close(m(torch.from_numpy(ids)), log, atol=0,
                                   rtol=0)


# ---------------------------------------------------------------------------
# jit_generate
# ---------------------------------------------------------------------------

# (kwargs, flags): every layout and quant mode
GEN_CASES = [
    ("contiguous", dict(), {}),
    ("int8", dict(quant="weight_only_int8"), {}),
    ("int4", dict(quant="weight_only_int4"), {}),
    ("int4-prefill-quant", dict(quant="weight_only_int4",
                                prefill_with_quant=True), {}),
    ("int8-prefill-quant-bucket32", dict(quant="weight_only_int8",
                                         prefill_with_quant=True,
                                         bucket_size=32), {}),
    ("paged", dict(cache_layout="paged", kv_block_size=8), {}),
    ("paged-int8-pools-ragged",
     dict(cache_layout="paged", kv_block_size=8, seq_lens=[S0, 5]),
     dict(kv_cache_dtype="int8")),
    ("paged-int4-weights", dict(cache_layout="paged", kv_block_size=8,
                                quant="weight_only_int4"), {}),
    ("paged-attn", dict(cache_layout="paged", kv_block_size=8),
     dict(decode_megakernel="attn")),
    ("paged-full-int8-weights-int8-pools",
     dict(cache_layout="paged", kv_block_size=8, quant="weight_only_int8"),
     dict(decode_megakernel="full", kv_cache_dtype="int8")),
    ("paged-scan-ragged", dict(cache_layout="paged", kv_block_size=8,
                               seq_lens=[3, S0]),
     dict(decode_megakernel="scan")),
]


@pytest.mark.parametrize("kw,flags", [c[1:] for c in GEN_CASES],
                         ids=[c[0] for c in GEN_CASES])
def test_jit_generate_matches_jax(models, kw, flags):
    jm, m, _ = models
    ids = _ids(m.config.vocab_size)
    kw = {"max_new_tokens": MAX_NEW, "bucket_size": 16, **kw}
    with _Flags(**flags), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        want, got = _both(jm, m, ids, **kw)
    assert got.shape == (B, S0 + MAX_NEW)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :S0], ids)
    if flags.get("decode_megakernel") == "scan":
        # both packages step scan down to full, each with its warning
        assert sum("serving the 'full' rung" in str(x.message)
                   for x in w) == 2


def test_jit_generate_eos_trim_matches_jax(models):
    """An EOS every row reaches: both trim after the last row's first
    EOS, and a row that emitted it keeps emitting it."""
    jm, m, _ = models
    # the first prompt seed whose two greedy rows share a token: that
    # token is the EOS (row 0 makes it at its earliest)
    for seed in range(2, 40):
        ids = _ids(m.config.vocab_size, seed=seed)
        full = m.jit_generate(torch.from_numpy(ids), max_new_tokens=MAX_NEW,
                              bucket_size=16).numpy()[:, S0:]
        common = [t for t in full[0] if t in full[1]]
        if common:
            break
    eos = int(common[0])
    want, got = _both(jm, m, ids, max_new_tokens=MAX_NEW, bucket_size=16,
                      eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    new = got[:, S0:]
    assert got.shape[1] < S0 + MAX_NEW and (new == eos).any(axis=1).all()
    first = list(new[0]).index(eos)
    assert (new[0, first:] == eos).all()


def test_jit_generate_validation_errors_match_jax(models):
    jm, m, _ = models
    ids = _ids(m.config.vocab_size)
    cases = [
        (dict(prefill_with_quant=True), "prefill_with_quant=True requires"),
        (dict(cache_layout="ring"), "cache_layout must be"),
        (dict(seq_lens=[S0, S0]), "requires cache_layout='paged'"),
        (dict(quant="int3"), "quant must be None"),
        (dict(cache_layout="paged", kv_block_size=8, seq_lens=[S0]),
         "seq_lens has 1 entries"),
        (dict(cache_layout="paged", kv_block_size=8, seq_lens=[0, S0]),
         r"seq_lens must lie in \[1, 11\]"),
        (dict(cache_layout="paged", kv_block_size=8, seq_lens=[S0 + 1, 2]),
         r"seq_lens must lie in \[1, 11\]"),
    ]
    for kw, msg in cases:
        for model, arr in ((jm, paddle.to_tensor(ids)),
                           (m, torch.from_numpy(ids))):
            with pytest.raises(ValueError, match=msg):
                model.jit_generate(arr, max_new_tokens=3, bucket_size=16,
                                   **kw)
    # max_new_tokens <= 0 returns the prompt
    np.testing.assert_array_equal(
        m.jit_generate(torch.from_numpy(ids), max_new_tokens=0).numpy(), ids)


def test_one_program_per_signature(models):
    """A signature's program is made and captured once; a second call
    reuses it (captures nothing), another max_new_tokens makes another."""
    _, m, _ = models
    m.__dict__.pop("_gen_params", None)     # a fresh program cache
    ids = torch.from_numpy(_ids(m.config.vocab_size))
    a = m.jit_generate(ids, max_new_tokens=4, bucket_size=16)
    b = m.jit_generate(ids, max_new_tokens=4, bucket_size=16)
    assert torch.equal(a, b)
    cache = m._jit_gen_cache
    (sig, prog), = cache.items()
    assert sig == (B, 16, 4, None, False, 0, None, False, "contiguous", 64,
                   None, None, None, None)
    assert prog.captures == 1 and not prog.site.graphed   # eager here
    m.jit_generate(ids, max_new_tokens=5, bucket_size=16)
    m.jit_generate(ids, max_new_tokens=5, bucket_size=16)
    assert len(cache) == 2
    assert all(p.captures == 1 for p in cache.values())


RELOAD_MODES = (dict(), dict(quant="weight_only_int8"),
                dict(quant="weight_only_int4", prefill_with_quant=True),
                dict(cache_layout="paged", kv_block_size=8))


def _gen_all(m, ids):
    return [m.jit_generate(ids, max_new_tokens=4, bucket_size=16, **kw)
            for kw in RELOAD_MODES]


def test_reload_leaves_the_callers_dicts_alone():
    """load_params(A), generate, load_params(B) (no copies), generate:
    the programs never write a caller's tensor, so A keeps its values, the
    second round gives B's tokens (what a model over B alone gives), and
    loading A again gives A's own tokens. A reload drops the programs
    kept for the old weights (the cache holds the new round's only)."""
    raw_a, raw_b = _pair(21)[2], _pair(5)[2]
    a = params_from_jax(raw_a, device="cpu")
    b = params_from_jax(raw_b, device="cpu")
    a_before = {k: v.clone() for k, v in a.items()}
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    m = LlamaForCausalLM(cfg).load_params(a)
    ids = torch.from_numpy(_ids(cfg.vocab_size, seed=4))
    toks_a = _gen_all(m, ids)
    m.load_params(b)
    toks_b = _gen_all(m, ids)
    assert all(torch.equal(a[k], v) for k, v in a_before.items())
    fresh_b = LlamaForCausalLM(cfg).load_params(
        params_from_jax(raw_b, device="cpu"))
    for got, want in zip(toks_b, _gen_all(fresh_b, ids)):
        assert torch.equal(got, want)
    assert len(m._jit_gen_cache) == len(RELOAD_MODES)
    assert all(p.captures == 1 for p in m._jit_gen_cache.values())
    m.load_params(a)
    for got, want in zip(_gen_all(m, ids), toks_a):
        assert torch.equal(got, want)
    assert all(torch.equal(b[k], v) for k, v in
               params_from_jax(raw_b, device="cpu").items())


def test_in_place_update_reaches_kept_programs():
    """A weight updated in place keeps its memory: the kept programs read
    it (the quantized sets re-quantize from it every call) without a new
    capture, and give what a fresh model over the new values gives."""
    _, m, raw = _pair(21)
    cfg = m.config
    ids = torch.from_numpy(_ids(cfg.vocab_size, seed=4))
    _gen_all(m, ids)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("q_proj.weight") or name == "lm_head.weight":
                p.mul_(-1.5)
    got = _gen_all(m, ids)
    assert all(p.captures == 1 for p in m._jit_gen_cache.values())
    fresh = LlamaForCausalLM(cfg).load_params(
        {k: v.detach().clone() for k, v in m.named_parameters()})
    for g, want in zip(got, _gen_all(fresh, ids)):
        assert torch.equal(g, want)


def test_signatures_share_one_site_and_quant_set():
    """Every signature's program captures through the model's one graph
    site, and all the programs of one quant mode read one quantized set
    (the model's own): two int8 signatures hold the same pair tensors."""
    _, m, _ = _pair(21)
    ids = torch.from_numpy(_ids(m.config.vocab_size, seed=4))
    kws = (dict(quant="weight_only_int8"),
           dict(quant="weight_only_int8", max_new_tokens=5),
           dict(quant="weight_only_int8", cache_layout="paged",
                kv_block_size=8))
    for kw in kws:
        m.jit_generate(ids, **{"max_new_tokens": 4, "bucket_size": 16, **kw})
    progs = list(m._jit_gen_cache.values())
    assert len(progs) == len(kws) == m._gen_site.captures
    assert all(p.site is m._gen_site for p in progs)
    assert all(p._weights[-1] is progs[0]._weights[-1] for p in progs)
    assert list(m._gen_quant) == ["weight_only_int8"]
    name = "llama.layers.0.self_attn.q_proj.weight"
    assert progs[0]._weights[-1][name] is m._gen_quant["weight_only_int8"][
        name]


def test_sampling_top_k_one_is_greedy_and_seeded(models):
    _, m, _ = models
    ids = torch.from_numpy(_ids(m.config.vocab_size))
    greedy = m.jit_generate(ids, max_new_tokens=5, bucket_size=16)
    top1 = m.jit_generate(ids, max_new_tokens=5, bucket_size=16,
                          do_sample=True, top_k=1, temperature=0.7, seed=3)
    assert torch.equal(top1, greedy)
    a, b, c = (m.jit_generate(ids, max_new_tokens=5, bucket_size=16,
                              do_sample=True, temperature=1.0, seed=s)
               for s in (9, 9, 10))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < m.config.vocab_size


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

def test_generate_matches_jax(models):
    jm, m, _ = models
    ids = _ids(m.config.vocab_size)
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=5).numpy())
    got = m.generate(torch.from_numpy(ids), max_new_tokens=5).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (B, S0 + 5)
    # the jitted program's greedy stream too
    np.testing.assert_array_equal(
        got, m.jit_generate(torch.from_numpy(ids), max_new_tokens=5,
                            bucket_size=16).numpy())
    # an EOS both rows emit at once: generation stops there
    one = ids[:1].repeat(2, axis=0)
    full = m.generate(torch.from_numpy(one), max_new_tokens=5).numpy()
    eos = int(full[0, S0 + 1])
    want = np.asarray(jm.generate(paddle.to_tensor(one), max_new_tokens=5,
                                  eos_token_id=eos).numpy())
    got = m.generate(torch.from_numpy(one), max_new_tokens=5,
                     eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == S0 + 2


def test_generation_needs_weights():
    m = LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="no weights yet"):
        m.jit_generate(torch.ones(1, 3, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="no weights yet"):
        m.generate(torch.ones(1, 3, dtype=torch.int64))
