"""The port's contiguous-cache decode and its quant-only generation
program against the JAX package, on the CPU.

Kernel functions: the same numpy inputs go through the JAX
``decode_attention`` / ``gqa_decode_attention`` (Pallas in interpret mode:
``_decode_kernel`` at head_dim 128, ``_gqa_contig_kernel`` otherwise) and
the port's (its plain version on CPU tensors), for GQA groups 1, 2 and 4
and MQA, lens 0, mid-cache and max_seq - 1, max_seq 96 and 1024. f32:
the same math in another summation order, within 1e-5.

The contiguous decode step (``_make_decode_step`` with its default cache
callbacks) against the JAX step, including a position at and past the
cache end, where JAX's dynamic_update_slice clamps the write to max_seq - 1
and torch would raise: logits within 1e-4 (f32, two layers), caches
within 1e-5.

``build_quant_generate`` on ``tiny()`` in f32 over the JAX
``init_quant_serving_params`` weights carried across (int8 and int4),
with a prompt shorter than its bucket, with and without an EOS: greedy
tokens identical to the JAX program's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.decode_attention import (decode_attention,
                                                       gqa_decode_attention)
from paddle_tpu_torch.models import (LlamaConfig, build_quant_generate,
                                     init_quant_serving_params,
                                     params_from_jax)
from paddle_tpu_torch.models import llama as pl

QUANTS = ["weight_only_int8", "weight_only_int4"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("max_seq", [96, 1024])
@pytest.mark.parametrize("hq,hkv,dh", [(4, 4, 16), (4, 4, 128), (4, 2, 16),
                                       (8, 2, 16), (4, 1, 16)],
                         ids=["group1", "group1-equal-heads-kernel",
                              "group2", "group4", "mqa"])
def test_contiguous_decode_matches_jax(hq, hkv, dh, max_seq):
    rng = np.random.default_rng(hq + hkv + dh + max_seq)
    b = 3
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, hkv, max_seq, dh)).astype(np.float32)
              for _ in range(2))
    lens = np.asarray([0, max_seq // 2 + 3, max_seq - 1], np.int32)
    jfn = jda.decode_attention if hq == hkv else jda.gqa_decode_attention
    want = _np(jfn(*(jnp.asarray(a) for a in (q, kc, vc, lens))))
    tfn = decode_attention if hq == hkv else gqa_decode_attention
    args = [torch.from_numpy(a) for a in (q, kc, vc, lens)]
    _build.reset_launch_counts()
    got = tfn(*args)
    assert got.shape == (b, hq, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # one kernel serves both wrappers: the GQA one takes group 1 too
    torch.testing.assert_close(gqa_decode_attention(*args), got, atol=0,
                               rtol=0)
    assert not any(_build.launch_counts().values())


def test_contiguous_decode_argument_checks():
    q = torch.randn(2, 4, 16)
    kc = torch.randn(2, 2, 32, 16)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="equal heads"):
        decode_attention(q, kc, kc, lens)
    with pytest.raises(ValueError, match="caches must be"):
        gqa_decode_attention(q, kc[:, :, :, :8], kc, lens)
    with pytest.raises(ValueError, match="multiple"):
        gqa_decode_attention(torch.randn(2, 3, 16), kc, kc, lens)


# ---------------------------------------------------------------------------
# the contiguous decode step
# ---------------------------------------------------------------------------

def _setup(nkv=2, seed=21):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=nkv)
    paddle.seed(seed)
    raw = dict(JaxModel(jcfg).raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=nkv)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, raw, cfg, p


@pytest.mark.parametrize("nkv", [2, 4], ids=["gqa", "equal-heads"])
@pytest.mark.parametrize("where", ["mid", "last", "at-end", "past-end"])
def test_contiguous_decode_step_matches_jax(nkv, where):
    """One decode step over [b, nkv, max_seq, dh] caches at a scalar
    position; at and past the end the write lands at max_seq - 1 (the JAX
    clamp), which the step then attends."""
    jcfg, raw, cfg, p = _setup(nkv)
    rng = np.random.default_rng(nkv)
    b, max_seq, dh = 2, 24, cfg.head_dim
    pos = {"mid": 7, "last": max_seq - 1, "at-end": max_seq,
           "past-end": max_seq + 3}[where]
    n = cfg.num_hidden_layers
    caches = [rng.standard_normal((b, nkv, max_seq, dh)).astype(np.float32)
              for _ in range(2 * n)]
    tok = rng.integers(1, cfg.vocab_size, (b, 1))
    jstep = jl._make_decode_step(jcfg, b, max_seq)
    jlog, jk, jv = jstep(raw, [jnp.asarray(c) for c in caches[:n]],
                         [jnp.asarray(c) for c in caches[n:]],
                         jnp.asarray(tok, jnp.int32),
                         jnp.asarray(pos, jnp.int32))
    tk = [torch.from_numpy(c.copy()) for c in caches[:n]]
    tv = [torch.from_numpy(c.copy()) for c in caches[n:]]
    tstep = pl._make_decode_step(cfg, b, max_seq)
    tlog, tk, tv = tstep(p, tk, tv, torch.from_numpy(tok), pos)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=1e-4, rtol=0)
    written = min(pos, max_seq - 1)
    for t, j, c in zip(tk + tv, list(jk) + list(jv), caches):
        np.testing.assert_allclose(t.numpy(), _np(j), atol=1e-5, rtol=0)
        assert not np.array_equal(t.numpy()[:, :, written], c[:, :, written])
        keep = np.arange(max_seq) != written
        np.testing.assert_array_equal(t.numpy()[:, :, keep], c[:, :, keep])


# ---------------------------------------------------------------------------
# init_quant_serving_params and build_quant_generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,kdiv", [("weight_only_int8", 1),
                                        ("weight_only_int4", 2)])
def test_init_quant_serving_params_layout(quant, kdiv):
    """Every projection and the lm_head is a pair ([N, K // kdiv] int8,
    [N] f32) and nothing else is quantized; the same seed gives the same
    weights; without CUDA, device=None raises."""
    cfg = LlamaConfig.tiny()
    p = init_quant_serving_params(cfg, quant, seed=3, device="cpu",
                                  dtype=torch.float32)
    shapes = pl.param_shapes(cfg)
    assert set(p) == set(shapes)
    for name, shape in shapes.items():
        w = p[name]
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            k, n = shape
            assert isinstance(w, tuple)
            assert w[0].dtype == torch.int8 and w[0].shape == (n, k // kdiv)
            assert w[1].dtype == torch.float32 and w[1].shape == (n,)
        else:
            assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
            assert tuple(w.shape) == shape
    again = init_quant_serving_params(cfg, quant, seed=3, device="cpu",
                                      dtype=torch.float32)
    assert torch.equal(p["lm_head.weight"][0], again["lm_head.weight"][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_quant_serving_params(cfg, quant)


def _jax_generate(jcfg, jp, ids, s0, max_new, eos):
    fn = jax.jit(jl.build_quant_generate(jcfg, b=ids.shape[0],
                                         sb=ids.shape[1], max_new=max_new,
                                         eos_token_id=eos))
    return np.asarray(fn(jp, jnp.asarray(ids, jnp.int32),
                         jnp.asarray(s0, jnp.int32), jax.random.PRNGKey(0),
                         jnp.asarray(1.0, jnp.float32),
                         jnp.asarray(1.0, jnp.float32)))


@pytest.mark.parametrize("quant", QUANTS)
def test_build_quant_generate_matches_jax(quant):
    jcfg = JaxConfig.tiny()
    jp = jl.init_quant_serving_params(jcfg, quant, seed=3,
                                      dtype=jnp.float32)
    cfg = LlamaConfig.tiny()
    p = params_from_jax({k: tuple(np.asarray(a) for a in v)
                         if isinstance(v, tuple) else np.asarray(v)
                         for k, v in jp.items()}, device="cpu")
    ids = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 16))
    s0, max_new = 9, 6
    ids[:, s0:] = 0                           # the bucket's pad tail
    want = _jax_generate(jcfg, jp, ids, s0, max_new, None)
    run = build_quant_generate(cfg, b=2, sb=16, max_new=max_new)
    got = run(p, torch.from_numpy(ids), s0)
    assert got.shape == (2, max_new) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)

    # with an EOS the first row emits: that row freezes on it
    eos = int(want[0, 2])
    want_e = _jax_generate(jcfg, jp, ids, s0, max_new, eos)
    run_e = build_quant_generate(cfg, b=2, sb=16, max_new=max_new,
                                 eos_token_id=eos)
    got_e = run_e(p, torch.from_numpy(ids), s0,
                  generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    first = list(got_e[0]).index(eos)
    assert (got_e[0, first:] == eos).all()
