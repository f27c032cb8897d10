"""The port's paged prefix-prefill attention and the cached-prefix suffix
prefill against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through the JAX function -- its
Pallas kernel in interpret mode, as tests/test_prefix_prefill.py runs it
-- and through the port's function on CPU tensors, which runs the plain
version. The cases mirror tests/test_prefix_prefill.py: ragged GQA with
pad rows and an empty prefix, group 1, MQA, a one-token suffix over a
single page, bf16. Tolerances: f32 within 1e-5 (same f32 math, another
summation order); bf16 within 2e-2 (both compute in f32 from the same bf16
inputs and round the output once). Pad rows must be exact zeros on both
sides.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import prefix_prefill as jpp
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.prefix_prefill import (
    prefix_prefill_attention, prefix_prefill_reference)
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models import llama as pl

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, sb, nh, nkv, dh, bs, w, seed):
    rng = np.random.default_rng(seed)
    npages = b * w + 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    arrays = [f(b, sb, nh, dh), f(b, sb, nkv, dh), f(b, sb, nkv, dh),
              f(npages, nkv, bs, dh), f(npages, nkv, bs, dh)]
    # scattered page placement, page 0 left as the pad filler
    tables = (rng.permutation(npages - 1)[:b * w].reshape(b, w) + 1
              ).astype(np.int32)
    return arrays, tables


@pytest.mark.parametrize("b,sb,nh,nkv,dh,bs,w,blocks,slens,dtype", [
    (3, 16, 4, 2, 16, 8, 3, (3, 1, 0), (16, 9, 5), "float32"),
    (2, 16, 4, 4, 16, 8, 2, (2, 0), (16, 3), "float32"),
    (2, 16, 4, 1, 16, 8, 2, (1, 2), (8, 16), "float32"),
    (2, 8, 4, 2, 16, 8, 1, (1, 0), (8, 1), "float32"),
    (2, 16, 8, 2, 32, 8, 2, (2, 1), (16, 11), "bfloat16"),
], ids=["ragged-gqa-pad-empty", "group1", "mqa", "one-token-suffix",
        "bf16"])
def test_prefix_prefill_matches_jax(b, sb, nh, nkv, dh, bs, w, blocks, slens,
                                    dtype):
    arrays, tables = _inputs(b, sb, nh, nkv, dh, bs, w, seed=sum(slens))
    plens = np.asarray([n * bs for n in blocks], np.int32)
    sl = np.asarray(slens, np.int32)
    jd, td = DTYPES[dtype]
    ref = jpp.prefix_prefill_attention(
        *[jnp.asarray(a, jd) for a in arrays], jnp.asarray(tables),
        jnp.asarray(plens), jnp.asarray(sl))
    out = prefix_prefill_attention(
        *[torch.from_numpy(a).to(td) for a in arrays],
        torch.from_numpy(tables), torch.from_numpy(plens),
        torch.from_numpy(sl))
    assert out.dtype == td and out.shape == (b, sb, nh, dh)
    got = out.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(ref, jnp.float32))
    for row in range(b):
        assert (got[row, slens[row]:] == 0).all()
        assert (want[row, slens[row]:] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_reference_zeroes_pad_rows_and_defaults_to_full_suffix():
    """The plain version is the JAX reference plus `suffix_lens`: rows past
    it are exact zeros, and with suffix_lens=None every row is live."""
    arrays, tables = _inputs(2, 8, 4, 2, 16, 8, 2, seed=1)
    t = [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(tables)]
    plens = torch.tensor([16, 8], dtype=torch.int32)
    full = prefix_prefill_reference(*t, plens)
    jref = jpp.prefix_prefill_reference(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(tables),
        jnp.asarray(plens.numpy()))
    np.testing.assert_allclose(full.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=0)
    part = prefix_prefill_reference(*t, plens,
                                    torch.tensor([8, 3], dtype=torch.int32))
    assert (part[1, 3:] == 0).all()
    torch.testing.assert_close(part[1, :3], full[1, :3], atol=0, rtol=0)
    torch.testing.assert_close(part[0], full[0], atol=0, rtol=0)


def test_prefix_prefill_refuses_what_the_jax_wrapper_refuses():
    arrays, tables = _inputs(1, 8, 4, 2, 16, 8, 1, seed=2)
    q, ks, vs, kc, vc = (torch.from_numpy(a) for a in arrays)
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="whole number"):
        prefix_prefill_attention(q[:, :6], ks[:, :6], vs[:, :6], kc, vc,
                                 torch.from_numpy(tables), lens)
    with pytest.raises(ValueError, match="at least one page"):
        prefix_prefill_attention(q, ks, vs, kc, vc,
                                 torch.zeros(1, 0, dtype=torch.int32), lens)
    with pytest.raises(ValueError, match="only apply to int8"):
        prefix_prefill_attention(q, ks, vs, kc, vc, torch.from_numpy(tables),
                                 lens, k_scale=torch.ones(4, 2),
                                 v_scale=torch.ones(4, 2))
    # CPU tensors take the plain version: nothing is launched
    _build.reset_launch_counts()
    prefix_prefill_attention(q, ks, vs, kc, vc, torch.from_numpy(tables),
                             lens)
    assert not any(_build.launch_counts().values())


def _model_setup(nkv, seed=21):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=nkv)
    paddle.seed(seed)
    raw = dict(JaxModel(jcfg).raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=nkv)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, raw, cfg, p


@pytest.mark.parametrize("nkv", [2, 4])
def test_make_prefill_with_prefix_matches_jax(nkv):
    """Suffix prefill over random pools: per-row prefix depths 2/0/1
    pages, pad suffix rows. Hidden states within 1e-4 and the
    rotary-applied suffix K/V within 1e-5 of the JAX function's."""
    jcfg, raw, cfg, p = _model_setup(nkv)
    rng = np.random.default_rng(4)
    b, sb, w_pre, bs, n_pages = 3, 16, 2, 8, 9
    dh, n_layers = cfg.head_dim, cfg.num_hidden_layers
    pools = [rng.standard_normal((n_pages, nkv, bs, dh)).astype(np.float32)
             for _ in range(2 * n_layers)]
    ids = rng.integers(1, cfg.vocab_size, (b, sb))
    ptbl = np.asarray([[3, 5], [0, 0], [7, 0]], np.int32)
    plens = np.asarray([16, 0, 8], np.int32)
    slens = np.asarray([16, 5, 11], np.int32)

    jh, jkvs = jl._make_prefill_with_prefix(jcfg, b, sb, w_pre, bs)(
        raw, [jnp.asarray(a) for a in pools[:n_layers]],
        [jnp.asarray(a) for a in pools[n_layers:]], jnp.asarray(ids),
        jnp.asarray(ptbl), jnp.asarray(plens), jnp.asarray(slens))
    th, tkvs = pl._make_prefill_with_prefix(cfg, b, sb, w_pre, bs)(
        p, [torch.from_numpy(a) for a in pools[:n_layers]],
        [torch.from_numpy(a) for a in pools[n_layers:]],
        torch.from_numpy(ids), torch.from_numpy(ptbl),
        torch.from_numpy(plens), torch.from_numpy(slens))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    for (tk, tv), (jk, jv) in zip(tkvs, jkvs):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=0)


def test_prefill_with_prefix_refuses_int8_pools_and_odd_buckets():
    """An int8 pool without its scales is refused (an (int8 pool, scale)
    pair serves: tests/test_torch_kv_quant.py), as is a suffix bucket
    that is not a whole number of pages."""
    _, _, cfg, p = _model_setup(2)
    with pytest.raises(ValueError, match="whole number"):
        pl._make_prefill_with_prefix(cfg, 1, 12, 1, 8)
    fn = pl._make_prefill_with_prefix(cfg, 1, 8, 1, 8)
    pool = torch.zeros(3, 2, 8, cfg.head_dim, dtype=torch.int8)
    n = cfg.num_hidden_layers
    args = (torch.ones(1, 8, dtype=torch.int64),
            torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="k_scale / v_scale"):
        fn(p, [pool] * n, [pool] * n, *args)
    pair = (pool, torch.zeros(3, 2))
    h, _ = fn(p, [pair] * n, [pair] * n, *args)
    assert torch.isfinite(h).all()
