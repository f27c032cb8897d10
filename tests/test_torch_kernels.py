"""Parity of the PyTorch port's kernel modules (paddle_tpu_torch.kernels)
with the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through the JAX function -- whose
Pallas kernels run in interpret mode here, as the JAX package's own tests
run them -- and through the port's function on CPU tensors, which runs
its plain PyTorch version. Tolerances:

- f32: atol 1e-5 (same math, different summation order);
- bf16, same rounding points: one bf16 rounding step,
  |a - b| <= 2^-7 * max(|ref|, 1) elementwise;
- bf16 flash attention: the JAX Pallas kernel keeps the scores in f32,
  the port's plain twin of ``_fwd_ref`` rounds them to bf16 first, so
  they may differ by that rounding: atol 3e-2 on N(0, 1) inputs.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
compares each with its plain version there and skips here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.kernels.decode_attention import (
    paged_decode_attention as jax_paged_decode)
from paddle_tpu.kernels.flash_attention import (
    flash_attention as jax_flash)
from paddle_tpu.kernels.rms_norm import rms_norm as jax_rms
from paddle_tpu.kernels.rope import apply_rotary_emb as jax_rope
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_reference)
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference
from paddle_tpu_torch.kernels.rope import apply_rotary_emb

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _assert_close(got: torch.Tensor, ref, dtype: str, bf16_atol=None):
    g = got.to(torch.float32).numpy()
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    assert g.shape == r.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)
    elif bf16_atol is not None:
        np.testing.assert_allclose(g, r, atol=bf16_atol, rtol=0)
    else:
        tol = 2.0 ** -7 * np.maximum(np.abs(r), 1.0)
        assert (np.abs(g - r) <= tol).all(), np.abs(g - r).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, dtype)
    out = rms_norm(tx, tw, 1e-6)
    assert out.dtype == tx.dtype
    _assert_close(out, jax_rms(jx, jw, 1e-6), dtype)


def test_rms_norm_rounds_once_after_the_weight():
    """(x32 * inv * w32) cast once -- not the Hugging Face order, which
    casts x * inv to bf16 before multiplying by w."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((1 + 0.3 * rng.standard_normal(64)).astype(
        np.float32)).to(torch.bfloat16)
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    jax_order = (x32 * inv * w.float()).to(torch.bfloat16)
    hf_order = (x32 * inv).to(torch.bfloat16) * w
    got = rms_norm(x, w, 1e-6)
    assert torch.equal(got, jax_order)
    assert not torch.equal(got, hf_order)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", ["sequence", "per_row"])
def test_apply_rotary_emb_vector_positions(dtype, positions):
    """Prefill positions [S] and decode positions lens[:, None] (one per
    row, llama.py:2681); tables are f32 and cast to q's dtype before the
    rotation, so bf16 rotates in bf16 on both sides."""
    rng = np.random.default_rng(2)
    b, s = (2, 6) if positions == "sequence" else (3, 1)
    q = rng.standard_normal((b, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((b, s, 2, 16)).astype(np.float32)
    pos = (np.arange(s, dtype=np.int32) if positions == "sequence"
           else np.asarray([[0], [7], [33]], np.int32))
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jo = jax_rope(jq, jk, position_ids=jnp.asarray(pos), base=500000.0)
    to = apply_rotary_emb(tq, tk, position_ids=torch.from_numpy(pos),
                          base=500000.0)
    for t, j in zip(to, jo):
        assert t.dtype == tq.dtype
        _assert_close(t, j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,sq,sk", [
    (4, 2, 16, 16),   # GQA 2:1, square
    (4, 2, 5, 16),    # ragged Sq: causal diagonal aligned to the end
    (4, 4, 16, 16),   # group 1
])
def test_flash_attention_matches_jax(dtype, hq, hkv, sq, sk):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, sq, hq, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    ref = jax_flash(jq, jk, jv, causal=True)
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _assert_close(out, ref, dtype, bf16_atol=3e-2)


def test_flash_attention_lse_is_the_row_logsumexp():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 6, 4, 16), (1, 9, 2, 16), (1, 9, 2, 16)))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    assert lse.shape == (4, 6) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     torch.repeat_interleave(k, 2, dim=2)) / 4.0
    mask = torch.ones(6, 9, dtype=torch.bool).tril(3)
    s = s.masked_fill(~mask, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1)[0], atol=1e-5,
                               rtol=0)


def _paged_inputs(hq, hkv, seed=5):
    """Pools of 12 pages of 4 slots; permuted tables; rows: ragged lens,
    lens on a page boundary, a free row (scratch page 0, lens 0), and a
    row past its table (lens >= W*bs: every position valid)."""
    rng = np.random.default_rng(seed)
    n_pages, bs, d, w = 12, 4, 16, 3
    kc = rng.standard_normal((n_pages, hkv, bs, d)).astype(np.float32)
    vc = rng.standard_normal((n_pages, hkv, bs, d)).astype(np.float32)
    q = rng.standard_normal((5, hq, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.stack([perm[0:w], perm[w:2 * w], perm[2 * w:3 * w],
                       np.zeros(w, np.int64),
                       perm[3 * w - 1:4 * w - 1]]).astype(np.int32)
    lens = np.asarray([5, 4, 11, 0, 3 * bs + 2], np.int32)
    return q, kc, vc, tables, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
def test_paged_decode_attention_matches_jax(dtype, hq, hkv):
    q, kc, vc, tables, lens = _paged_inputs(hq, hkv)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kc, vc))
    ref = jax_paged_decode(jq, jk, jv, jnp.asarray(tables),
                           jnp.asarray(lens))
    out = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                 torch.from_numpy(lens))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _assert_close(out, ref, dtype)


def test_paged_decode_mask_is_inclusive():
    """Position lens[b] (the current token, already written) is attended;
    lens[b] + 1 is not."""
    q, kc, vc, tables, lens = (torch.from_numpy(a)
                               for a in _paged_inputs(4, 2))
    base = paged_decode_attention(q, kc, vc, tables, lens)
    kc2, vc2 = kc.clone(), vc.clone()
    # poison position lens[0] + 1 = 6 (page column 1, slot 2) of row 0
    kc2[int(tables[0, 1]), :, 2] = 1e4
    vc2[int(tables[0, 1]), :, 2] = 1e4
    same = paged_decode_attention(q, kc2, vc2, tables, lens)
    torch.testing.assert_close(same[0], base[0], atol=0, rtol=0)
    # ...while position lens[0] = 5 itself moves the output
    kc3, vc3 = kc.clone(), vc.clone()
    vc3[int(tables[0, 1]), :, 1] = 1e4
    moved = paged_decode_attention(q, kc3, vc3, tables, lens)
    assert (moved[0] - base[0]).abs().max() > 1.0


def test_paged_decode_refuses_int8_scales():
    """Scales belong to int8 pools only, and an int8 pool needs them: the
    JAX wrapper's two ValueErrors (int8 pools are served since the int8
    kernels were ported; tests/test_torch_kv_quant.py holds them)."""
    q, kc, vc, tables, lens = (torch.from_numpy(a)
                               for a in _paged_inputs(4, 2))
    with pytest.raises(ValueError, match="only apply to int8"):
        paged_decode_attention(q, kc, vc, tables, lens,
                               k_scale=torch.ones(12, 2),
                               v_scale=torch.ones(12, 2))
    q8 = kc.to(torch.int8)
    with pytest.raises(ValueError, match="k_scale / v_scale"):
        paged_decode_attention(q, q8, q8, tables, lens)


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and launches nothing."""
    _build.reset_launch_counts()
    x = torch.randn(4, 64)
    w = torch.ones(64)
    torch.testing.assert_close(rms_norm(x, w), rms_norm_reference(x, w),
                               atol=0, rtol=0)
    q = torch.randn(1, 5, 2, 16)
    torch.testing.assert_close(flash_attention(q, q, q, causal=True),
                               flash_attention_reference(q, q, q, True),
                               atol=0, rtol=0)
    assert _build.launch_counts() == {name: 0 for name in _build.COUNTERS}
