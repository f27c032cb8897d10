"""Parity of the port's training kernels' plain versions and autograd
wrappers with the JAX package, on the CPU.

The same numpy inputs (from a seed) go through the JAX function -- its
Pallas kernels in interpret mode, as the JAX package's own tests run
them -- and through the port's function on CPU tensors, which runs the
plain version of each CUDA kernel. Tolerances:

- f32: atol 1e-5 on O(1) values (same arithmetic, summation order only);
  2e-5 for the flash backward (sums over 128 keys of products of O(1)
  factors; 4e-5 through autograd, forward included), 1e-4 for SwiGLU
  sums over K = 512 and 1e-3 for its grads (sums over 512 of O(10)
  terms).
- bf16, same rounding points: one bf16 step, |a - b| <= 2^-7 *
  max(|ref|, 1) elementwise.
- bf16 flash backward: both round dS (and p) to bf16 before the
  products, but dS is computed from f32 sums taken in another order, so
  a value next to a rounding boundary may round the other way: atol
  2^-5 on the O(1) gradients. dk / dv over a GQA group: the port sums
  the q heads of a group in f32 and rounds once, JAX rounds each head
  to bf16 and sums in bf16: atol 2^-4 (a few bf16 steps of the O(1)
  per-head values).
- bf16 flash forward + backward through autograd: the forward differs by
  the score rounding (tests/test_torch_kernels.py), which the backward
  inherits: |a - b| <= 2^-5 * max(|ref|, 1) (four bf16 steps).
- bf16 SwiGLU grads: dx, dwg, dwu are bf16 products of dh_g / dh_u that
  are themselves one bf16 step apart at most: two bf16 steps,
  |a - b| <= 2^-6 * max(|ref|, 1).

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them against these plain versions there and skips here.
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_reference)
from paddle_tpu_torch.kernels.rms_norm import rms_norm
from paddle_tpu_torch.kernels.swiglu import (
    _aligned, swiglu_bwd, swiglu_bwd_reference, swiglu_fwd,
    swiglu_fwd_reference, swiglu_matmul, swiglu_matmul_reference)

# the JAX kernel modules (paddle_tpu.kernels re-exports functions under
# some of their names, so take the modules themselves)
jfa = import_module("paddle_tpu.kernels.flash_attention")
jrms = import_module("paddle_tpu.kernels.rms_norm")
jsw = import_module("paddle_tpu.kernels.swiglu")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within(got, ref, rel):
    """|got - ref| <= rel * max(|ref|, 1) elementwise."""
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    tol = rel * np.maximum(np.abs(r), 1.0)
    assert (np.abs(g - r) <= tol).all(), np.abs(g - r).max()


def _one_bf16_step(got, ref):
    _within(got, ref, 2.0 ** -7)


def _close(got, ref, atol):
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (Hq, Hkv, Sq, Sk, causal)
    (4, 4, 64, 64, True),      # group 1
    (4, 2, 64, 64, True),      # group 2
    (8, 2, 64, 64, True),      # group 4
    (4, 1, 64, 64, True),      # MQA
    (4, 2, 64, 128, True),     # Sq < Sk: the diagonal at q_offset = 64
    (4, 2, 64, 128, False),    # not causal
]


def _flash_inputs(hq, hkv, sq, sk, seed=0, b=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b * hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b * hkv, sk, d)).astype(np.float32)
    do = rng.standard_normal((b * hq, sq, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal", FLASH_CASES)
def test_flash_bwd_reference_matches_jax_bwd_pallas(dtype, hq, hkv, sq, sk,
                                                    causal):
    """The plain twin of the kernel pair against JAX ``_bwd_pallas``
    (interpret mode) on the same forward output and lse."""
    scale = 0.25
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _both(a, dtype) for a in _flash_inputs(hq, hkv, sq, sk))
    jout, jlse = jfa._fwd_pallas(jq, jk, jv, causal, scale)
    jdq, jdk, jdv = jfa._bwd_pallas(jq, jk, jv, jout, jlse, jdo, causal,
                                    scale)
    rep = hq // hkv
    jdk = jdk.reshape(jk.shape[0], rep, *jdk.shape[1:]).sum(1)
    jdv = jdv.reshape(jv.shape[0], rep, *jdv.shape[1:]).sum(1)
    tout = torch.from_numpy(_f32(jout).copy()).to(tq.dtype)
    tlse = torch.from_numpy(np.asarray(jlse)[..., 0])
    dq, dk, dv = flash_attention_bwd_reference(tq, tk, tv, tout, tlse, tdo,
                                               causal, scale)
    assert dq.dtype == tq.dtype and dk.shape == tk.shape
    if dtype == "float32":
        for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
            _close(got, ref, 2e-5)
    else:
        _close(dq, jdq, 2.0 ** -5)
        for got, ref in ((dk, jdk), (dv, jdv)):
            _close(got, ref, 2.0 ** -5 if rep == 1 else 2.0 ** -4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal", FLASH_CASES)
def test_flash_attention_grad_matches_jax_grad(dtype, hq, hkv, sq, sk,
                                               causal):
    """Autograd through the port's flash_attention (forward, then the
    backward wrappers' plain version) against jax.grad of the JAX
    flash_attention, in the public [B, S, H, D] layout."""
    rng = np.random.default_rng(1)
    b, d = 2, 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    w = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = (_both(a, dtype)
                                              for a in (q, k, v, w))

    def jloss(a, bb, c):
        out = jfa.flash_attention(a, bb, c, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jw.astype(jnp.float32))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash_attention(*leaves, causal=causal)
    (out.float() * tw.float()).sum().backward()
    for leaf, ref in zip(leaves, jg):
        assert leaf.grad.dtype == leaf.dtype
        if dtype == "float32":
            _close(leaf.grad, ref, 4e-5)
        else:
            _within(leaf.grad, ref, 2.0 ** -5)


def test_flash_bwd_wrappers_are_the_reference_on_cpu():
    """On CPU tensors the dq / dkv wrappers return the plain version's
    results (in the [B, S, H, D] layout) and launch nothing."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(
        np.float32))
    v, do = torch.randn_like(k), torch.randn_like(q)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    _build.reset_launch_counts()
    dq = flash_attention_bwd_dq(q, k, v, out, lse, do, True, 0.25)
    dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, do, True, 0.25)
    assert not any(_build.launch_counts().values())

    def bh(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])
    rdq, rdk, rdv = flash_attention_bwd_reference(
        bh(q), bh(k), bh(v), bh(out), lse, bh(do), True, 0.25)
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(bh(got), ref, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------

def _swiglu_inputs(m, k, f, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wg = (rng.standard_normal((k, f)) / np.sqrt(k)).astype(np.float32)
    wu = (rng.standard_normal((k, f)) / np.sqrt(k)).astype(np.float32)
    dout = rng.standard_normal((m, f)).astype(np.float32)
    return x, wg, wu, dout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_plain_versions_match_jax_pallas(dtype):
    """swiglu_fwd_reference / swiglu_bwd_reference against JAX
    _fwd_pallas / _bwd_pallas with 128-blocks at 256-wide shapes (a 2 x 2
    x 2 grid: the K accumulation crosses blocks)."""
    (jx, tx), (jg, tg), (ju, tu), (jd, td) = (
        _both(a, dtype) for a in _swiglu_inputs(256, 256, 256))
    blocks = dict(bm=128, bf=128, bk=128)
    ref = jsw._fwd_pallas(jx, jg, ju, **blocks)
    rdg, rdu = jsw._bwd_pallas(jx, jg, ju, jd, **blocks)
    got = swiglu_fwd_reference(tx, tg, tu)
    dg, du = swiglu_bwd_reference(tx, tg, tu, td)
    assert got.dtype == tx.dtype and dg.dtype == tx.dtype
    for g, r in ((got, ref), (dg, rdg), (du, rdu)):
        if dtype == "float32":
            _close(g, r, 1e-4)
        else:
            _one_bf16_step(g, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matmul_fused_matches_jax_swiglu_fused(dtype):
    """swiglu_matmul(fused=True) at 512 (the kernels' route) against the
    JAX custom vjp _swiglu_fused: forward and the grads of x, wg, wu."""
    x, wg, wu, dout = _swiglu_inputs(512, 512, 512, seed=4)
    (jx, tx), (jg, tg), (ju, tu), (jd, td) = (_both(a, dtype)
                                              for a in (x, wg, wu, dout))
    ref, vjp = jax.vjp(jsw._swiglu_fused, jx, jg, ju)
    jgrads = vjp(jd)
    leaves = [t.clone().requires_grad_() for t in (tx, tg, tu)]
    out = swiglu_matmul(leaves[0][None], leaves[1], leaves[2], fused=True)
    assert out.shape == (1, 512, 512)
    out[0].backward(td)
    if dtype == "float32":
        _close(out[0], ref, 1e-4)
        for leaf, r in zip(leaves, jgrads):
            _close(leaf.grad, r, 1e-3)
    else:
        _one_bf16_step(out[0], ref)
        for leaf, r in zip(leaves, jgrads):
            _within(leaf.grad, r, 2.0 ** -6)


def test_swiglu_routing_is_jax_routing():
    """The kernels only for fused=True on 512-aligned M, K and F;
    otherwise the plain composition, as in JAX (_aligned, swiglu_matmul)."""
    assert _aligned(512, 1024, 512) and not _aligned(512, 5504, 2048)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    wg = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    wu = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    plain = torch.nn.functional.silu(x @ wg) * (x @ wu)
    for fused in (None, False, True):
        for fn in (swiglu_matmul, swiglu_matmul_reference):
            torch.testing.assert_close(fn(x, wg, wu, fused=fused), plain,
                                       atol=0, rtol=0)
    jref = jsw.swiglu_matmul(jnp.asarray(x.numpy()), jnp.asarray(wg.numpy()),
                             jnp.asarray(wu.numpy()), fused=True)
    _close(plain, jref, 1e-4)


def test_swiglu_wrappers_are_the_reference_on_cpu():
    x, wg, wu, dout = (torch.from_numpy(a) for a in
                       _swiglu_inputs(512, 512, 512, seed=6))
    _build.reset_launch_counts()
    torch.testing.assert_close(swiglu_fwd(x, wg, wu),
                               swiglu_fwd_reference(x, wg, wu), atol=0,
                               rtol=0)
    for g, r in zip(swiglu_bwd(x, wg, wu, dout),
                    swiglu_bwd_reference(x, wg, wu, dout)):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    assert not any(_build.launch_counts().values())


# ---------------------------------------------------------------------------
# rms_norm gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_grad_matches_jax_grad(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    c = rng.standard_normal((3, 5, 64)).astype(np.float32)
    (jx, tx), (jw, tw), (jc, tc) = (_both(a, dtype) for a in (x, w, c))

    def jloss(a, b):
        y = jrms.rms_norm(a, b, 1e-6)
        return jnp.sum(y.astype(jnp.float32) * jc.astype(jnp.float32))

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    lx, lw = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    (rms_norm(lx, lw, 1e-6).float() * tc.float()).sum().backward()
    assert lx.grad.dtype == lx.dtype and lw.grad.dtype == lw.dtype
    if dtype == "float32":
        _close(lx.grad, jdx, 1e-5)
        _close(lw.grad, jdw, 1e-4)      # a sum over 15 rows
    else:
        _one_bf16_step(lx.grad, jdx)
        _one_bf16_step(lw.grad, jdw)
