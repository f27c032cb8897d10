"""The plain twins and launch grid of the redesigned training kernels
(the flash backward's dq and the fused SwiGLU), against the JAX package,
on the CPU.

- dq reads delta = rowsum(dO * O) from the pre-pass
  (``flash_attention_bwd_delta``) that ``flash_attention_bwd`` launches
  once for dq and dkv. The plain dq fed the pre-pass twin's delta is held
  against JAX ``_bwd_pallas`` (interpret mode, as the JAX package's own
  tests run it) on the same forward output and lse. Tolerances are the
  ones tests/test_torch_train_kernels.py states for the flash backward:
  f32 atol 1e-4 (sums over up to 333 keys of products of O(1) factors,
  taken in another order); bf16 atol 2^-5, one bf16 step at the O(1)
  gradients' scale (both round dS to bf16 before dS K, from f32 sums
  taken in another order, so a value next to a rounding boundary may
  round the other way).
- On CPU tensors the wrappers run the plain versions and launch nothing;
  handing a delta in changes no bit.
- The SwiGLU kernel's grid (``swiglu_grid``) is the Python around the
  CUDA kernel's launch: one CTA an SM, no more than there are output
  tiles, and the routing's refusals. (The kernel's ring is held inside
  the 227 KB a block may opt into by a static_assert in csrc/swiglu.cu.)

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.flash_attention import (
    _plain_bwd, _to_bh, flash_attention, flash_attention_bwd,
    flash_attention_bwd_delta_reference, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_bwd_reference)
from paddle_tpu_torch.kernels.swiglu import swiglu_fwd, swiglu_grid

# the kernel modules themselves (the packages re-export functions under
# some of their names)
jfa = import_module("paddle_tpu.kernels.flash_attention")
tfa = import_module("paddle_tpu_torch.kernels.flash_attention")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, atol):
    g, r = _f32(got), _f32(ref)
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, atol=atol, rtol=0)


def _inputs(b, sq, sk, hq, hkv, d, seed):
    """q, k, v, dO in the public [B, S, H, D] layout, f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sq, hq, d)).astype(np.float32))


def _np_bh(x: np.ndarray) -> np.ndarray:
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


# ---------------------------------------------------------------------------
# dq with the pre-pass delta
# ---------------------------------------------------------------------------

DQ_CASES = [  # (Hq, Hkv, Sq, Sk)
    (4, 4, 64, 64),      # group 1
    (8, 2, 64, 64),      # group 4
    (4, 4, 200, 333),    # ragged, Sq < Sk: the diagonal at q_offset 133
    (8, 2, 200, 333),    # ragged, group 4
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,sq,sk", DQ_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dq_with_prepass_delta_matches_jax_bwd_pallas(dtype, hq, hkv, sq,
                                                      sk, causal):
    """The plain dq fed ``flash_attention_bwd_delta_reference``'s delta
    against JAX ``_bwd_pallas``'s dq (one block per sequence, so ragged
    lengths tile exactly) on JAX's own forward output and lse."""
    b, d, scale = 2, 16, 0.25
    jd, td = DTYPES[dtype]
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, d, seed=sq + hq)
    jq, jk, jv, jdo = (jnp.asarray(_np_bh(a), jd) for a in (q, k, v, do))
    blocks = dict(block_q=sq, block_k=sk)
    jout, jlse = jfa._fwd_pallas(jq, jk, jv, causal, scale, **blocks)
    jdq = jfa._bwd_pallas(jq, jk, jv, jout, jlse, jdo, causal, scale,
                          **blocks)[0]
    # the JAX forward's output and lse, back in the public layout
    out = torch.from_numpy(_f32(jout).reshape(b, hq, sq, d).transpose(
        0, 2, 1, 3).copy()).to(td)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    delta = flash_attention_bwd_delta_reference(out, tdo)
    assert delta.dtype == torch.float32 and delta.shape == (b * hq, sq)
    dq = flash_attention_bwd_reference(_to_bh(tq), _to_bh(tk), _to_bh(tv),
                                       _to_bh(out), lse, _to_bh(tdo),
                                       causal, scale, delta)[0]
    assert dq.dtype == td
    _close(dq, jdq, 1e-4 if dtype == "float32" else 2.0 ** -5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_and_dkv_with_delta_equal_the_calls_without(dtype):
    """On CPU tensors, handing the pre-pass's delta to the dq / dkv
    wrappers changes no bit."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(2, 200, 333, 8, 2, 16, seed=7))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    delta = flash_attention_bwd_delta_reference(out, do)
    args = (q, k, v, out, lse, do, True, 0.25)
    assert torch.equal(flash_attention_bwd_dq(*args),
                       flash_attention_bwd_dq(*args, delta=delta))
    for a, c in zip(flash_attention_bwd_dkv(*args),
                    flash_attention_bwd_dkv(*args, delta=delta)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_on_cpu_runs_the_prepass_twin_once(monkeypatch,
                                                               causal):
    """``flash_attention_bwd`` on CPU tensors equals ``_plain_bwd``
    bitwise, computes delta once through the pre-pass's plain twin, and
    counts no launch."""
    calls = []
    twin = tfa.flash_attention_bwd_delta_reference

    def counted(out, do):
        calls.append(1)
        return twin(out, do)

    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(1, 64, 128, 8, 2, 16, seed=8))
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    monkeypatch.setattr(tfa, "flash_attention_bwd_delta_reference", counted)
    _build.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, do, causal, 0.25)
    assert len(calls) == 1
    assert not any(_build.launch_counts().values())
    for a, c in zip(got, _plain_bwd(q, k, v, out, lse, do, causal, 0.25)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grad_ragged_gqa_matches_jax_grad(dtype):
    """The slice end to end: autograd through the port's flash_attention
    (forward, the pre-pass, dq and dkv sharing its delta) against
    jax.grad of the JAX flash_attention, ragged Sq < Sk, group 4, causal;
    the tolerances of tests/test_torch_train_kernels.py's autograd test
    (f32 4e-5; bf16 four bf16 steps, |a - b| <= 2^-5 max(|ref|, 1))."""
    jd, td = DTYPES[dtype]
    q, k, v, w = _inputs(1, 100, 164, 8, 2, 16, seed=9)
    jq, jk, jv, jw = (jnp.asarray(a, jd) for a in (q, k, v, w))

    def jloss(a, bb, c):
        out = jfa.flash_attention(a, bb, c, causal=True)
        return jnp.sum(out.astype(jnp.float32) * jw.astype(jnp.float32))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, causal=True)
    (out.float() * torch.from_numpy(w).to(td).float()).sum().backward()
    for leaf, ref in zip(leaves, jg):
        g, r = _f32(leaf.grad), _f32(ref)
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=4e-5, rtol=0)
        else:
            assert (np.abs(g - r) <= 2.0 ** -5 * np.maximum(np.abs(r), 1)
                    ).all(), np.abs(g - r).max()


# ---------------------------------------------------------------------------
# the SwiGLU kernel's grid
# ---------------------------------------------------------------------------

def test_swiglu_grid_at_phase_14():
    """Llama-3-8B's MLP at batch 4 x 2048 (M 8192, K 4096, F 14336): 64 x
    112 = 7168 output tiles of 128 x 128, walked by one persistent CTA on
    each of the H100's 132 SMs."""
    assert swiglu_grid(8192, 4096, 14336, 132) == 132
    assert swiglu_grid(8192, 4096, 14336, 8000) == 64 * 112 == 7168


@pytest.mark.parametrize("m,k,f,grid", [
    (512, 512, 512, 16),          # fewer tiles than SMs: one CTA a tile
    (1024, 2048, 1536, 96),
    (2048, 512, 2048, 132),       # more tiles than SMs: CTAs walk tiles
])
def test_swiglu_grid(m, k, f, grid):
    assert swiglu_grid(m, k, f, 132) == grid == min((m // 128) * (f // 128),
                                                    132)
    assert swiglu_grid(m, k, f, 7) == 7


@pytest.mark.parametrize("m,k,f", [(500, 512, 512), (512, 96, 512),
                                   (512, 512, 200), (640, 512, 512)])
def test_swiglu_grid_refuses_what_the_routing_does_not_send(m, k, f):
    """The wrappers' refusal of shapes the routing keeps from the kernel
    (not multiples of 512), with its message."""
    with pytest.raises(ValueError, match=f"swiglu_fwd: M, K and F must be "
                       f"multiples of 512, got M {m}, K {k}, F {f}"):
        swiglu_grid(m, k, f, 132, "swiglu_fwd")


def test_swiglu_on_cpu_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(10)
    x, wg, wu = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((512, 512), (512, 512), (512, 512)))
    _build.reset_launch_counts()
    got = swiglu_fwd(x, wg, wu)
    assert not any(_build.launch_counts().values())
    g, u = x @ wg, x @ wu
    torch.testing.assert_close(got, g * torch.sigmoid(g) * u, atol=1e-4,
                               rtol=1e-5)
