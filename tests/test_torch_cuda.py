"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels are CUDA C++ for sm_90a with no interpret mode, so every test
here is marked `cuda` and skips where torch.cuda.is_available() is false.
The file imports neither jax nor paddle_tpu, so it runs on a machine
without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: rms_norm and paged decode compute in f32 from the same
inputs and round once, so they may differ by one bf16 rounding step
(|a - b| <= 2^-7 * max(|ref|, 1)); flash attention's plain twin rounds
the scores to bf16 where the kernel keeps f32 (atol 3e-2 on N(0, 1)).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_reference)
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a "
                    "and have no interpret mode")
    return torch.device("cuda")


def _within_one_bf16_step(got, ref):
    g, r = got.float(), ref.float()
    assert ((g - r).abs() <= 2.0 ** -7 * r.abs().clamp(min=1.0)).all(), \
        float((g - r).abs().max())


def _launched(name, fn):
    before = _build.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("rows,dim", [(64, 4096), (3, 100)])
def test_rms_norm(dev, rows, dim):
    x = torch.randn(rows, dim, device=dev, dtype=torch.bfloat16)
    w = torch.randn(dim, device=dev, dtype=torch.bfloat16)
    got = _launched("rms_norm", lambda: rms_norm(x, w))
    _within_one_bf16_step(got, rms_norm_reference(x, w))


@pytest.mark.parametrize("sq,sk,hq,hkv,d", [
    (200, 333, 32, 8, 128), (64, 64, 8, 8, 64), (1, 77, 4, 1, 128)])
def test_flash_attention(dev, sq, sk, hq, hkv, d):
    q = torch.randn(2, sq, hq, d, device=dev, dtype=torch.bfloat16)
    k = torch.randn(2, sk, hkv, d, device=dev, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    got, lse = _launched("flash_attention_fwd", lambda: flash_attention(
        q, k, v, causal=True, return_lse=True))
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                             return_lse=True)
    assert (got.float() - ref.float()).abs().max() <= 3e-2
    assert (lse - ref_lse).abs().max() <= 1e-2


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 8, 2, 128, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q, q, causal=True)
    qb = torch.randn(1, 8, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(qb, qb, qb, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv", [(32, 8), (32, 32), (8, 1)])
def test_paged_decode(dev, dtype, hq, hkv):
    g = torch.Generator().manual_seed(5)
    n_pages, bs, d, w = 40, 64, 128, 6
    kc, vc = (torch.randn(n_pages, hkv, bs, d, generator=g)
              for _ in range(2))
    q = torch.randn(6, hq, d, generator=g)
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    tables = perm[: 6 * w].reshape(6, w).to(torch.int32)
    tables[3] = 0                              # a free row: scratch page
    lens = torch.tensor([0, bs - 1, bs, 0, 300, w * bs + 9], dtype=torch.int32)
    args = [t.to(dev, dtype) for t in (q, kc, vc)] + [tables.to(dev),
                                                      lens.to(dev)]
    got = _launched("paged_decode_attention",
                    lambda: paged_decode_attention(*args))
    ref = paged_decode_attention_reference(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    else:
        _within_one_bf16_step(got, ref)


def test_paged_decode_refuses_int64_tables(dev):
    q = torch.randn(1, 4, 128, device=dev, dtype=torch.bfloat16)
    kc = torch.randn(2, 2, 64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, kc, kc, torch.zeros(1, 1, device=dev,
                                                      dtype=torch.int64),
                               torch.zeros(1, device=dev, dtype=torch.int32))
