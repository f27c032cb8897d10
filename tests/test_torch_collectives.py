"""The port's quantized collectives (parallel/collectives.py) against the
JAX package's, on the CPU.

The wire format is held byte for byte: `quantize_blocks` (absmax / 127
per 128-lane block, partial blocks padded, narrow rows one block, zero
blocks scale 0, NaN blocks a NaN scale) and the packed sidecar. The
collectives run on spawned gloo ranks (tests/torch_rank_pool.py) at two
and four ranks against the same collective under JAX's shard_map on the
8-device CPU mesh: the JAX tests' own bars (relative error under 5% of
the exact sum, an all-gather within half a scale of the payload) and
agreement with JAX's result within 1e-6. `quantized_psum_prequant` of a
payload quantized by `quantize_blocks` equals `quantized_psum` of the f32
payload bitwise. Also: the megakernel's ``residual=False`` and
``quantize_out=True`` plain versions against JAX's interpret-mode kernel,
and the launcher starting two ranks that serve ``serving_mp=2``.
"""
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from paddle_tpu.kernels import decode_megakernel as jmk
from paddle_tpu.parallel import collectives as jqc
from paddle_tpu.parallel.shard_map_compat import shard_map
from paddle_tpu_torch.kernels import decode_megakernel as tmk
from paddle_tpu_torch.parallel import collectives as tqc
from test_torch_megakernel import BASE, EPS, _case, _jax_ops, _np, _torch_ops
from torch_rank_pool import RankPool, collective_rank, prequant_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _smap(fn, n, out_specs=P("dp")):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=P("dp"),
                             out_specs=out_specs, check_vma=False))


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [
    ((4, 256), 128), ((3, 300), 128), ((5, 40), 128), ((2, 3, 128), 64),
    ((1000,), 128)], ids=["whole", "partial-block", "narrow", "rank3",
                          "flat"])
def test_quantize_blocks_is_byte_exact_to_jax(shape, block):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.01, 10)).astype(np.float32)
    x.reshape(-1, x.shape[-1])[0, :min(block, x.shape[-1])] = 0.0  # zero
    jq, js = jqc.quantize_blocks(jnp.asarray(x), block)
    tq, ts = tqc.quantize_blocks(torch.from_numpy(x), block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts.reshape(-1, ts.shape[-1])[0, 0] == 0).item()
    want = jqc.dequantize_blocks(jq, js, out_dim=shape[-1])
    got = tqc.dequantize_blocks(tq, ts, out_dim=shape[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the packed sidecar: one int8 buffer, JAX's bytes
    jp = jqc._pack_scales(jq, js)
    tp = tqc._pack_scales(tq, ts)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    q2, s2 = tqc._unpack_scales(tp, ts.shape[-1])
    np.testing.assert_array_equal(q2.numpy(), tq.numpy())
    np.testing.assert_array_equal(s2.numpy(), ts.numpy())


def test_nonfinite_block_stays_poisoned():
    x = np.ones((2, 256), np.float32)
    x[1, 5] = np.nan
    q, s = tqc.quantize_blocks(torch.from_numpy(x))
    _, js = jqc.quantize_blocks(jnp.asarray(x))
    assert np.isnan(s[1, 0].item()) and np.isnan(np.asarray(js)[1, 0])
    out = tqc.dequantize_blocks(q, s).numpy()
    assert np.isnan(out[1, :128]).all() and np.isfinite(out[0]).all()


def test_resolve_and_fallback_warnings():
    assert tqc.resolve_quantized_collectives(True) is True
    assert tqc.resolve_quantized_collectives() is False
    assert tqc.QCOLL_BLOCK == jqc.QCOLL_BLOCK == 128
    assert tqc.QCOLL_FALLBACK_MSG == jqc.QCOLL_FALLBACK_MSG


# ---------------------------------------------------------------------------
# the collectives on ranks against JAX's shard_map
# ---------------------------------------------------------------------------

def _payloads(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * (1 + r)).astype(np.float32)
            for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_quantized_psum_matches_jax(pool, n):
    xs = _payloads(n, (3, 250), seed=n)
    outs = pool.run(n, collective_rank, "quantized_psum", xs, {})
    exact = sum(xs)
    want = np.asarray(_smap(lambda v: jqc.quantized_psum(v[0], "dp")[None],
                            n)(jnp.asarray(np.stack(xs))))[0]
    for got in outs:
        np.testing.assert_array_equal(got, outs[0])
        rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        assert rel < 0.05, rel
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    zero = pool.run(n, collective_rank, "quantized_psum",
                    [np.zeros((4, 128), np.float32)] * n, {})
    np.testing.assert_array_equal(zero[0], 0.0)


@pytest.mark.parametrize("n", [2, 4])
def test_quantized_all_gather_matches_jax(pool, n):
    xs = _payloads(n, (2, 3, 256), seed=10 + n)
    outs = pool.run(n, collective_rank, "quantized_all_gather", xs,
                    {"dim": 1})
    exact = np.concatenate(xs, axis=1)
    want = np.asarray(_smap(
        lambda v: jqc.quantized_all_gather(v[0], "dp", axis=1)[None], n)(
            jnp.asarray(np.stack(xs))))[0]
    _, s = tqc.quantize_blocks(torch.from_numpy(exact))
    bound = np.repeat(s.numpy(), 128, axis=-1) / 2 + 1e-7
    for got in outs:
        assert got.shape == exact.shape
        assert (np.abs(got - exact) <= bound).all()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_quantized_reduce_scatter_matches_jax(pool, n):
    xs = _payloads(n, (4 * n, 130), seed=20 + n)
    outs = pool.run(n, collective_rank, "quantized_reduce_scatter", xs, {})
    exact = sum(xs)
    want = np.asarray(_smap(
        lambda v: jqc.quantized_reduce_scatter(v[0], "dp")[None], n)(
            jnp.asarray(np.stack(xs))))
    rows = exact.shape[0] // n
    for r, got in enumerate(outs):
        part = exact[r * rows:(r + 1) * rows]
        assert np.linalg.norm(got - part) / np.linalg.norm(part) < 0.05
        np.testing.assert_allclose(got, want[r], atol=1e-6, rtol=1e-6)


def test_prequant_psum_is_bitwise_the_psum(pool):
    xs = _payloads(2, (4, 256), seed=30)
    for a, b in pool.run(2, prequant_rank, xs):
        np.testing.assert_array_equal(a, b)


def test_plain_collectives_and_fallbacks(pool):
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(2)]
    outs = pool.run(2, collective_rank, "all_gather", xs, {"dim": 1})
    np.testing.assert_array_equal(outs[0], np.concatenate(xs, 1))
    outs = pool.run(2, collective_rank, "all_reduce", xs, {"op": "max"})
    np.testing.assert_array_equal(outs[1], np.maximum(*xs))
    ints = [np.full((3, 4), 1 + r, np.int32) for r in range(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs = pool.run(2, collective_rank, "quantized_psum", ints, {})
    np.testing.assert_array_equal(outs[0], 3)


# ---------------------------------------------------------------------------
# the megakernel's tensor-parallel modes (plain versions) against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8_pools", [False, True], ids=["f32", "int8"])
def test_megakernel_seam_modes_match_jax(int8_pools):
    """residual=False: the f32 o-proj partial (within 1e-5); quantize_out:
    the int8 payload within one step and its scales equal to
    `quantize_blocks` of the plain partial, within 1e-6 of JAX's."""
    c = _case(nh=4, nkv=2, dh=32, H=128, int8_pools=int8_pools)
    jops = _jax_ops(c, jnp.float32)
    h, lens, tables, weights, pools, kw = jops
    one = [w[0] for w in weights]
    args_j = (h, lens, tables, one[0], *one[2:6])
    kwj = dict(kw, rope_base=BASE, eps=EPS)
    def fresh():
        """The port's operands anew (the calls commit into the pools)."""
        th, tl, tt, tw, tpools, tkw = _torch_ops(jops, torch.float32)
        tone = [w[0] for w in tw]
        return (th, tl, tt, tone[0], *tone[2:6], *tpools), tkw

    for quant in (False, True):
        targs, tkw = fresh()
        got = tmk.decode_layer_megakernel(
            *targs, rope_base=BASE, eps=EPS, residual=False,
            quantize_out=quant, **tkw)[0]
        want = jax.jit(lambda *a: jmk.decode_layer_megakernel(
            *a, residual=False, quantize_out=quant, **kwj)[0])(
                *args_j, *pools)
        targs, tkw = fresh()
        plain = tmk.decode_layer_megakernel_reference(
            *targs, rope_base=BASE, eps=EPS, residual=False, **tkw)[0]
        if not quant:
            assert got.dtype == torch.float32 and got.shape == (4, 1, 128)
            np.testing.assert_allclose(_np(got).reshape(4, 128),
                                       _np(want).reshape(4, 128), atol=1e-5,
                                       rtol=0)
            continue
        q, s = got
        jq, js = want
        assert q.dtype == torch.int8 and s.shape == (4, 1)
        assert np.abs(q.numpy().astype(np.int32)
                      - np.asarray(jq).astype(np.int32)).max() <= 1
        np.testing.assert_allclose(s.numpy(), np.asarray(js).reshape(4, 1),
                                   rtol=1e-6, atol=0)
        rq, rs = tqc.quantize_blocks(plain.reshape(4, 128))
        np.testing.assert_array_equal(q.numpy(), rq.numpy())
        np.testing.assert_array_equal(s.numpy(), rs.numpy())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_SCRIPT = '''
import sys, torch
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.llama import init_serving_params
from paddle_tpu_torch.parallel.ranks import init_ranks
from paddle_tpu_torch.serving import ContinuousBatchingEngine
import torch.distributed as dist
rank, world, dev = init_ranks(device="cpu")
cfg = LlamaConfig.tiny()
eng = ContinuousBatchingEngine(
    cfg, init_serving_params(cfg, seed=0, device="cpu", dtype=torch.float32),
    device="cpu", dtype=torch.float32, slots=2, prompt_bucket=8,
    max_prompt_len=16, max_new_tokens=4, block_size=8, serving_mp=world)
req = eng.add_request([3, 5, 7, 9, 11], max_new=4)
eng.run(max_iters=50)
assert eng.metrics()["serving_mp"] == world == 2
with open(sys.argv[1] + f"/rank{rank}", "w") as f:
    f.write(" ".join(map(str, req.tokens)) + " " + dist.get_backend())
dist.destroy_process_group()
'''


def test_launcher_starts_two_ranks_serving_mp2(tmp_path):
    from paddle_tpu_torch.parallel.launch.main import launch

    script = tmp_path / "serve.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    rc = subprocess.call(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
         "--nproc_per_node", "2", "--max_restart", "0", "--log_dir",
         str(tmp_path / "logs"), str(script), str(tmp_path)], env=env,
        cwd=REPO, timeout=240)
    logs = "".join(p.read_text()[-2000:] for p in sorted(
        (tmp_path / "logs").glob("workerlog.*")))
    assert rc == 0, logs
    got = [(tmp_path / f"rank{r}").read_text().split() for r in range(2)]
    assert got[0] == got[1] and got[0][-1] == "gloo" and len(got[0]) == 5
    with pytest.raises(NotImplementedError, match="item 5"):
        launch(["--nnodes", "1:2", str(script)])
