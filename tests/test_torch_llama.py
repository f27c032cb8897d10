"""Parity of the port's Llama serving pieces (paddle_tpu_torch.models)
with the JAX package's, on the CPU, in f32 on ``LlamaConfig.tiny()``
(GQA 4:2, head_dim 16) plus a group-1 variant.

The same weights (the JAX model's ``raw_state()`` as numpy, carried
across by ``params_from_jax``) and the same numpy inputs go through both
packages. The JAX side runs as its own tests run it here (Pallas in
interpret mode). Tolerance: atol 1e-4 on hidden states and logits (f32,
two layers, summation order only), 1e-5 on K/V.

Also the port's own rules: importing it pulls in neither jax nor
paddle_tpu, entry points default to CUDA and raise without it, and the
host-side page allocator keeps the JAX manager's contract.
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.decode_attention import (
    paged_decode_attention as jax_paged_decode)
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.framework import flags as port_flags
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     PagedKVManager, init_serving_params,
                                     params_from_jax)
from paddle_tpu_torch.models import llama as pl

ATOL = 1e-4


def _setup(nkv=2, seed=21):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=nkv)
    paddle.seed(seed)
    jm = JaxModel(jcfg)
    raw = dict(jm.raw_state())
    np_params = {k: np.asarray(v) for k, v in raw.items()}
    cfg = LlamaConfig.tiny(num_key_value_heads=nkv)
    return jcfg, jm, raw, cfg, params_from_jax(np_params, device="cpu")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("nkv", [2, 4])
def test_forward_logits_match_jax(nkv):
    jcfg, jm, _, cfg, p = _setup(nkv)
    ids = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 11))
    ref = _np(jm(paddle.to_tensor(ids)).numpy())
    model = LlamaForCausalLM(cfg).load_params(p)
    got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # the plain-op forward is the same function on the CPU
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(p)
    torch.testing.assert_close(plain(torch.from_numpy(ids)), got, atol=0,
                               rtol=0)


def test_load_jax_params_shares_the_dict_layout():
    jcfg, jm, raw, cfg, p = _setup()
    np_params = {k: np.asarray(v) for k, v in raw.items()}
    model = LlamaForCausalLM(cfg).load_jax_params(np_params, device="cpu")
    for name, t in model.named_parameters():
        np.testing.assert_array_equal(t.numpy(), np_params[name])
    # load_params shares storage with the dict (no copy)
    m2 = LlamaForCausalLM(cfg).load_params(p)
    assert m2.lm_head.weight.data_ptr() == p["lm_head.weight"].data_ptr()


def test_param_shapes_match_the_jax_state():
    _, _, raw, cfg, _ = _setup()
    assert {k: tuple(v.shape) for k, v in raw.items()} \
        == pl.param_shapes(cfg)
    made = init_serving_params(cfg, seed=3, device="cpu",
                               dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in made.items()} \
        == pl.param_shapes(cfg)
    assert all(v.dtype == torch.bfloat16 for v in made.values())
    again = init_serving_params(cfg, seed=3, device="cpu",
                               dtype=torch.bfloat16)
    assert all(torch.equal(made[k], again[k]) for k in made)


@pytest.mark.parametrize("nkv", [2, 4])
def test_make_prefill_matches_jax(nkv):
    jcfg, _, raw, cfg, p = _setup(nkv)
    b, sb = 2, 16
    ids = np.random.default_rng(1).integers(1, cfg.vocab_size, (b, sb))
    jh, jkvs = jl._make_prefill(jcfg, b, sb)(raw, jnp.asarray(ids))
    th, tkvs = pl._make_prefill(cfg, b, sb)(p, torch.from_numpy(ids))
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=ATOL, rtol=0)
    assert len(tkvs) == len(jkvs) == cfg.num_hidden_layers
    for (tk, tv), (jk, jv) in zip(tkvs, jkvs):
        np.testing.assert_allclose(tk.numpy(), _np(jk), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tv.numpy(), _np(jv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("nkv", [2, 4])
def test_paged_decode_step_matches_jax(nkv):
    """One decode step over paged pools: permuted tables, ragged lens, a
    free row on the scratch page (lens 0) and a row frozen at its budget
    (lens == W*bs, whose page column is clamped like a JAX gather)."""
    jcfg, _, raw, cfg, p = _setup(nkv)
    rng = np.random.default_rng(2)
    b, bs, w, n_pages = 4, 4, 3, 13
    dh = cfg.head_dim
    pools = [rng.standard_normal((n_pages, nkv, bs, dh)).astype(np.float32)
             for _ in range(2 * cfg.num_hidden_layers)]
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.stack([perm[0:3], perm[3:6], np.zeros(3, np.int64),
                       perm[6:9]]).astype(np.int32)
    lens = np.asarray([5, 8, 0, w * bs], np.int32)
    tok = rng.integers(1, cfg.vocab_size, (b, 1))

    jt = jnp.asarray(tables)
    _, jwrite = jl.make_paged_kv_helpers(b, 0, nkv, dh, bs, jt)
    jstep = jl._make_decode_step(
        jcfg, b, kv_write=jwrite,
        kv_attend=lambda q1, kc, vc, pos: jax_paged_decode(q1, kc, vc, jt,
                                                           pos))
    half = cfg.num_hidden_layers
    jlog, jkcs, jvcs = jstep(raw, [jnp.asarray(a) for a in pools[:half]],
                             [jnp.asarray(a) for a in pools[half:]],
                             jnp.asarray(tok, jnp.int32), jnp.asarray(lens))
    tkcs = [torch.from_numpy(a.copy()) for a in pools[:half]]
    tvcs = [torch.from_numpy(a.copy()) for a in pools[half:]]
    tstep = pl.make_paged_decode_step(cfg, b, bs, torch.from_numpy(tables))
    tlog, tkcs, tvcs = tstep(p, tkcs, tvcs, torch.from_numpy(tok),
                             torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=ATOL, rtol=0)
    for t, j in zip(tkcs + tvcs, list(jkcs) + list(jvcs)):
        np.testing.assert_allclose(t.numpy(), _np(j), atol=1e-5, rtol=0)


def test_kv_write_clamps_the_page_column_like_jax():
    b, bs, w = 2, 4, 2
    tables = np.asarray([[3, 5], [1, 2]], np.int32)
    lens = np.asarray([w * bs, 3], np.int32)       # row 0 past its table
    kc = np.zeros((6, 1, bs, 2), np.float32)
    k = np.arange(b * 2, dtype=np.float32).reshape(b, 1, 1, 2) + 1
    _, jw = jl.make_paged_kv_helpers(b, 0, 1, 2, bs, jnp.asarray(tables))
    jkc, _ = jw(jnp.asarray(kc), jnp.asarray(kc), jnp.asarray(k),
                jnp.asarray(k), jnp.asarray(lens))
    _, tw = pl.make_paged_kv_helpers(b, 0, 1, 2, bs,
                                     torch.from_numpy(tables))
    tkc = torch.from_numpy(kc.copy())
    tw(tkc, tkc.clone(), torch.from_numpy(k), torch.from_numpy(k),
       torch.from_numpy(lens))
    np.testing.assert_array_equal(tkc.numpy(), _np(jkc))
    assert tkc[5, 0, 0].tolist() == [1.0, 2.0]     # clamped to column 1


def test_sample_next_greedy_ties_and_top_k_one():
    logits = np.asarray([[0.5, 2.0, 2.0, -1.0],
                         [3.0, 3.0, 3.0, 3.0],
                         [-1.0, -2.0, 7.0, 7.0]], np.float32)
    ref = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    t = torch.from_numpy(logits)
    got = pl._sample_next(t, None, False, 1.0, 0, 1.0)
    np.testing.assert_array_equal(got.numpy(), ref)       # first index
    rng = np.random.default_rng(3).standard_normal((5, 50)).astype(
        np.float32)
    g = torch.Generator().manual_seed(0)
    greedy = pl._sample_next(torch.from_numpy(rng), g, False, 1.0, 0, 1.0)
    sampled = pl._sample_next(torch.from_numpy(rng), g, True, 0.7, 1, 0.9)
    assert torch.equal(greedy, sampled)


def test_sampling_is_seeded_by_the_generator():
    x = torch.randn(4, 32)
    a = pl._sample_next(x, torch.Generator().manual_seed(5), True, 1.0, 8,
                        0.9)
    b = pl._sample_next(x, torch.Generator().manual_seed(5), True, 1.0, 8,
                        0.9)
    assert torch.equal(a, b)
    top8 = torch.topk(x, 8, dim=-1).indices
    assert all(int(a[i]) in top8[i].tolist() for i in range(4))


def test_flags_mirror_the_jax_registry():
    from paddle_tpu.framework import flags as jax_flags

    names = ["kv_cache_dtype", "decode_megakernel", "unified_step",
             "prefix_prefill_kernel", "serving_mp", "serving_cp",
             "speculative", "spec_k", "spec_adaptive"]
    assert port_flags.get_flags(names) == jax_flags.get_flags(names)
    port_flags.set_flags({"serving_mp": 2})
    try:
        assert port_flags.flag("serving_mp") == 2
        assert jax_flags.flag("serving_mp") == 1     # separate registries
    finally:
        port_flags.set_flags({"serving_mp": 1})
    with pytest.raises(KeyError):
        port_flags.set_flags({"no_such_flag": 1})


def _flag_help(path, name):
    """The help text a `define_flag(name, ...)` call in `path` registers
    (neither registry keeps it at run time)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and getattr(node.func, "id", None) == "define_flag" \
                and ast.literal_eval(node.args[0]) == name:
            return ast.literal_eval(node.args[2])
    raise KeyError(name)


def test_decode_megakernel_flag_help_is_the_jax_help():
    """FLAGS_decode_megakernel's help is the JAX registry's, with the
    Pallas wording in kernel terms (the stale "not ported yet" is gone),
    and the fleet flags carry the JAX names, defaults and help."""
    import paddle_tpu.framework.flags as jf
    import paddle_tpu_torch.framework.flags as pf

    jax_help = _flag_help(jf.__file__, "decode_megakernel")
    port_help = _flag_help(pf.__file__, "decode_megakernel")
    for pallas, kernel in (
            ("in ONE Pallas call per layer", "in ONE kernel launch per layer"),
            ("into the same per-layer call", "into the same per-layer launch"),
            ("as ONE Pallas call whose outermost grid axis walks every "
             "layer", "as ONE kernel launch that walks every layer")):
        assert pallas in jax_help
        jax_help = jax_help.replace(pallas, kernel)
    assert port_help == jax_help
    assert "not ported" not in port_help and "Pallas" not in port_help
    for name in ("fleet_heartbeat_s", "router_max_queue"):
        assert _flag_help(pf.__file__, name) == _flag_help(jf.__file__, name)
    assert port_flags.get_flags(["fleet_heartbeat_s", "router_max_queue"]) \
        == jf.get_flags(["fleet_heartbeat_s", "router_max_queue"])


def test_flag_env_alias(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TEST_ALIAS", "on")
    assert port_flags.define_flag("test_alias_flag", False,
                                  env_aliases=("PADDLE_TPU_TEST_ALIAS",))
    monkeypatch.setenv("FLAGS_test_alias_flag", "0")
    assert not port_flags.define_flag(
        "test_alias_flag", False, env_aliases=("PADDLE_TPU_TEST_ALIAS",))


@pytest.mark.parametrize("value,expected", [
    ("auto", False), ("0", False), ("1", True), (False, False)])
def test_resolve_unified_step_auto_is_split(value, expected):
    assert pl.resolve_unified_step(value) is expected


@pytest.mark.parametrize("value,expected", [
    (None, "off"), (False, "off"), (True, "attn"), ("scan", "scan"),
    ("0", "off")])
def test_resolve_decode_megakernel_matches_jax(value, expected):
    assert pl.resolve_decode_megakernel(value) == expected
    if value is not None:
        assert jl.resolve_decode_megakernel(value) == expected


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models, paddle_tpu_torch.kernels, "
            "paddle_tpu_torch.serving.router, "
            "paddle_tpu_torch.serving.fleet, "
            "paddle_tpu_torch.resilience.store, "
            "paddle_tpu_torch.parallel.launch.serve_worker; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_serving_params(LlamaConfig.tiny(), seed=0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_decode_step_refuses_the_contiguous_cache():
    """The contiguous-cache defaults are served since weight-only serving
    ported them; they refuse a cache without a length, and `_mm` refuses
    a weight pair that matches neither the int8 nor the packed int4 K."""
    with pytest.raises(ValueError, match="max_seq"):
        pl._make_decode_step(LlamaConfig.tiny(), 2)
    assert callable(pl._make_decode_step(LlamaConfig.tiny(), 2, max_seq=16))
    with pytest.raises(ValueError, match="does not match"):
        pl._mm(torch.ones(2, 8), (torch.ones(2, 3, dtype=torch.int8),
                                  torch.ones(2)))


class TestPagedKVManager:
    """The allocator is ported whole (host bookkeeping): the JAX
    manager's contract, and the same answers as the JAX manager."""

    def test_refcount_and_double_insert(self):
        m = PagedKVManager(6, block_size=4)
        toks = list(range(8))
        p = m.alloc_pages(2)
        assert m.insert_prefix(toks, p) == 2
        q = m.alloc_pages(2)
        assert m.insert_prefix(toks, q) == 0
        assert m.prefix_lookup(toks) == (2, 0)
        acq = m.acquire_prefix(toks)
        assert acq == p
        m.free(p)
        assert m.n_available == 2
        with pytest.raises(RuntimeError):
            m.alloc_pages(3)
        m.free(acq)
        assert m.n_available == 4 and m.n_cached == 2
        with pytest.raises(ValueError, match="over-release"):
            m.free([p[0]])
        m.free(q)
        with pytest.raises(ValueError, match="double free"):
            m.free([q[0]])

    def test_same_allocation_sequence_as_jax(self):
        ops = [("alloc", 3), ("alloc", 2), ("free", 0), ("alloc", 4),
               ("free", 1), ("alloc", 1)]
        ours, theirs = PagedKVManager(12, 4), jl.PagedKVManager(12, 4)
        held_o, held_t = [], []
        for op, n in ops:
            if op == "alloc":
                held_o.append(ours.alloc_pages(n))
                held_t.append(theirs.alloc_pages(n))
            else:
                ours.free(held_o[n])
                theirs.free(held_t[n])
        assert held_o == held_t and ours.n_free == theirs.n_free

    def test_lru_eviction_keeps_chain_walkable(self):
        m = PagedKVManager(6, block_size=4)
        toks = list(range(8))
        p = m.alloc_pages(2)
        m.insert_prefix(toks, p)
        m.free(p)
        assert len(m.alloc_pages(5)) == 5
        assert m.prefix_evictions == 1
        assert m.prefix_lookup(toks) == (1, 1)

    def test_tables_and_pool_bytes(self):
        m = PagedKVManager(10, block_size=4)
        tbl, lists = m.tables_for_batch([5, 9])
        assert tbl.dtype == torch.int32 and tbl.shape == (2, 3)
        assert tbl[0].tolist() == lists[0] + [lists[0][-1]]
        m.set_pool_geometry(n_layers=2, num_kv_heads=2, head_dim=16)
        assert m.kv_pool_bytes() == 10 * jl.PagedKVManager.page_bytes(
            4, n_layers=2, num_kv_heads=2, head_dim=16)
