"""The port's decode megakernel ladder against the JAX package, on the CPU.

Kernel functions: the same numpy inputs (tests/test_decode_megakernel.py's
`_case` shapes) go through the JAX ``decode_layer_megakernel``,
``decode_layer_megakernel_full`` and ``decode_layers_megakernel`` (their
Pallas kernels in interpret mode, as the JAX tests run them) and through
the port's wrappers on CPU tensors, which run the plain versions. Cases:
GQA group 2, equal heads and MQA; f32 (tol 1e-5) and bf16 (5e-2) hidden
states; weight-only int8 pairs; int8 pools including the slot-0 scale
reset; multi-page tables. The pools are compared page by page: every page
no row commits into byte-identical, each commit page within 1e-5 (f32),
one bf16 step or one int8 step (scales within 1e-3 relative) -- the
committed token comes out of a projection summed in another order.

Ladder: the port's ``plan_megakernel_rung`` walks the JAX ladder on tiny
shapes for every rung under dense, int8, packed int4 and mixed weights
and both pool dtypes, with JAX's reasons. One deliberate divergence: JAX
refuses Llama-3-8B with bf16 dense weights for its TPU VMEM budget, the
port's CUDA kernel takes it.

Engines: the port's engine and the JAX engine serve `_engine_run`'s
churn (tests/test_decode_megakernel.py) on ``tiny()`` with two kv heads,
in f32, at 'scan' over bf16 and int8 pools, 'attn', and 'full' over int8
pools: identical greedy tokens, and pools within one step afterwards.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import decode_megakernel as jmk
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import decode_megakernel as tmk
from paddle_tpu_torch.models import LlamaConfig, decode_params, params_from_jax
from paddle_tpu_torch.models import llama as pl
from paddle_tpu_torch.serving import ContinuousBatchingEngine

BASE, EPS = 10000.0, 1e-6


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _quantize_w(w):
    """weight_only_int8-shaped pair from a dense [K, N] weight (numpy)."""
    sc = np.abs(w).max(axis=0) / 127.0
    sc = np.where(sc > 0, sc, 1.0).astype(np.float32)
    return (np.clip(np.round(w / sc[None, :]), -127, 127).astype(np.int8).T,
            sc)


def _case(nh, nkv, dh=16, H=32, F=64, b=4, bs=8, W=4, seed=0, quant_w=False,
          lens=None, n_layers=1, int8_pools=False, free_rows=0):
    """numpy operands: h [b, 1, H]; per-layer weights (layer axis first);
    a pool of n_layers * (b*W + 1) pages; permuted tables. `free_rows`
    last rows are retired: lens 0, every table column on page 0."""
    rng = np.random.default_rng(seed)
    pages = b * W + 1
    h = (rng.normal(size=(b, 1, H)) * 0.5).astype(np.float32)
    norms = [(rng.normal(size=(n_layers, H)) * 0.1 + 1.0).astype(np.float32)
             for _ in range(2)]
    shapes = ((H, nh * dh), (H, nkv * dh), (H, nkv * dh), (nh * dh, H),
              (H, F), (H, F), (F, H))
    mats = []
    for s in shapes:
        per = [(rng.normal(size=s) * 0.05).astype(np.float32)
               for _ in range(n_layers)]
        if quant_w:
            pairs = [_quantize_w(w) for w in per]
            mats.append((np.stack([p[0] for p in pairs]),
                         np.stack([p[1] for p in pairs])))
        else:
            mats.append(np.stack(per))
    pools = [rng.normal(size=(n_layers * pages, nkv, bs, dh)).astype(
        np.float32) for _ in range(2)]
    tables = (rng.permutation(pages - 1)[:b * W].reshape(b, W) + 1).astype(
        np.int32)
    if lens is None:
        lens = [3, bs * W - 1, 0, 17][:b]
    lens = np.asarray(lens, np.int32)
    if free_rows:
        tables[b - free_rows:] = 0
        lens[b - free_rows:] = 0
    return dict(h=h, lens=lens, tables=tables, norms=norms, mats=mats,
                pools=pools, int8_pools=int8_pools, n_layers=n_layers)


def _jax_ops(c, dtype):
    """(h, lens, tables, stacked weights [L, ...], pool args, scale kw)."""
    def w(x):
        if isinstance(x, tuple):
            return (jnp.asarray(x[0]), jnp.asarray(x[1]))
        return jnp.asarray(x, dtype)

    weights = [w(c["norms"][0]), w(c["norms"][1])] + [w(m) for m in c["mats"]]
    pools = [jnp.asarray(p, dtype) for p in c["pools"]]
    kw = {}
    if c["int8_pools"]:
        (kq, ks), (vq, vs) = (jl.quantize_kv_pages(p) for p in pools)
        pools, kw = [kq, vq], dict(k_scale=ks, v_scale=vs)
    return (jnp.asarray(c["h"], dtype), jnp.asarray(c["lens"]),
            jnp.asarray(c["tables"]), weights, pools, kw)


def _to_torch(x, dtype):
    if isinstance(x, tuple):
        return tuple(_to_torch(a, None) for a in x)
    a = np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)
    t = torch.from_numpy(a.copy())
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _torch_ops(jops, dtype):
    h, lens, tables, weights, pools, kw = jops
    return (_to_torch(h, dtype), _to_torch(lens, None),
            _to_torch(tables, None), [_to_torch(w, dtype) for w in weights],
            [_to_torch(p, dtype) for p in pools],
            {k: _to_torch(v, None) for k, v in kw.items()})


def _layer0(w):
    return (w[0][0], w[1][0]) if isinstance(w, tuple) else w[0]


def _call(mod, rung, ops):
    """Call rung `rung` of module `mod` (JAX or port) on `ops`; returns
    (h_out, k pool, v pool, k scale or None, v scale or None)."""
    h, lens, tables, weights, pools, kw = ops
    w_in, w_post, wq, wk, wv, wo, wg, wu, wd = weights
    kw = dict(kw, rope_base=BASE, eps=EPS)
    if rung == "attn":
        out = mod.decode_layer_megakernel(
            h, lens, tables, *(_layer0(w) for w in (w_in, wq, wk, wv, wo)),
            *pools, **kw)
    elif rung == "full":
        out = mod.decode_layer_megakernel_full(
            h, lens, tables, *(_layer0(w) for w in weights), *pools, **kw)
    else:
        out = mod.decode_layers_megakernel(
            h, lens, tables, *weights, *pools,
            n_layers=weights[0].shape[0], **kw)
    if isinstance(out[1], tuple):
        return out[0], out[1][0], out[2][0], out[1][1], out[2][1]
    return out[0], out[1], out[2], None, None


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _commit_pages(c):
    """Pool rows the step commits into, and those more than one row
    commits into (every retired row aims at page 0)."""
    b, W = c["tables"].shape
    bs = c["pools"][0].shape[2]
    pages = c["pools"][0].shape[0] // c["n_layers"]
    hits = {}
    for r in range(b):
        col = min(int(c["lens"][r]) // bs, W - 1)
        for l in range(c["n_layers"]):
            p = l * pages + int(c["tables"][r, col])
            hits[p] = hits.get(p, 0) + 1
    return set(hits), {p for p, n in hits.items() if n > 1}


def _check_pools(c, got, want, dtype):
    """Pages no row commits into: byte-identical. Pages one row commits
    into: within one step (see the module docstring). Pages more than one
    row commits into are left out: retired rows all commit into the
    scratch page, where either framework may keep any of the writes and
    nothing reads it."""
    commits, shared = _commit_pages(c)
    for g, w in ((got[1], want[1]), (got[2], want[2])):
        g, w = _np(g), _np(w)
        for p in range(g.shape[0]):
            if p in shared:
                continue
            if p not in commits:
                np.testing.assert_array_equal(g[p], w[p])
            elif c["int8_pools"]:
                assert np.abs(g[p].astype(np.int32)
                              - w[p].astype(np.int32)).max() <= 1
            elif dtype == torch.float32:
                np.testing.assert_allclose(g[p], w[p], atol=1e-5, rtol=0)
            else:
                np.testing.assert_allclose(g[p], w[p], rtol=2.0 ** -7,
                                           atol=2.0 ** -7)
    if c["int8_pools"]:
        keep = [p for p in range(_np(got[3]).shape[0]) if p not in shared]
        for g, w in ((got[3], want[3]), (got[4], want[4])):
            np.testing.assert_allclose(_np(g)[keep], _np(w)[keep],
                                       rtol=1e-3, atol=1e-9)


DT = {"f32": (jnp.float32, torch.float32, 1e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}

CASES = {
    # rung, dtype, case kwargs
    "attn-group2-f32": ("attn", "f32", dict(nh=4, nkv=2)),
    "attn-equal-heads-f32": ("attn", "f32", dict(nh=4, nkv=4)),
    "attn-mqa-f32": ("attn", "f32", dict(nh=4, nkv=1)),
    "attn-bf16": ("attn", "bf16", dict(nh=4, nkv=2)),
    "attn-int8w-bf16": ("attn", "bf16", dict(nh=4, nkv=2, quant_w=True)),
    "attn-multipage-w8-f32": ("attn", "f32",
                              dict(nh=4, nkv=2, W=8, lens=[3, 63, 0, 40])),
    "attn-int8pools": ("attn", "bf16", dict(nh=4, nkv=2, int8_pools=True)),
    "attn-int8pools-int8w-equal": ("attn", "bf16",
                                   dict(nh=4, nkv=4, quant_w=True,
                                        int8_pools=True)),
    "attn-int8pools-slot0-reset": ("attn", "bf16",
                                   dict(nh=4, nkv=2, int8_pools=True,
                                        lens=[8, 16, 0, 24], seed=3)),
    "attn-retired-rows-f32": ("attn", "f32",
                              dict(nh=4, nkv=2, b=5, lens=[3, 31, 9, 0, 0],
                                   free_rows=2)),
    "full-f32": ("full", "f32", dict(nh=4, nkv=2)),
    "full-bf16": ("full", "bf16", dict(nh=4, nkv=2)),
    "full-int8w-bf16": ("full", "bf16", dict(nh=4, nkv=2, quant_w=True)),
    "full-mqa-int8pools": ("full", "bf16",
                           dict(nh=4, nkv=1, int8_pools=True)),
    "scan-L2-bf16": ("scan", "bf16", dict(nh=4, nkv=2, n_layers=2)),
    "scan-L2-int8w-int8pools": ("scan", "bf16",
                                dict(nh=4, nkv=2, n_layers=2, quant_w=True,
                                     int8_pools=True, W=3,
                                     lens=[8, 23, 0, 5])),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_megakernel_matches_jax(name):
    rung, dt, kw = CASES[name]
    jdt, tdt, tol = DT[dt]
    c = _case(**kw)
    jops = _jax_ops(c, jdt)
    tops = _torch_ops(jops, tdt)
    _build.reset_launch_counts()
    got = _call(tmk, rung, tops)
    assert not any(_build.launch_counts().values())   # CPU: plain versions
    want = jax.jit(lambda *a: _call(jmk, rung, a))(*jops)
    assert got[0].dtype == tdt and tuple(got[0].shape) == tuple(want[0].shape)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=tol, rtol=0)
    _check_pools(c, got, want, tdt)


@pytest.mark.parametrize("int8_pools", [False, True], ids=["bf16", "int8"])
def test_scan_equals_per_layer_full_chain_bitwise(int8_pools):
    """The port's scan at L = 2 is its per-layer full chain, bitwise:
    hidden states, every pool byte and every scale."""
    c = _case(nh=4, nkv=2, n_layers=2, int8_pools=int8_pools)
    h, lens, tables, weights, pools, kw = _torch_ops(
        _jax_ops(c, jnp.bfloat16), torch.bfloat16)
    scan_pools = [p.clone() for p in pools]
    scan_kw = {k: v.clone() for k, v in kw.items()}
    hs = _call(tmk, "scan", (h, lens, tables, weights, scan_pools,
                             scan_kw))[0]
    stride = pools[0].shape[0] // 2
    hc = h
    for i in range(2):
        sl = slice(i * stride, (i + 1) * stride)
        layer = [(w[0][i:i + 1], w[1][i:i + 1]) if isinstance(w, tuple)
                 else w[i:i + 1] for w in weights]
        lp = [p[sl].clone() for p in pools]
        lkw = {k: v[sl].clone() for k, v in kw.items()}
        hc = _call(tmk, "full", (hc, lens, tables, layer, lp, lkw))[0]
        for a, b_ in zip(lp, scan_pools):
            assert torch.equal(a, b_[sl])
        for k in lkw:
            assert torch.equal(lkw[k], scan_kw[k][sl])
    assert torch.equal(hs, hc)


def test_tp_seam_and_unsupported_operands_raise():
    """The tensor-parallel modes refuse what JAX refuses (quantize_out
    without residual=False, H not a multiple of 128) with ValueError;
    packed int4 raises ValueError as in JAX."""
    c = _case(nh=4, nkv=2)
    h, lens, tables, weights, pools, _ = _torch_ops(
        _jax_ops(c, jnp.bfloat16), torch.bfloat16)
    one = [_layer0(w) for w in weights]
    args = (h, lens, tables, one[0], *one[2:6], *pools)
    with pytest.raises(ValueError, match="requires residual=False"):
        tmk.decode_layer_megakernel(*args, quantize_out=True)
    with pytest.raises(ValueError, match="lane-aligned H"):
        tmk.decode_layer_megakernel(*args, residual=False, quantize_out=True)
    part = tmk.decode_layer_megakernel(*args, residual=False)[0]
    assert part.dtype == torch.float32 and tuple(part.shape) == (4, 1, 32)
    wq8 = tuple(torch.from_numpy(a) for a in _quantize_w(
        np.asarray(one[2].float().numpy())))
    packed = (wq8[0][:, ::2].contiguous(), wq8[1])
    with pytest.raises(ValueError, match="packed int4"):
        tmk.decode_layer_megakernel(h, lens, tables, one[0], packed,
                                    *one[3:6], *pools)


# ---------------------------------------------------------------------------
# the stacked layout and the ladder
# ---------------------------------------------------------------------------

def _setup(nkv=2, seed=21):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=nkv)
    paddle.seed(seed)
    jm = JaxModel(jcfg)
    raw = dict(jm.raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=nkv)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, jm, raw, cfg, p


@pytest.fixture(scope="module")
def model():
    return _setup()


def test_stacked_layout_matches_jax(model):
    """stack_decode_layer_params, _lw and _layer_kv against JAX, over
    dense and int8-pair params."""
    jcfg, jm, raw, cfg, p = model
    L = cfg.num_hidden_layers
    for jp, tp in ((raw, p), (jm._decode_params(raw, "weight_only_int8"),
                              decode_params(p, "weight_only_int8"))):
        jst = jl.stack_decode_layer_params(dict(jp), L)
        tst = pl.stack_decode_layer_params(tp, L)
        assert sorted(jst) == sorted(tst)
        assert "llama.layers.0.self_attn.q_proj.weight" not in tst
        assert "llama.layers.0.self_attn.q_proj.weight" in tp  # untouched
        for name in pl.STACKED_LAYER_NAMES:
            for i in range(L):
                a, b_ = pl._lw(tst, i, name), jl._lw(jst, i, name)
                for x, y in zip(a if isinstance(a, tuple) else (a,),
                                b_ if isinstance(b_, tuple) else (b_,)):
                    np.testing.assert_array_equal(_np(x), np.asarray(y))
        st = tst[pl.STACKED_PREFIX + "self_attn.q_proj.weight"]
        st = st[0] if isinstance(st, tuple) else st
        view = pl._lw(tst, 1, "self_attn.q_proj.weight")
        view = view[0] if isinstance(view, tuple) else view
        assert view.data_ptr() == st[1].data_ptr()          # a view
    pools = [torch.zeros(3 * L, 2, 8, 16)]
    for lists in ([pools[0]] * L, pools):
        for i in range(L):
            kc, _, off = pl._layer_kv(lists, lists, i, L)
            jkc, _, joff = jl._layer_kv([jnp.asarray(x.numpy()) for x in
                                         lists], lists, i, L)
            assert off == joff
    q8 = [(torch.zeros(3 * L, 2, 8, 16, dtype=torch.int8),
           torch.zeros(3 * L, 2))]
    assert pl._layer_kv(q8, q8, 1, L)[2] == 3


def _plan_params(jp, tp, L, stacked):
    """(JAX, port) decode-params views: the real tiny arrays, stacked or
    not."""
    if stacked:
        return (jl.stack_decode_layer_params(dict(jp), L),
                pl.stack_decode_layer_params(tp, L))
    return jp, tp


def _mixed(params, quant_fn, names):
    out = dict(params)
    for k in list(out):
        if any(k.endswith(n) for n in names):
            out[k] = quant_fn(k, out[k])
    return out


WEIGHTS = ["dense", "int8", "int4", "mixed-attn", "mixed-mlp"]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_plan_matches_jax_on_tiny_shapes(model, weights, kv):
    """Every requested rung, over the engine's operand shapes (2 slots,
    a layer-major pool): the port plans the JAX rung with JAX's reasons."""
    jcfg, jm, raw, cfg, p = model
    L = cfg.num_hidden_layers
    if weights in ("int8", "int4"):
        quant = f"weight_only_{weights}"
        jp, tp = jm._decode_params(raw, quant), decode_params(p, quant)
    elif weights == "dense":
        jp, tp = raw, p
    else:
        names = ("q_proj.weight",) if weights == "mixed-attn" \
            else ("gate_proj.weight", "up_proj.weight", "down_proj.weight")
        jq8 = jm._decode_params(raw, "weight_only_int8")
        tq8 = decode_params(p, "weight_only_int8")
        jp = _mixed(raw, lambda k, v: jq8[k], names)
        tp = _mixed(p, lambda k, v: tq8[k], names)
    shape = (9 * L, cfg.num_key_value_heads, 8, cfg.head_dim)
    if kv == "int8":
        jpool = (jax.ShapeDtypeStruct(shape, jnp.int8),
                 jax.ShapeDtypeStruct(shape[:2], jnp.float32))
        tpool = (torch.empty(shape, dtype=torch.int8, device="meta"),
                 torch.empty(shape[:2], device="meta"))
    else:
        jpool = jax.ShapeDtypeStruct(shape, jnp.float32)
        tpool = torch.empty(shape, device="meta")
    jtbl = jax.ShapeDtypeStruct((2, 4), jnp.int32)
    ttbl = torch.empty((2, 4), dtype=torch.int32, device="meta")
    for stacked in (False, True):
        jpp, tpp = _plan_params(jp, tp, L, stacked)
        for mode in ("attn", "full", "scan"):
            want = jl.plan_megakernel_rung(mode, jcfg, 2, jpp, [jpool],
                                           [jpool], jtbl)
            got = pl.plan_megakernel_rung(mode, cfg, 2, tpp, [tpool],
                                          [tpool], ttbl)
            assert got == want, (mode, stacked)
    expect = {"dense": "scan", "int8": "scan", "int4": "off",
              "mixed-attn": "off", "mixed-mlp": "attn"}[weights]
    assert got[0] == expect


def _llama3_views(quant):
    """(JAX ShapeDtypeStruct, port meta) decode params of Llama-3-8B
    enough to plan: the embedding, layer 0 and the stacked entries."""
    cfg = LlamaConfig.llama3_8b()
    L = cfg.num_hidden_layers
    jv, tv = {}, {}

    def put(key, shape, lead=()):
        if quant and key.endswith("_proj.weight"):
            n_in, n_out = shape
            spec = [(lead + (n_out, n_in), "int8"), (lead + (n_out,),
                                                     "float32")]
            jv[key] = tuple(jax.ShapeDtypeStruct(s, d) for s, d in spec)
            tv[key] = tuple(torch.empty(s, dtype=getattr(torch, d),
                                        device="meta") for s, d in spec)
        else:
            jv[key] = jax.ShapeDtypeStruct(lead + shape, jnp.bfloat16)
            tv[key] = torch.empty(lead + shape, dtype=torch.bfloat16,
                                  device="meta")

    for name, shape in pl._layer_shapes(cfg).items():
        for key, lead in ((f"llama.layers.0.{name}", ()),
                          (pl.STACKED_PREFIX + name, (L,))):
            put(key, shape, lead)
    put("llama.embed_tokens.weight", (cfg.vocab_size, cfg.hidden_size))
    return cfg, jv, tv


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8w"])
def test_llama3_8b_plan_and_the_vmem_divergence(quant):
    """Llama-3-8B, 8 slots, block 64, 17 table columns. With int8 pairs
    both plan 'scan'. With bf16 dense weights JAX plans 'off': every rung
    refuses for the TPU's scoped VMEM budget (constraints.py:33), a limit
    of the TPU alone. The port's CUDA kernel streams weights through the
    GEMV a column tile at a time, so its limit is per-block shared memory
    (~40 KB here), and it plans 'scan' -- on the card too."""
    cfg, jv, tv = _llama3_views(quant)
    jcfg = JaxConfig.llama3_8b()
    L, rows = cfg.num_hidden_layers, 32 * 137
    shape = (rows, 8, 64, 128)
    jpool = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    tpool = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    jtbl = jax.ShapeDtypeStruct((8, 17), jnp.int32)
    ttbl = torch.empty((8, 17), dtype=torch.int32, device="meta")
    want = jl.plan_megakernel_rung("scan", jcfg, 8, jv, [jpool], [jpool],
                                   jtbl)
    for on_card in (False, True):
        got = pl.plan_megakernel_rung("scan", cfg, 8, tv, [tpool], [tpool],
                                      ttbl, on_card=on_card)
        assert got == ("scan", [])
    if quant:
        assert want == ("scan", [])
    else:
        assert want[0] == "off"
        assert all("VMEM budget" in r for _, r in want[1])


def test_card_limits_refuse_with_the_cards_words():
    """Only the card's own limits refuse on the card: more rows than the
    kernel takes, or float16 activations."""
    cfg, _, tv = _llama3_views(True)
    tpool = torch.empty((32 * 9, 8, 64, 128), dtype=torch.bfloat16,
                        device="meta")
    ttbl = torch.empty((32, 4), dtype=torch.int32, device="meta")
    rung, refusals = pl.plan_megakernel_rung("scan", cfg, 32, tv, [tpool],
                                             [tpool], ttbl, on_card=True)
    assert rung == "off" and len(refusals) == 3
    assert all("card limit" in r and "16 rows" in r for _, r in refusals)
    assert pl.plan_megakernel_rung("scan", cfg, 32, tv, [tpool], [tpool],
                                   ttbl, on_card=False)[0] == "scan"


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

KW = dict(slots=2, prompt_bucket=8, max_prompt_len=16, max_new_tokens=6,
          block_size=8, steps_per_sync=3, prefill_batch=1, prefix_cache=True)
RUNS = [("scan", "bf16", False), ("scan", "int8", False),
        ("attn", "bf16", False), ("full", "int8", False),
        ("scan", "bf16", True)]


def _prompts(vocab):
    """tests/test_decode_megakernel.py `_engine_run`'s traffic: two rows
    sharing an 8-token head, five cold rows, max_new 2..5."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, vocab, (8,)).tolist()
    return ([shared + rng.integers(1, vocab, (n,)).tolist() for n in (3, 5)]
            + [rng.integers(1, vocab, (n,)).tolist()
               for n in (2, 9, 14, 4, 11)])


def _serve(eng, prompts):
    for i, pr in enumerate(prompts):
        eng.add_request(pr, max_new=2 + i % 4)
    eng.run(max_iters=300)
    assert len(eng.finished) == len(prompts)
    return {r.req_id: list(r.tokens) for r in eng.finished}


@pytest.fixture(scope="module")
def engines(model):
    """Each JAX engine is built and served once for the module."""
    jcfg, _, raw, cfg, p = model
    prompts = _prompts(cfg.vocab_size)
    out = {}
    for mk, kv, unified in RUNS:
        kw = dict(KW, kv_cache_dtype=kv, decode_megakernel=mk,
                  unified_step=unified)
        jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, **kw)
        teng = ContinuousBatchingEngine(cfg, p, device="cpu",
                                        dtype=torch.float32, **kw)
        out[(mk, kv, unified)] = (_serve(jeng, prompts), jeng,
                                  _serve(teng, prompts), teng)
    return out


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_engine_tokens_match_jax(engines, run):
    theirs, jeng, ours, teng = engines[run]
    assert ours == theirs
    assert teng.megakernel_rung == jeng.megakernel_rung == run[0]
    m = teng.metrics()
    assert m["megakernel_rung"] == run[0]
    assert m["decode_megakernel"] == run[0]
    for name in ("prefill_calls", "device_steps", "prefix_hit_tokens",
                 "prefill_chunks"):
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.prefix_hit_tokens > 0
    assert len(teng.kcs) == (1 if run[0] == "scan"
                             else teng.cfg.num_hidden_layers)
    assert teng.mgr.n_available == teng.mgr.max_pages - 1     # drained


@pytest.mark.parametrize("run", RUNS[:2], ids=["scan-bf16", "scan-int8"])
def test_scan_engine_pools_match_jax(engines, run):
    """After the churn, the layer-major pool against the JAX engine's:
    every page but each layer's scratch page within 1e-5 (f32 pools) or
    one int8 step, scales within 1e-5 relative."""
    _, jeng, _, teng = engines[run]
    stride = teng.mgr.max_pages
    keep = np.arange(stride * teng.cfg.num_hidden_layers) % stride \
        != teng.scratch_page
    for t, j in ((teng.kcs[0], jeng.kcs[0]), (teng.vcs[0], jeng.vcs[0])):
        if isinstance(t, tuple):
            tp, jp = t[0].numpy()[keep], np.asarray(j[0])[keep]
            assert np.abs(tp.astype(np.int32) - jp.astype(np.int32)).max() \
                <= 1
            np.testing.assert_allclose(t[1].numpy()[keep],
                                       np.asarray(j[1])[keep], rtol=1e-5,
                                       atol=0)
        else:
            np.testing.assert_allclose(t.numpy()[keep], np.asarray(j)[keep],
                                       atol=1e-5, rtol=0)


def test_int4_engine_steps_down_with_one_warning_per_rung(model):
    """Packed int4 weights: 'scan' refuses, then 'full', then 'attn', each
    warned once at build; the engine serves the multi-kernel path with the
    same tokens as 'off'."""
    _, _, _, cfg, p = model
    p4 = decode_params(p, "weight_only_int4")
    prompts = _prompts(cfg.vocab_size)[:3]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = ContinuousBatchingEngine(cfg, p4, device="cpu",
                                       dtype=torch.float32,
                                       decode_megakernel="scan", **KW)
    msgs = [str(w.message) for w in rec if "decode_megakernel" in
            str(w.message)]
    assert len(msgs) == 3
    for rung, msg in zip(("scan", "full", "attn"), msgs):
        assert f"rung '{rung}'" in msg and "packed int4" in msg
        assert "multi-kernel path" in msg
    assert eng.megakernel_rung == "off" and len(eng.kcs) == 2
    off = ContinuousBatchingEngine(cfg, p4, device="cpu",
                                   dtype=torch.float32, **KW)
    assert _serve(eng, prompts) == _serve(off, prompts)


def test_fallback_seam_picks_the_strongest_rung(model):
    """_megakernel_or_fallback_step: packed int4 warns per rung and
    returns the multi-kernel step; dense params at 'attn' return a fused
    step whose logits match the multi-kernel step's on an empty cache."""
    _, _, _, cfg, p = model
    b, bs = 2, 8
    tables = torch.tensor([[1], [2]], dtype=torch.int32)

    def pools():
        return [torch.zeros(3, 2, bs, cfg.head_dim)
                for _ in range(cfg.num_hidden_layers)]

    base = pl.make_paged_decode_step(cfg, b, bs, tables)
    kc, vc = pools(), pools()
    with pytest.warns(UserWarning, match="rung 'attn'"):
        step = pl._megakernel_or_fallback_step(
            cfg, b, tables, decode_params(p, "weight_only_int4"), kc, vc,
            base)
    assert step is base
    step = pl._megakernel_or_fallback_step(cfg, b, tables, p, kc, vc, base)
    assert step is not base
    tok = torch.tensor([[5], [9]])
    lens = torch.zeros(b, dtype=torch.int32)
    fused = step(p, kc, vc, tok, lens)[0]
    kc2, vc2 = pools(), pools()
    torch.testing.assert_close(fused, base(p, kc2, vc2, tok, lens)[0],
                               atol=1e-4, rtol=1e-4)
    for a, c in zip(kc + vc, kc2 + vc2):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=0)


def test_stacked_pools_refuse_the_multi_kernel_decode_step(model):
    _, _, _, cfg, p = model
    b, L = 2, cfg.num_hidden_layers
    tables = torch.ones(b, 1, dtype=torch.int32)
    pool = [torch.zeros(3 * L, 2, 8, cfg.head_dim)]
    step = pl.make_paged_decode_step(cfg, b, 8, tables)
    with pytest.raises(ValueError, match="scan megakernel"):
        step(p, pool, list(pool), torch.ones(b, 1, dtype=torch.long),
             torch.zeros(b, dtype=torch.int32))
