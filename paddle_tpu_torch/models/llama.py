"""Llama decoder family, serving path (counterpart of
paddle_tpu/models/llama.py).

What is here:

- ``LlamaConfig`` with the JAX package's stock sizes;
- the inference forward as ``nn.Module``s (``LlamaForCausalLM`` and its
  parts), used as the plain oracle the serving path is checked against;
- the functional serving pieces over a decode-params dict
  (``_make_prefill``, ``_make_decode_step``, ``make_paged_kv_helpers``,
  ``PagedKVManager``), which ``serving.engine`` drives.

Weight layout: every projection keeps paddle's ``Linear`` layout
[in_features, out_features] (``y = x @ w``), in the decode-params dict and
in the modules alike, so JAX weights carry across without a transpose and
the modules share storage with the dict. Keys are the JAX package's
(``llama.layers.{i}.self_attn.q_proj.weight`` ...).

The kernel wrappers (``rms_norm``, ``flash_attention``,
``paged_decode_attention``) launch the CUDA kernels for CUDA tensors and
run their plain versions for CPU tensors. ``LlamaForCausalLM(...,
use_kernels=False)`` runs the plain versions on any device, which is how
the card checks the kernels end to end.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, namedtuple
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..framework.flags import flag as _flag
from ..kernels.decode_attention import paged_decode_attention
from ..kernels.flash_attention import (flash_attention,
                                       flash_attention_reference)
from ..kernels.rms_norm import rms_norm as _k_rms
from ..kernels.rms_norm import rms_norm_reference
from ..kernels.rope import apply_rotary_emb


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def _stock(defaults: dict, over: dict) -> "LlamaConfig":
        return LlamaConfig(**{**defaults, **over})

    @staticmethod
    def llama2_7b(**over) -> "LlamaConfig":
        return LlamaConfig._stock(
            dict(hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32), over)

    @staticmethod
    def llama2_13b(**over) -> "LlamaConfig":
        return LlamaConfig._stock(
            dict(hidden_size=5120, intermediate_size=13824,
                 num_hidden_layers=40, num_attention_heads=40), over)

    @staticmethod
    def llama3_8b(**over) -> "LlamaConfig":
        # the modern GQA ratio (32:8) + 128k vocab + long-rope base
        return LlamaConfig._stock(
            dict(vocab_size=128256, hidden_size=4096,
                 intermediate_size=14336, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=8,
                 rope_theta=500000.0), over)

    @staticmethod
    def llama_1b(**over) -> "LlamaConfig":
        return LlamaConfig._stock(
            dict(hidden_size=2048, intermediate_size=5504,
                 num_hidden_layers=16, num_attention_heads=16), over)

    @staticmethod
    def tiny(**over) -> "LlamaConfig":
        return LlamaConfig._stock(
            dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=64), over)


# ---------------------------------------------------------------------------
# weights: the decode-params dict
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    h, dh = cfg.hidden_size, cfg.head_dim
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    im = cfg.intermediate_size
    return {
        "input_layernorm.weight": (h,),
        "post_attention_layernorm.weight": (h,),
        "self_attn.q_proj.weight": (h, nh * dh),
        "self_attn.k_proj.weight": (h, nkv * dh),
        "self_attn.v_proj.weight": (h, nkv * dh),
        "self_attn.o_proj.weight": (nh * dh, h),
        "mlp.gate_proj.weight": (h, im),
        "mlp.up_proj.weight": (h, im),
        "mlp.down_proj.weight": (im, h),
    }


def param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Every decode-params key with its shape ([in, out] projections)."""
    out = {"llama.embed_tokens.weight": (cfg.vocab_size, cfg.hidden_size)}
    for i in range(cfg.num_hidden_layers):
        for name, shape in _layer_shapes(cfg).items():
            out[f"llama.layers.{i}.{name}"] = shape
    out["llama.norm.weight"] = (cfg.hidden_size,)
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = (cfg.hidden_size, cfg.vocab_size)
    return out


def params_from_jax(np_params: dict, device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX ``raw_state()`` / ``_decode_params`` dict (values as numpy
    arrays, same keys) -> the port's decode-params dict on `device`.
    Layouts are unchanged ([in, out] projections); `dtype` casts every
    floating weight. Quantized (int, scale) pairs are refused."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        if isinstance(arr, tuple):
            raise NotImplementedError(
                f"{name}: weight-only quantized serving params are not "
                "ported yet (ROADMAP.md: int4_matmul)")
        t = torch.from_numpy(np.array(arr))  # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(dev)
    return out


def init_serving_params(cfg: LlamaConfig, seed: int = 0, device=None,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random serving weights (normal, std 0.02; norms at 1) made weight
    by weight on `device` from `seed` -- the full-width model never
    passes through host memory. Stands in for a checkpoint."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("norm.weight"):
            out[name] = torch.ones(shape, dtype=dtype, device=dev)
        else:
            w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            out[name] = w.mul_(0.02)
    return out


# ---------------------------------------------------------------------------
# modules: the inference forward (the serving path's plain oracle)
# ---------------------------------------------------------------------------

# the two kernel-backed operations a forward needs, picked once per model
_Ops = namedtuple("_Ops", "rms_norm flash_attention")
KERNEL_OPS = _Ops(_k_rms, flash_attention)
PLAIN_OPS = _Ops(rms_norm_reference, flash_attention_reference)


def _meta(*shape) -> nn.Parameter:
    # parameters are placeholders until load_params / load_jax_params:
    # an 8B model must never be materialized by the constructor
    return nn.Parameter(torch.empty(shape, device="meta"),
                        requires_grad=False)


class _Linear(nn.Module):
    """paddle ``Linear`` without bias: weight [in, out], y = x @ w."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = _meta(n_in, n_out)

    def forward(self, x):
        return _mm(x, self.weight)


class LlamaRMSNorm(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.variance_epsilon = config.rms_norm_eps
        self.weight = _meta(config.hidden_size)

    def forward(self, x, ops=KERNEL_OPS):
        return ops.rms_norm(x, self.weight, self.variance_epsilon)


class LlamaAttention(nn.Module):
    """Causal self-attention (the JAX module's non-mesh, no-cache
    branch): q/k/v projections, rope at `position_ids`, flash attention,
    o projection."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        nh, nkv, dh = (config.num_attention_heads,
                       config.num_key_value_heads, config.head_dim)
        self.num_heads, self.num_kv_heads, self.head_dim = nh, nkv, dh
        self.q_proj = _Linear(h, nh * dh)
        self.k_proj = _Linear(h, nkv * dh)
        self.v_proj = _Linear(h, nkv * dh)
        self.o_proj = _Linear(nh * dh, h)

    def forward(self, hidden, position_ids, ops=KERNEL_OPS):
        b, s, _ = hidden.shape
        q = self.q_proj(hidden).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).reshape(b, s, self.num_kv_heads,
                                        self.head_dim)
        v = self.v_proj(hidden).reshape(b, s, self.num_kv_heads,
                                        self.head_dim)
        q, k = apply_rotary_emb(q, k, position_ids=position_ids,
                                base=self.config.rope_theta)
        out = ops.flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _Linear(h, i)
        self.up_proj = _Linear(h, i)
        self.down_proj = _Linear(i, h)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = LlamaRMSNorm(config)
        self.post_attention_layernorm = LlamaRMSNorm(config)

    def forward(self, hidden, position_ids, ops=KERNEL_OPS):
        hidden = hidden + self.self_attn(
            self.input_layernorm(hidden, ops), position_ids, ops)
        return hidden + self.mlp(self.post_attention_layernorm(hidden, ops))


class _Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = _meta(n, dim)

    def forward(self, ids):
        return self.weight[ids]


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = _Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config)

    def forward(self, input_ids, position_offset: int = 0, ops=KERNEL_OPS):
        s = input_ids.shape[1]
        pos = torch.arange(position_offset, position_offset + s,
                           device=input_ids.device)
        hidden = self.embed_tokens(input_ids)
        for layer in self.layers:
            hidden = layer(hidden, pos, ops)
        return self.norm(hidden, ops)


class LlamaForCausalLM(nn.Module):
    """Inference forward over [B, S] token ids -> [B, S, vocab] logits.

    Parameters are placeholders until ``load_params`` (the port's
    decode-params dict, shared without a copy) or ``load_jax_params``
    (the JAX package's dict as numpy arrays). `use_kernels=False` runs
    the plain PyTorch versions of the kernels on any device."""

    def __init__(self, config: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.config = config
        self.use_kernels = use_kernels
        self.llama = LlamaModel(config)
        if not config.tie_word_embeddings:
            self.lm_head = _Linear(config.hidden_size, config.vocab_size)

    def forward(self, input_ids, position_offset: int = 0):
        ops = KERNEL_OPS if self.use_kernels else PLAIN_OPS
        hidden = self.llama(input_ids, position_offset, ops)
        if self.config.tie_word_embeddings:
            return hidden @ self.llama.embed_tokens.weight.T
        return self.lm_head(hidden)

    def load_params(self, params: dict) -> "LlamaForCausalLM":
        """Point every parameter at the tensor of the same key in a
        decode-params dict (no copy: the module and the dict share
        storage)."""
        for name, p in list(self.named_parameters()):
            t = params[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: expected {list(p.shape)}, got "
                                 f"{list(t.shape)}")
            path, leaf = name.rsplit(".", 1)
            setattr(self.get_submodule(path), leaf,
                    nn.Parameter(t, requires_grad=False))
        return self

    def load_jax_params(self, np_params: dict, device=None,
                        dtype: Optional[torch.dtype] = None
                        ) -> "LlamaForCausalLM":
        """Fill the module from the JAX ``raw_state()`` dict (numpy)."""
        return self.load_params(params_from_jax(np_params, device, dtype))


# ---------------------------------------------------------------------------
# functional serving path over the decode-params dict
# ---------------------------------------------------------------------------

def _mm(x, w):
    """Matmul against a dense decode weight [K, N]."""
    if isinstance(w, tuple):
        raise NotImplementedError(
            "weight-only quantized projections are not ported yet "
            "(ROADMAP.md: int4_matmul)")
    return x @ w


def _sample_next(logits, generator: Optional[torch.Generator], do_sample,
                 temperature, top_k, top_p):
    """Next token from [B, V] logits: greedy argmax (first index on
    ties, like jnp.argmax), or top-k / nucleus sampling drawn with the
    caller's generator (its stream differs from jax.random's)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / max(float(temperature), 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[:, 0] = True  # the argmax survives even top_p <= 0
    threshold = torch.amin(
        torch.where(keep, srt, torch.full_like(srt, float("inf"))),
        dim=-1, keepdim=True)
    logits = torch.where(logits < threshold,
                         torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _make_head_logits(cfg):
    def head_logits(h, p):
        if cfg.tie_word_embeddings:
            return h @ p["llama.embed_tokens.weight"].T
        return _mm(h, p["lm_head.weight"])
    return head_logits


def _lw(p, i, name):
    """Layer `i`'s weight `name` from a decode-params dict."""
    return p[f"llama.layers.{i}.{name}"]


def _layer_kv(kcs, vcs, i, n_layers):
    """(kc_i, vc_i, page_off): layer `i`'s K/V pools (per-layer lists;
    the layer-stacked pool of the scan megakernel is not ported)."""
    if len(kcs) != n_layers:
        raise NotImplementedError("layer-stacked pools are not ported")
    return kcs[i], vcs[i], 0


def _make_prefill(cfg, b, sb):
    """Per-layer prefill over the decode-params dict: embed ->
    L x (rms / attention / mlp) -> final rms. Returns (h_final,
    [(k_i, v_i)]) with rotary-applied K/V [b, sb, nkv, dh] per layer;
    the caller owns the cache layout."""
    nh, nkv, dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    n_layers = cfg.num_hidden_layers
    eps = cfg.rms_norm_eps

    def prefill(p, ids):
        h = p["llama.embed_tokens.weight"][ids]          # [b, sb, h]
        pos_ids = torch.arange(sb, device=h.device)
        kvs = []
        for i in range(n_layers):
            x = _k_rms(h, _lw(p, i, "input_layernorm.weight"), eps)
            q = _mm(x, _lw(p, i, "self_attn.q_proj.weight")).reshape(
                b, sb, nh, dh)
            k = _mm(x, _lw(p, i, "self_attn.k_proj.weight")).reshape(
                b, sb, nkv, dh)
            v = _mm(x, _lw(p, i, "self_attn.v_proj.weight")).reshape(
                b, sb, nkv, dh)
            q, k = apply_rotary_emb(q, k, position_ids=pos_ids,
                                    base=cfg.rope_theta)
            kvs.append((k, v))
            attn = flash_attention(q, k, v, causal=True)
            h = h + _mm(attn.reshape(b, sb, nh * dh),
                        _lw(p, i, "self_attn.o_proj.weight"))
            x2 = _k_rms(h, _lw(p, i, "post_attention_layernorm.weight"),
                        eps)
            gate = _mm(x2, _lw(p, i, "mlp.gate_proj.weight"))
            up = _mm(x2, _lw(p, i, "mlp.up_proj.weight"))
            h = h + _mm(F.silu(gate) * up, _lw(p, i, "mlp.down_proj.weight"))
        h = _k_rms(h, p["llama.norm.weight"], eps)
        return h, kvs

    return prefill


def make_paged_kv_helpers(b, n_pre, nkv, dh, block_size, tables):
    """The prefill page transpose and the per-token page/slot write,
    over block table `tables` [b, W] (int32). The write updates the
    pools IN PLACE (the JAX version returns new arrays).

    JAX clamps an out-of-range gather index and torch raises (on the
    card, a device-side assert): a row frozen at lens == budget can
    reach lens // block_size == W, so the page column is clamped to
    W - 1 explicitly, reproducing the JAX result."""
    def to_pages(kv):
        """[b, n_pre*block_size, nkv, dh] -> [b, n_pre, nkv, block_size, dh]"""
        return kv.reshape(b, n_pre, block_size, nkv, dh).permute(
            0, 1, 3, 2, 4)

    def kv_write(kc, vc, k, v, lens):
        lens = lens.to(torch.int64)
        col = torch.clamp(lens // block_size, max=tables.shape[1] - 1)
        rows = torch.arange(b, device=lens.device)
        page = tables[rows, col].to(torch.int64)
        slot = lens % block_size
        kc[page, :, slot, :] = k[:, 0].to(kc.dtype)
        vc[page, :, slot, :] = v[:, 0].to(vc.dtype)
        return kc, vc

    return to_pages, kv_write


def _make_decode_step(cfg, b, max_seq=None, kv_write=None, kv_attend=None):
    """Single-token decode step over the decode-params dict; the KV
    store is injected:

      kv_write(kc, vc, k, v, pos)  -> (kc, vc)   store the token's K/V
      kv_attend(q1, kc, vc, pos)   -> ctx [B, Hq, D]

    (pos: [B] cached counts). The contiguous-cache defaults of the JAX
    version ride the contiguous decode kernels, which are not ported."""
    if kv_write is None or kv_attend is None:
        raise NotImplementedError(
            "the contiguous-cache decode step (decode_attention / "
            "gqa_decode_attention kernels) is not ported yet; pass the "
            "paged kv_write / kv_attend")
    nh, nkv, dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    n_layers = cfg.num_hidden_layers
    eps = cfg.rms_norm_eps
    head_logits = _make_head_logits(cfg)

    def decode_step(p, kcs, vcs, tok, pos):
        """tok [B, 1] token ids; pos [B] tokens already cached (the new
        token's position, one per row)."""
        h = p["llama.embed_tokens.weight"][tok[:, 0]][:, None, :]
        pos_ids = pos[:, None]
        for i in range(n_layers):
            x = _k_rms(h, _lw(p, i, "input_layernorm.weight"), eps)
            q = _mm(x, _lw(p, i, "self_attn.q_proj.weight")).reshape(
                b, 1, nh, dh)
            k = _mm(x, _lw(p, i, "self_attn.k_proj.weight")).reshape(
                b, 1, nkv, dh)
            v = _mm(x, _lw(p, i, "self_attn.v_proj.weight")).reshape(
                b, 1, nkv, dh)
            q, k = apply_rotary_emb(q, k, position_ids=pos_ids,
                                    base=cfg.rope_theta)
            kc, vc, _ = _layer_kv(kcs, vcs, i, n_layers)
            kv_write(kc, vc, k, v, pos)
            ctx = kv_attend(q[:, 0].contiguous(), kc, vc, pos)
            h = h + _mm(ctx.reshape(b, 1, nh * dh),
                        _lw(p, i, "self_attn.o_proj.weight"))
            x2 = _k_rms(h, _lw(p, i, "post_attention_layernorm.weight"),
                        eps)
            gate = _mm(x2, _lw(p, i, "mlp.gate_proj.weight"))
            up = _mm(x2, _lw(p, i, "mlp.up_proj.weight"))
            h = h + _mm(F.silu(gate) * up, _lw(p, i, "mlp.down_proj.weight"))
        h = _k_rms(h, p["llama.norm.weight"], eps)
        return head_logits(h, p)[:, -1], kcs, vcs

    return decode_step


def make_paged_decode_step(cfg, b, block_size, tables):
    """`_make_decode_step` over paged pools [P, nkv, block_size, dh]
    with block table `tables` [b, W] int32: the token's K/V is written
    in place, then ``paged_decode_attention`` attends positions <= pos."""
    _, kv_write = make_paged_kv_helpers(b, 0, cfg.num_key_value_heads,
                                        cfg.head_dim, block_size, tables)

    def kv_attend(q1, kc, vc, pos):
        return paged_decode_attention(q1, kc, vc, tables,
                                      pos.to(torch.int32))

    return _make_decode_step(cfg, b, kv_write=kv_write, kv_attend=kv_attend)


# ---------------------------------------------------------------------------
# build-time serving flags
# ---------------------------------------------------------------------------

KV_CACHE_DTYPES = ("bf16", "int8")
MEGAKERNEL_MODES = ("off", "attn", "full", "scan")


def resolve_kv_cache_dtype(kv_cache_dtype: Optional[str] = None) -> str:
    """'bf16' | 'int8', from the argument or FLAGS_kv_cache_dtype."""
    if kv_cache_dtype is None:
        kv_cache_dtype = str(_flag("kv_cache_dtype"))
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(
            f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, got "
            f"{kv_cache_dtype!r}")
    return kv_cache_dtype


def resolve_decode_megakernel(decode_megakernel=None) -> str:
    """'off' | 'attn' | 'full' | 'scan', from the argument or
    FLAGS_decode_megakernel; legacy booleans map False -> 'off',
    True -> 'attn'."""
    if decode_megakernel is None:
        decode_megakernel = _flag("decode_megakernel")
    if isinstance(decode_megakernel, bool):
        return "attn" if decode_megakernel else "off"
    s = str(decode_megakernel).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return "attn"
    if s in ("0", "false", "no", ""):
        return "off"
    if s not in MEGAKERNEL_MODES:
        raise ValueError(
            f"decode_megakernel must be one of {MEGAKERNEL_MODES} (or a "
            f"legacy boolean), got {decode_megakernel!r}")
    return s


def resolve_unified_step(unified_step=None) -> bool:
    """Whether to serve through the unified ragged step, from the
    argument or FLAGS_unified_step. 'auto' resolves to the split path
    (False), the JAX package's choice on a real chip."""
    if unified_step is None:
        unified_step = _flag("unified_step")
    if isinstance(unified_step, str):
        s = unified_step.strip().lower()
        if s in ("auto", "", "0", "false", "off", "no"):
            return False
        if s in ("1", "true", "on", "yes"):
            return True
        raise ValueError(
            f"unified_step must be 'auto'/'1'/'0', got {unified_step!r}")
    return bool(unified_step)


def resolve_serving_mp(serving_mp: Optional[int] = None) -> int:
    if serving_mp is None:
        serving_mp = int(_flag("serving_mp"))
    serving_mp = int(serving_mp)
    if serving_mp < 1:
        raise ValueError(f"serving_mp must be >= 1, got {serving_mp}")
    return serving_mp


def resolve_serving_cp(serving_cp: Optional[int] = None) -> int:
    if serving_cp is None:
        serving_cp = int(_flag("serving_cp"))
    serving_cp = int(serving_cp)
    if serving_cp < 1:
        raise ValueError(f"serving_cp must be >= 1, got {serving_cp}")
    return serving_cp


# ---------------------------------------------------------------------------
# host-side page allocator (ported whole: it is pure host bookkeeping)
# ---------------------------------------------------------------------------

def hash_prefix_blocks(tokens, block_size: int):
    """Chained per-block prompt hashes: hash i covers tokens
    [0, (i+1)*block_size), so a hit on hash i implies the whole prefix
    through block i matches."""
    hashes = []
    h = block_size  # seed the chain with the geometry
    for i in range(len(tokens) // block_size):
        h = hash((h, tuple(tokens[i * block_size:(i + 1) * block_size])))
        hashes.append(h)
    return hashes


class PagedKVManager:
    """Host-side KV page allocator with a refcounted, block-aligned
    prefix cache (the JAX package's ``PagedKVManager``).

    Pages are integer ids into the [max_pages, H, block_size, D] pools;
    `alloc` hands out the lowest free ids, `free` returns them. A page
    holding one full prompt block may be registered under its chained
    prefix hash (`insert_prefix`); later requests map it in
    (`acquire_prefix`). `free` is refcount-aware: a cached page becomes
    reusable only once no request maps it, parking on an LRU list that
    `alloc_pages` evicts oldest first."""

    def __init__(self, max_pages: int, block_size: int = 64):
        self.max_pages = int(max_pages)
        self.block_size = int(block_size)
        self._free = list(range(self.max_pages - 1, -1, -1))  # pop() = min
        self._hash_to_page = {}
        self._cached = {}        # page -> [hash, refcount]
        self._lru = OrderedDict()
        self.prefix_evictions = 0
        self._geometry = None    # set_pool_geometry

    @staticmethod
    def page_bytes(block_size: int, *, n_layers: int, num_kv_heads: int,
                   head_dim: int, kv_cache_dtype: str = "bf16",
                   mp: int = 1) -> int:
        """Device bytes ONE page costs across all layers (K + V pools,
        plus the f32 scale rows of int8 pools), per shard of `mp`."""
        mp = int(mp)
        if mp > 1:
            if num_kv_heads % mp:
                raise ValueError(
                    f"per-shard geometry needs kv heads {num_kv_heads} "
                    f"divisible by mp {mp}")
            num_kv_heads //= mp
        itemsize = 1 if kv_cache_dtype == "int8" else 2
        per_layer = 2 * num_kv_heads * block_size * head_dim * itemsize
        if kv_cache_dtype == "int8":
            per_layer += 2 * num_kv_heads * 4
        return per_layer * n_layers

    @classmethod
    def pages_for_bytes(cls, budget_bytes: int, block_size: int, *,
                        n_layers: int, num_kv_heads: int, head_dim: int,
                        kv_cache_dtype: str = "bf16", mp: int = 1,
                        cp: int = 1) -> int:
        per_page = cls.page_bytes(block_size, n_layers=n_layers,
                                  num_kv_heads=num_kv_heads,
                                  head_dim=head_dim,
                                  kv_cache_dtype=kv_cache_dtype, mp=mp)
        return max(0, int(budget_bytes) // per_page) * max(1, int(cp))

    def set_pool_geometry(self, *, n_layers: int, num_kv_heads: int,
                          head_dim: int, kv_cache_dtype: str = "bf16",
                          mp: int = 1, cp: int = 1):
        resolve_kv_cache_dtype(kv_cache_dtype)
        if mp > 1 and num_kv_heads % mp:
            raise ValueError(
                f"kv heads {num_kv_heads} not divisible by mp {mp}")
        cp = int(cp)
        if cp < 1:
            raise ValueError(f"cp must be >= 1, got {cp}")
        if self.max_pages % cp:
            raise ValueError(
                f"fleet page count {self.max_pages} not divisible by "
                f"cp {cp}")
        self._geometry = dict(n_layers=int(n_layers),
                              num_kv_heads=int(num_kv_heads),
                              head_dim=int(head_dim),
                              kv_cache_dtype=kv_cache_dtype,
                              mp=int(mp), cp=cp)

    def kv_pool_bytes(self, aggregate: bool = False) -> int:
        if self._geometry is None:
            raise RuntimeError(
                "kv_pool_bytes() needs set_pool_geometry(...) first")
        geo = dict(self._geometry)
        cp = geo.pop("cp", 1)
        per_chip = (self.max_pages // cp) \
            * self.page_bytes(self.block_size, **geo)
        return per_chip * geo["mp"] * cp if aggregate else per_chip

    @property
    def n_free(self) -> int:
        """Strictly free pages (no eviction needed)."""
        return len(self._free)

    @property
    def n_available(self) -> int:
        """Pages allocatable right now: free + evictable."""
        return len(self._free) + len(self._lru)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def alloc(self, n_tokens: int):
        return self.alloc_pages(self.pages_needed(n_tokens))

    def alloc_pages(self, n: int):
        evicted = False
        while len(self._free) < n and self._lru:
            page, _ = self._lru.popitem(last=False)
            h, refs = self._cached.pop(page)
            if refs:
                raise RuntimeError(f"page {page} on the LRU with refs {refs}")
            del self._hash_to_page[h]
            self._free.append(page)
            self.prefix_evictions += 1
            evicted = True
        if n > len(self._free):
            raise RuntimeError(
                f"paged KV pool exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.max_pages} "
                f"({len(self._cached)} cached, {len(self._lru)} evictable)")
        if evicted:
            self._free.sort(reverse=True)
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        """Refcount-aware release, in reverse order so a request's
        deepest prefix blocks land oldest on the LRU."""
        for p in reversed(list(pages)):
            if not 0 <= p < self.max_pages:
                raise ValueError(f"page id {p} out of range")
            meta = self._cached.get(p)
            if meta is not None:
                if meta[1] <= 0:
                    raise ValueError(
                        f"over-release of cached page {p} (refcount 0)")
                meta[1] -= 1
                if meta[1] == 0:
                    self._lru[p] = None
                continue
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)
        self._free.sort(reverse=True)

    def prefix_lookup(self, tokens, max_blocks: Optional[int] = None,
                      hashes=None):
        """Longest cached block-aligned prefix WITHOUT taking references:
        (n_blocks_hit, n_lru_hits)."""
        hits = lru = 0
        if hashes is None:
            hashes = hash_prefix_blocks(tokens, self.block_size)
        if max_blocks is not None:
            hashes = hashes[:max_blocks]
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is None:
                break
            hits += 1
            if self._cached[page][1] == 0:
                lru += 1
        return hits, lru

    def acquire_prefix(self, tokens, max_blocks: Optional[int] = None,
                       hashes=None):
        """Take a reference on every cached block of `tokens`' prefix;
        returns the page ids in block order."""
        pages = []
        if hashes is None:
            hashes = hash_prefix_blocks(tokens, self.block_size)
        if max_blocks is not None:
            hashes = hashes[:max_blocks]
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is None:
                break
            meta = self._cached[page]
            if meta[1] == 0:
                del self._lru[page]
            meta[1] += 1
            pages.append(page)
        return pages

    def insert_prefix(self, tokens, pages, start_block: int = 0,
                      hashes=None) -> int:
        """Register `pages` (one per full block from `start_block`) under
        the chained hashes; an already-mapped hash is skipped (first
        writer wins). Returns the insert count."""
        if hashes is None:
            hashes = hash_prefix_blocks(tokens, self.block_size)
        inserted = 0
        for h, page in zip(hashes[start_block:], pages):
            if h in self._hash_to_page:
                continue
            if page in self._cached:
                raise ValueError(
                    f"page {page} already registered in the prefix cache")
            if page in self._free:
                raise ValueError(f"cannot insert free page {page}")
            self._hash_to_page[h] = page
            self._cached[page] = [h, 1]
            inserted += 1
        return inserted

    def tables_for_batch(self, seq_capacities):
        """Allocate per-sequence page lists and return (tables [B, max_n]
        int32 CPU tensor, page_lists), rows padded with their own last
        page id."""
        lists = [self.alloc(c) for c in seq_capacities]
        width = max(len(l) for l in lists)
        tbl = np.asarray([l + [l[-1]] * (width - len(l)) for l in lists],
                         np.int32)
        return torch.from_numpy(tbl), lists
