"""Llama decoder family, serving and training (counterpart of
paddle_tpu/models/llama.py).

What is here:

- ``LlamaConfig`` with the JAX package's stock sizes and training knobs
  (``dtype``, ``recompute``, ``recompute_skip``, ``remat_policy``,
  ``remat_scope``, ``fused_swiglu``, with JAX's defaults);
- the forward as ``nn.Module``s (``LlamaForCausalLM`` and its parts): the
  plain oracle the serving path is checked against, and the training
  forward under autograd once ``load_params(..., trainable=True)`` (or
  ``init_train_params``) gives it trainable weights; per-layer recompute
  through ``torch.utils.checkpoint``; ``LlamaPretrainingCriterion``;
- the functional serving pieces over a decode-params dict
  (``_make_prefill``, ``_make_prefill_with_prefix``,
  ``_make_chunk_prefill``, ``_make_decode_step``,
  ``make_paged_kv_helpers``, and for int8 pools ``quantize_kv_pages`` and
  ``make_paged_kv_q8_helpers``, ``PagedKVManager``), which
  ``serving.engine`` drives. A layer's K/V pool is a tensor
  [max_pages, Hkv, block_size, D] (bf16 / f32), or on int8 pools a pair
  (int8 pool, f32 scale [max_pages, Hkv]);
- weight-only quantized serving: ``decode_params`` and
  ``init_quant_serving_params`` make the JAX ``_decode_params`` layout,
  where every projection and the lm_head is an (int8 [N, K] or packed
  int4 [N, K // 2], f32 scale [N]) pair, and ``build_quant_generate``
  serves it over contiguous per-layer caches;
- the decode megakernel ladder: ``plan_megakernel_rung`` (scan -> full
  -> attn -> off, one reason per refused rung),
  ``_make_decode_step_megakernel`` and, for 'scan', the stacked layout
  (``stack_decode_layer_params``, read back through ``_lw``; one
  layer-major pool whose readers add ``_layer_kv``'s page offset);
- training over a mesh (`parallel.mesh`): ``llama_sharding_rules``,
  ``shard_llama`` and ``gather_params`` (the JAX rule table over the
  ``sharding`` and ``mp`` axes; a rank keeps its blocks), and the
  training forward at a rank's heads and columns (``TrainTP``:
  Megatron's f before each column-parallel block, g after each
  row-parallel one, the embedding's columns and the logits' vocab
  gathered) with the ZeRO-3 gathers of `parallel.sharding`; over a
  ``sep`` axis (inside `parallel.sequence_parallel.seq_sharded`) the
  forward takes the rank's slice of the sequence, rotates it at its
  global positions and attends over the whole sequence: Ulysses'
  all-to-all head swap, ring attention, or the sequence gathered where
  the heads do not split;
- tensor- and context-parallel serving: ``ServingTP`` (the head and page
  geometry of ``serving_mp`` / ``serving_cp`` and its three seams, the
  only code that issues a collective: ``gather_heads``, ``psum_partial``,
  ``merge_attn_partials``), ``make_serving_tp`` and
  ``shard_serving_params``. Every serving body takes ``tp=`` and then
  computes its rank's local heads (and, under cp, its own pages); the
  ranks are processes under torch.distributed (``parallel.ranks``).

Weight layout: every projection keeps paddle's ``Linear`` layout
[in_features, out_features] (``y = x @ w``), in the decode-params dict and
in the modules alike, so JAX weights carry across without a transpose and
the modules share storage with the dict. Keys are the JAX package's
(``llama.layers.{i}.self_attn.q_proj.weight`` ...).

The kernel wrappers (``rms_norm``, ``flash_attention``, ``swiglu_matmul``,
``paged_decode_attention``, ``prefix_prefill_attention``,
``ragged_paged_attention``, ``decode_attention``,
``gqa_decode_attention``, ``int4_matmul``, ``int8_weight_matmul``)
launch the CUDA kernels for CUDA tensors and run their plain versions for
CPU tensors. ``LlamaForCausalLM(...,
use_kernels=False)`` runs the plain versions on any device, which is how
the card checks the kernels end to end.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict, namedtuple
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..framework.cuda_graph import GenerateProgram, GraphSite
from ..framework.flags import flag as _flag
from ..kernels.decode_attention import (decode_attention,
                                        gqa_decode_attention,
                                        model_kv_heads,
                                        paged_decode_attention)
from ..kernels.decode_megakernel import (decode_layer_megakernel,
                                         decode_layer_megakernel_full,
                                         decode_layers_megakernel,
                                         megakernel_full_supported,
                                         megakernel_scan_supported,
                                         megakernel_supported)
from ..kernels.flash_attention import (flash_attention,
                                       flash_attention_reference)
from ..kernels.int4_matmul import int4_matmul, int8_weight_matmul
from ..kernels.partial_attention import (causal_window_partials,
                                         combine_partials, cp_local_view,
                                         cp_write_rows,
                                         decode_paged_partials,
                                         finalize_partials, paged_partials)
from ..kernels.prefix_prefill import prefix_prefill_attention
from ..kernels.ragged_attention import ragged_paged_attention
from ..kernels.rms_norm import rms_norm as _k_rms
from ..kernels.rms_norm import rms_norm_reference
from ..kernels.rope import apply_rotary_emb
from ..kernels.swiglu import swiglu_matmul, swiglu_matmul_reference
from ..nn.quant import weight_quantize
from ..parallel.collectives import (all_gather, all_reduce, c_concat,
                                    c_identity, c_split, mp_allreduce,
                                    quantized_all_gather, quantized_psum,
                                    quantized_psum_prequant,
                                    resolve_quantized_collectives)
from ..parallel.ring_attention import ring_attention
from ..parallel.sequence_parallel import sep_attention, seq_shard
from ..parallel.ulysses import minimal_kv_repeat, ulysses_available

WEIGHT_QUANTS = ("weight_only_int8", "weight_only_int4")


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
    # training knobs, with the JAX package's defaults (its llama.py:55-86):
    # per-layer recompute, except the last `recompute_skip` layers;
    # `remat_scope` "attn" / "mlp" checkpoints only that sub-block of each
    # layer; a saving `remat_policy` (SAVED_OPS) keeps what it
    # names through the recompute, any other name recomputes everything as
    # in JAX; `fused_swiglu` routes the MLP through the SwiGLU kernels on
    # 512-aligned shapes; `attention_impl` is the attention over a sep
    # axis, "ulysses" (the all-to-all head swap) or "ring" (k / v rotate
    # around the ring); `dtype` is the dtype of the weights
    # init_train_params makes
    recompute: bool = False
    recompute_skip: int = 0
    remat_policy: str = "none"
    remat_scope: str = "layer"
    fused_swiglu: bool = False
    attention_impl: str = "ulysses"
    dtype: str = "float32"

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
    floating weight. A weight-only quantized (int8 weight, f32 scale) pair
    of ``_decode_params`` carries across as a pair of tensors, unchanged
    (`dtype` does not touch it)."""
    dev = resolve_device(device)

    def tensor(arr):
        return torch.from_numpy(np.array(arr)).to(dev)  # a writable copy

    out = {}
    for name, arr in np_params.items():
        if isinstance(arr, tuple):
            out[name] = tuple(tensor(a) for a in arr)
            continue
        t = tensor(arr)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t
    return out


def _quantized_name(name: str) -> bool:
    """The decode-params keys that weight-only serving quantizes: every
    projection and the lm_head (the embedding and the norms stay dense)."""
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def _check_quant(quant) -> None:
    if quant not in WEIGHT_QUANTS:
        raise ValueError(f"quant must be None, 'weight_only_int8' or "
                         f"'weight_only_int4', got {quant!r}")


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `b` reads what the held tensor `a` reads: the same bytes
    (address, shape, strides, dtype, device). A tensor that wraps the
    same storage anew (a load_params of the same dict) is the same."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype
                      and a.device == b.device)


def decode_params(params: dict, quant: Optional[str]) -> dict:
    """The JAX ``LlamaForCausalLM._decode_params`` layout: with `quant`
    ('weight_only_int8' | 'weight_only_int4') every ``*_proj.weight`` and
    ``lm_head.weight`` becomes a (w_q, scale) pair of ``weight_quantize``
    over the f32 weight, on the weight's device; the embedding and the
    norms stay dense. `quant=None` returns `params` itself.

    The JAX method caches the pairs per source array (its arrays are
    immutable, so identity means "unchanged"). A torch tensor updated in
    place keeps its identity, so no cache is kept here: every call
    quantizes, and the caller keeps the result."""
    if quant is None:
        return params
    _check_quant(quant)
    return {name: weight_quantize(w, algo=quant) if _quantized_name(name)
            else w for name, w in params.items()}


def init_quant_serving_params(cfg: LlamaConfig, quant: str, seed: int = 0,
                              device=None,
                              dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights (normal, std 0.02; norms at 1) in the
    ``decode_params`` layout, made weight by weight on `device` from a
    ``torch.Generator`` seeded with `seed`: each projection is drawn in
    f32 and quantized at once, so the full-precision model never exists;
    the peak transient is one f32 weight (the lm_head, 2.1 GB at
    Llama-3-8B). The embedding and the norms are `dtype`. Stands in for a
    quantized checkpoint (the JAX ``init_quant_serving_params``, whose
    random stream differs)."""
    _check_quant(quant)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("norm.weight"):
            out[name] = torch.ones(shape, dtype=dtype, device=dev)
            continue
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).mul_(0.02)
        out[name] = weight_quantize(w, algo=quant) if _quantized_name(name) \
            else w.to(dtype)
    return out


def torch_dtype(name: str) -> torch.dtype:
    """LlamaConfig.dtype ("float32", "bfloat16", "float16") as a torch
    dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    if name not in dtypes:
        raise ValueError(f"dtype must be one of {sorted(dtypes)}, got "
                         f"{name!r}")
    return dtypes[name]


def init_train_params(cfg: LlamaConfig, seed: int = 0, device=None,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Random trainable weights (normal, std 0.02; norms at 1), each a
    ``requires_grad`` ``nn.Parameter`` in `dtype` (default
    ``cfg.dtype``), drawn weight by weight on `device` from a
    ``torch.Generator`` seeded with `seed` (its stream differs from the
    JAX initializers'). Load with ``load_params(params, trainable=True)``.
    """
    dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
    return {name: nn.Parameter(w) for name, w in init_serving_params(
        cfg, seed=seed, device=device, dtype=dtype).items()}


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

# the kernel-backed operations a forward needs, picked once per model
_Ops = namedtuple("_Ops", "rms_norm flash_attention swiglu")
KERNEL_OPS = _Ops(_k_rms, flash_attention, swiglu_matmul)
PLAIN_OPS = _Ops(rms_norm_reference, flash_attention_reference,
                 swiglu_matmul_reference)


def _meta(*shape) -> nn.Parameter:
    # parameters are placeholders until load_params / load_jax_params:
    # an 8B model must never be materialized by the constructor
    return nn.Parameter(torch.empty(shape, device="meta"),
                        requires_grad=False)


class _Linear(nn.Module):
    """paddle ``Linear`` without bias: weight [in, out], y = x @ w. On a
    sharded model (`_wdist`, a `parallel.sharding.WeightDist`) the weight
    is this rank's block: its ZeRO axes are gathered for the product."""

    _wdist = None

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = _meta(n_in, n_out)

    def forward(self, x):
        if self._wdist is not None:
            return self._wdist.linear(x, self.weight)
        return _mm(x, self.weight)


def _full(mod) -> torch.Tensor:
    """A module's weight gathered over its ZeRO axes (itself unsharded)."""
    w = mod.weight
    return w if mod._wdist is None else mod._wdist.full(w)


class LlamaRMSNorm(nn.Module):
    _wdist = None

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.variance_epsilon = config.rms_norm_eps
        self.weight = _meta(config.hidden_size)

    def forward(self, x, ops=KERNEL_OPS):
        return ops.rms_norm(x, _full(self), self.variance_epsilon)


class LlamaAttention(nn.Module):
    """Self-attention (the JAX module): q/k/v projections, rope at
    `position_ids`, flash attention, o projection.

    With `cache` (pk, pv) -- the concat cache of ``generate``: (None,
    None) before the prompt, else the K/V [b, S_cached, nkv, dh] so far --
    the new K/V are appended on the sequence axis, attention is causal
    only where keys and queries are the same positions (Sk == Sq: the
    prompt), and the call returns (out, (k, v)).

    With `_tp` (a `TrainTP`: the training forward over an mp axis) the
    projections are this rank's columns and rows and it attends its own
    heads; with `sp` (a `parallel.sequence_parallel.SeqShard`) `hidden`
    is the rank's slice of the sequence (`_attend_seq`)."""

    _tp = None

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

    def forward(self, hidden, position_ids, ops=KERNEL_OPS, cache=None,
                sp=None):
        if cache is None and (self._tp is not None or sp is not None):
            return self._forward_sharded(hidden, position_ids, ops, sp)
        b, s, _ = hidden.shape
        q = self.q_proj(hidden).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).reshape(b, s, self.num_kv_heads,
                                        self.head_dim)
        v = self.v_proj(hidden).reshape(b, s, self.num_kv_heads,
                                        self.head_dim)
        q, k = apply_rotary_emb(q, k, position_ids=position_ids,
                                base=self.config.rope_theta)
        if cache is not None:
            pk, pv = cache
            if pk is not None:
                k = torch.cat([pk, k], dim=1)
                v = torch.cat([pv, v], dim=1)
        causal = cache is None or k.shape[1] == s
        out = ops.flash_attention(q, k, v, causal=causal)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        return out if cache is None else (out, (k, v))

    def _forward_sharded(self, hidden, position_ids, ops, sp):
        """The training forward at the rank's heads (`_tp`: f, the
        column-parallel q / k / v, k and v all-gathered when mp does not
        divide the kv heads, the row-parallel o and g) and / or over its
        slice of the sequence (`sp`): rope at the given positions, then
        attention over the whole sequence (`_attend_seq`)."""
        tp, dh = self._tp, self.head_dim
        b, s, _ = hidden.shape
        h = hidden if tp is None else c_identity(hidden, tp.ref)
        q = self.q_proj(h).reshape(b, s, -1, dh)
        k, v = self.k_proj(h), self.v_proj(h)
        if tp is not None and tp.kv_gather:
            k = all_gather(k, tp.ref, -1, grad="reduce_scatter")
            v = all_gather(v, tp.ref, -1, grad="reduce_scatter")
        k = k.reshape(b, s, -1, dh)
        v = v.reshape(b, s, -1, dh)
        q, k = apply_rotary_emb(q, k, position_ids=position_ids,
                                base=self.config.rope_theta)
        if sp is not None:
            out = self._attend_seq(q, k, v, ops, sp)
        else:
            out = ops.flash_attention(q, *self._rank_kv(k, v), causal=True)
        out = self.o_proj(out.reshape(b, s, -1))
        return out if tp is None else mp_allreduce(out, tp.ref)

    def _rank_kv(self, k, v):
        """The kv heads the rank's q heads read, where k / v were
        all-gathered over mp (`TrainTP.kv_index`)."""
        tp = self._tp
        if tp is None or tp.kv_index is None:
            return k, v
        idx = tp.kv_index_on(k.device)
        return k.index_select(2, idx), v.index_select(2, idx)

    def _attend_seq(self, q, k, v, ops, sp):
        """Causal attention of the rank's slice of the sequence (q [b, s,
        heads, dh] at its global positions) over the whole sequence, the
        JAX module's routes (its llama.py:224-292):

        - ``attention_impl="ring"``: `ring_attention` over the sep ranks'
          chunks (GQA inside the ring);
        - else `sequence_parallel.sep_attention` of the flash kernel:
          Ulysses where the q heads split over (mp, sep), k / v repeated
          first by `minimal_kv_repeat` where the kv heads do not (the
          rank's mp block of the repeated heads when they were
          all-gathered); the sequence gathered otherwise."""
        mesh, axis, tp = sp.mesh, sp.axis, self._tp
        heads = ("mp",) if tp is not None else ()
        if self.config.attention_impl == "ring":
            return ring_attention(q, *self._rank_kv(k, v), mesh=mesh,
                                  axis=axis, causal=True)
        seq = q.shape[1] * sp.size
        nh, nkv = self.num_heads, self.num_kv_heads
        if ulysses_available(mesh, nh, seq, axis, heads) and \
                not ulysses_available(mesh, nkv, seq, axis, heads):
            r = minimal_kv_repeat(mesh, nh, nkv, axis, heads)
            k = k.repeat_interleave(r, dim=2)
            v = v.repeat_interleave(r, dim=2)
            if tp is not None and tp.kv_gather:
                n = k.shape[2] // tp.ref.size
                k = k.narrow(2, tp.ref.rank * n, n)
                v = v.narrow(2, tp.ref.rank * n, n)
        else:
            k, v = self._rank_kv(k, v)
        return sep_attention(
            q, k, v, lambda q, k, v: ops.flash_attention(q, k, v,
                                                         causal=True),
            mesh, axis, heads)


class LlamaMLP(nn.Module):
    _tp = None

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self._fused = config.fused_swiglu
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _Linear(h, i)
        self.up_proj = _Linear(h, i)
        self.down_proj = _Linear(i, h)

    def forward(self, x, ops=KERNEL_OPS):
        tp = self._tp if self._tp is not None and self._tp.mlp_split \
            else None
        if tp is not None:
            x = c_identity(x, tp.ref)
        if self._fused:
            # the JAX route (its llama.py:308-316): the SwiGLU kernels when
            # M, K and F are multiples of 512, the plain composition else
            out = self.down_proj(ops.swiglu(x, _full(self.gate_proj),
                                            _full(self.up_proj), fused=True))
        else:
            out = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return out if tp is None else mp_allreduce(out, tp.ref)


# the jax.checkpoint saving policies the JAX model maps remat_policy to
# (its llama.py:403-410), as the operators whose outputs each keeps
# through the recompute: ``save_attn`` the flash forward's (the attention
# output and its lse: JAX's ``checkpoint_name(out, "attn_out")``, so the
# backward does not run the flash forward again), ``dots_saveable`` every
# matmul's, ``dots_with_no_batch_dims_saveable`` those with no batch dims
# (the projections, not batched products); any other name recomputes
# everything
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
SAVED_OPS = {
    "save_attn": frozenset({torch.ops.paddle_tpu.flash_attention_fwd.default}),
    "dots_saveable": frozenset(_DOTS + (torch.ops.aten.bmm.default,
                                        torch.ops.aten.baddbmm.default)),
    "dots_with_no_batch_dims_saveable": frozenset(_DOTS),
}


def _remat(fn, *args, policy: str = "none"):
    """`fn(*args)` with its activations recomputed in the backward instead
    of kept (jax.checkpoint), but for the outputs a saving `policy` names
    (`SAVED_OPS`: a selective checkpoint, JAX's checkpoint policies)."""
    saved = SAVED_OPS.get(policy)
    if not saved:
        return checkpoint(fn, *args, use_reentrant=False)

    def keep(ctx, op, *a, **kw):
        return CheckpointPolicy.MUST_SAVE if op in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return checkpoint(fn, *args, use_reentrant=False, context_fn=partial(
        create_selective_checkpoint_contexts, keep))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = LlamaRMSNorm(config)
        self.post_attention_layernorm = LlamaRMSNorm(config)

    def forward(self, hidden, position_ids, ops=KERNEL_OPS, remat=None,
                cache=None, sp=None, policy: str = "none"):
        """remat: None, or "attn" / "mlp" -- checkpoint only that
        sub-block (the JAX layer's sub-layer recompute), keeping what
        `policy` (a remat_policy) saves. With `cache` (see LlamaAttention)
        returns (hidden, new cache); `sp`: the sequence slice
        (LlamaAttention)."""
        h = self.input_layernorm(hidden, ops)
        new_cache = None
        if cache is not None:
            attn, new_cache = self.self_attn(h, position_ids, ops,
                                             cache=cache)
        elif remat == "attn":
            attn = _remat(self.self_attn, h, position_ids, ops, None, sp,
                          policy=policy)
        else:
            attn = self.self_attn(h, position_ids, ops, sp=sp)
        hidden = hidden + attn
        h = self.post_attention_layernorm(hidden, ops)
        mlp = _remat(self.mlp, h, ops, policy=policy) if remat == "mlp" \
            else self.mlp(h, ops)
        hidden = hidden + mlp
        return hidden if cache is None else (hidden, new_cache)


class _Embedding(nn.Module):
    _wdist = None

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = _meta(n, dim)

    def forward(self, ids):
        out = _full(self)[ids]
        if self._wdist is not None and self._wdist.mp_dim == 1:
            # the table's columns over mp: this rank's, gathered
            out = c_concat(out, self._wdist.plan.mesh.axis_ref("mp"), -1)
        return out


class LlamaModel(nn.Module):
    # it reads `seq_shard()`: handed a sep rank's slice of the sequence,
    # it computes that slice of the global value (parallel.trainer)
    handles_seq_shard = True

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = _Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config)

    def forward(self, input_ids, caches=None, position_offset: int = 0,
                ops=KERNEL_OPS):
        """Hidden states [B, S, hidden] after the final norm; with
        `caches` (one (pk, pv) a layer, see LlamaAttention) returns
        (hidden, new caches)."""
        cfg = self.config
        s = input_ids.shape[1]
        # the tokens of a sep rank are its slice of the sequence: rotated
        # at their global positions (parallel.sequence_parallel)
        sp = seq_shard() if caches is None else None
        start = position_offset + (sp.rank * s if sp is not None else 0)
        pos = torch.arange(start, start + s, device=input_ids.device)
        hidden = self.embed_tokens(input_ids)
        if caches is not None:
            new_caches = []
            for layer, cache in zip(self.layers, caches):
                hidden, c = layer(hidden, pos, ops, cache=cache)
                new_caches.append(c)
            return self.norm(hidden, ops), new_caches
        # recompute only where a backward will follow (JAX: under the
        # functional train step), every layer but the last recompute_skip
        use_ckpt = cfg.recompute and torch.is_grad_enabled()
        n_ckpt = len(self.layers) - cfg.recompute_skip if use_ckpt else 0
        for li, layer in enumerate(self.layers):
            if li >= n_ckpt:
                hidden = layer(hidden, pos, ops, sp=sp)
            elif cfg.remat_scope in ("attn", "mlp"):
                hidden = layer(hidden, pos, ops, remat=cfg.remat_scope,
                               sp=sp, policy=cfg.remat_policy)
            else:
                hidden = _remat(layer, hidden, pos, ops, None, None, sp,
                                policy=cfg.remat_policy)
        return self.norm(hidden, ops)


class LlamaForCausalLM(nn.Module):
    """Inference forward over [B, S] token ids -> [B, S, vocab] logits.

    Parameters are placeholders until ``load_params`` (the port's
    decode-params dict, shared without a copy) or ``load_jax_params``
    (the JAX package's dict as numpy arrays). `use_kernels=False` runs
    the plain PyTorch versions of the kernels on any device."""

    _tp = None
    _shard_plan = None
    handles_seq_shard = True

    def __init__(self, config: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.config = config
        self.use_kernels = use_kernels
        self.llama = LlamaModel(config)
        if not config.tie_word_embeddings:
            self.lm_head = _Linear(config.hidden_size, config.vocab_size)

    def forward(self, input_ids, caches=None, position_offset: int = 0):
        """Logits [B, S, vocab]; with `caches` (one (pk, pv) a layer:
        (None, None) before the prompt) returns (logits, new caches), the
        JAX model's concat-cache call. A sharded model returns the whole
        logits on every rank, as JAX's returns a global array."""
        ops = KERNEL_OPS if self.use_kernels else PLAIN_OPS
        out = self.llama(input_ids, caches=caches,
                         position_offset=position_offset, ops=ops)
        hidden = out[0] if caches is not None else out
        tp = self._tp
        if self.config.tie_word_embeddings:
            emb = self.llama.embed_tokens
            if tp is not None and tp.embed_split:
                # the table's columns over mp: a partial product, summed
                logits = mp_allreduce(emb._wdist.linear(
                    c_split(hidden, tp.ref, -1), emb.weight, True), tp.ref)
            elif emb._wdist is not None:
                logits = emb._wdist.linear(hidden, emb.weight, True)
            else:
                logits = hidden @ emb.weight.T
        elif tp is not None and tp.head_split:
            # the vocab over mp: this rank's logits, gathered
            logits = c_concat(self.lm_head(c_identity(hidden, tp.ref)),
                              tp.ref, -1)
        else:
            logits = self.lm_head(hidden)
        return (logits, out[1]) if caches is not None else logits

    def apply_shard_plan(self, plan) -> "LlamaForCausalLM":
        """Lay the model out by a `parallel.sharding.ShardPlan`: each
        parameter becomes this rank's block (a new spec may only add axes
        to the current one), the modules compute with it (`_wdist`), and
        over an mp axis above 1 the training forward runs at the rank's
        heads and columns (`TrainTP`)."""
        from ..parallel.sharding import WeightDist, slice_params

        tp = TrainTP(self.config, plan) if plan.mesh.shape.get("mp", 1) > 1 \
            else None
        slice_params(self, plan)
        for name, mod in self.named_modules():
            if isinstance(mod, (_Linear, _Embedding, LlamaRMSNorm)):
                mod._wdist = WeightDist(plan, f"{name}.weight")
            if isinstance(mod, (LlamaAttention, LlamaMLP)):
                mod._tp = tp
        self._tp = tp
        self._shard_plan = plan
        return self

    def load_params(self, params: dict,
                    trainable: bool = False) -> "LlamaForCausalLM":
        """Point every parameter at the tensor of the same key in a
        decode-params dict (no copy: the module and the dict share
        storage). With `trainable` the parameters require grad, and a
        value that is already a trainable ``nn.Parameter`` (as
        ``init_train_params`` makes them) is held as it is, so its
        ``.grad`` is the module's."""
        for name, p in list(self.named_parameters()):
            t = params[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: expected {list(p.shape)}, got "
                                 f"{list(t.shape)}")
            if not trainable:
                t = nn.Parameter(t, requires_grad=False)
            elif not (isinstance(t, nn.Parameter) and t.requires_grad):
                t = nn.Parameter(t.detach())
            path, leaf = name.rsplit(".", 1)
            setattr(self.get_submodule(path), leaf, t)
        return self

    def load_jax_params(self, np_params: dict, device=None,
                        dtype: Optional[torch.dtype] = None
                        ) -> "LlamaForCausalLM":
        """Fill the module from the JAX ``raw_state()`` dict (numpy)."""
        return self.load_params(params_from_jax(np_params, device, dtype))

    # ---- generation ---------------------------------------------------

    def _params(self) -> dict:
        """The model's weights by decode-params key (the JAX
        ``raw_state()``), shared with the module."""
        params = dict(self.named_parameters())
        emb = params["llama.embed_tokens.weight"]
        if emb.device.type == "meta":
            raise RuntimeError("the model has no weights yet: load_params() "
                               "or load_jax_params() first")
        return params

    def _decode_params(self, params: dict, quant: Optional[str]) -> dict:
        """The decode-path parameter dict (the JAX method): `params`
        itself, or with `quant` every projection and the lm_head as a
        (w_q, scale) pair (``decode_params``). Nothing is cached: a weight
        updated in place keeps its identity, so every call quantizes."""
        if quant is None:
            return params
        _check_quant(quant)
        with torch.no_grad():
            return decode_params(params, quant)

    def _generation(self, params: dict) -> dict:
        """The generation programs' cache (`_jit_gen_cache`, one
        `GenerateProgram` per JAX signature), made or kept for `params`.
        Every program captures through the model's one graph site
        (`_gen_site`): generation calls replay one at a time on one
        stream and copy their tokens out, so the programs share its pool.
        The weights a program reads stay the model's own tensors: when
        `params` is not the memory the programs were captured over (a
        reload), every program and quantized set is dropped, so the old
        weights are freed and the next call captures over the new ones."""
        held = self.__dict__.get("_gen_params")
        if held is None or not all(_same_memory(held[k], params[k])
                                   for k in params):
            dev = params["llama.embed_tokens.weight"].device
            self.__dict__.update(_gen_params=params, _jit_gen_cache={},
                                 _gen_quant={}, _gen_site=GraphSite(dev))
        return self._jit_gen_cache

    def _quant_set(self, params: dict, quant: str) -> dict:
        """The one quantized set of `quant` that every generation program
        reads (made at its first call, then re-quantized in place from
        `params` at every call, one weight at a time, so a weight updated
        in place reaches the programs). The set is the model's own: its
        pairs are written, never a caller's tensor."""
        owned = self._gen_quant.get(quant)
        if owned is None:
            owned = self._gen_quant[quant] = self._decode_params(params,
                                                                 quant)
            return owned
        with torch.no_grad():
            for name, pair in owned.items():
                if isinstance(pair, tuple):
                    for dst, src in zip(pair, weight_quantize(
                            params[name], algo=quant)):
                        dst.copy_(src)
        return owned

    def jit_generate(self, input_ids, max_new_tokens: int = 32,
                     eos_token_id: Optional[int] = None,
                     do_sample: bool = False, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 1.0,
                     seed: Optional[int] = None, bucket_size: int = 128,
                     quant: Optional[str] = None,
                     prefill_with_quant: bool = False,
                     cache_layout: str = "contiguous",
                     kv_block_size: int = 64, seq_lens=None):
        """Generate as ONE program (the JAX ``jit_generate``): the prompt's
        prefill and every decode step, captured as a CUDA graph per
        signature on the card (`GenerateProgram`; the eager body on the
        CPU) and replayed by later calls. Runs where the model's weights
        live. Returns [b, s0 + max_new_tokens] (prompt, then new tokens),
        trimmed on the host after the last row's first EOS once every row
        has hit `eos_token_id`.

        - prompts are right-padded to a multiple of `bucket_size`; the
          true length is a program input, so every length of a bucket
          shares one program;
        - `do_sample` draws temperature / top-k / top-p from a
          ``torch.Generator`` seeded with `seed` (its stream differs from
          jax.random's: only greedy streams compare across packages);
          temperature and top_p are program inputs, top_k is static;
        - `quant` ('weight_only_int8' | 'weight_only_int4') decodes over
          weight-only pairs; `prefill_with_quant` prefills over them too
          (``build_quant_generate``: no full-precision weight is read);
        - `cache_layout="paged"` decodes over paged pools
          (``build_paged_generate``; FLAGS_kv_cache_dtype and
          FLAGS_decode_megakernel are read when its program is built and
          join the cache key), and `seq_lens` serves a ragged batch of
          right-padded rows."""
        cfg = self.config
        params = self._params()
        dev = params["llama.embed_tokens.weight"].device
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids).to(dev, torch.int64)
        if max_new_tokens <= 0:
            return ids
        b, s0 = ids.shape
        sb = -(-s0 // bucket_size) * bucket_size   # bucketed prompt length
        padded = F.pad(ids, (0, sb - s0))
        max_seq = _generate_max_seq(sb, max_new_tokens)
        if prefill_with_quant and quant is None:
            raise ValueError("prefill_with_quant=True requires quant=")
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout must be 'contiguous' or "
                             f"'paged', got {cache_layout!r}")
        if seq_lens is not None and cache_layout != "paged":
            raise ValueError("per-row seq_lens (ragged batch) requires "
                             "cache_layout='paged'")
        if quant is not None:
            _check_quant(quant)
        cache = self._generation(params)
        dec_params = params if quant is None \
            else self._quant_set(params, quant)
        # the paged program bakes the pool dtype and the megakernel rung
        # in at build time, so both flags join the cache key
        paged = cache_layout == "paged"
        kv_dtype = resolve_kv_cache_dtype() if paged else None
        megakernel = resolve_decode_megakernel() if paged else None
        serving_mp = resolve_serving_mp() if paged else None
        # the quantized wire joins the key where there is a wire
        qcoll = (resolve_quantized_collectives() and serving_mp > 1) \
            if paged else None
        sig = (b, sb, max_new_tokens, eos_token_id, do_sample, int(top_k),
               quant, prefill_with_quant, cache_layout, kv_block_size,
               kv_dtype, megakernel, qcoll, serving_mp)
        if sig not in cache:    # one program per signature, kept
            if paged:
                fn = build_paged_generate(cfg, b, sb, max_new_tokens,
                                          kv_block_size, eos_token_id,
                                          do_sample, int(top_k),
                                          serving_mp=serving_mp)
                name = "jit_generate(paged)"
            elif prefill_with_quant:
                fn = build_quant_generate(cfg, b, sb, max_new_tokens,
                                          max_seq, eos_token_id, do_sample,
                                          int(top_k))
                name = "jit_generate(quant-only)"
            else:
                fn = _build_jit_generate(self, cfg, b, sb, max_new_tokens,
                                         max_seq, eos_token_id, do_sample,
                                         int(top_k))
                name = "jit_generate(contiguous)"
            site = self._gen_site
            tp = getattr(fn, "tp", None)
            if tp is not None and tp.backend != "nccl":
                # a gloo collective cannot be captured: eager program
                site = GraphSite(dev)
                site.graphed = False
            cache[sig] = GenerateProgram(name, fn, site, do_sample)
        if seed is None:
            seed = int(torch.randint(2 ** 62, (1,)))
        if paged:
            if seq_lens is None:
                lens = np.full((b,), s0, np.int64)
            else:
                lens = np.asarray(seq_lens, np.int64).reshape(-1)
                if lens.shape[0] != b:
                    raise ValueError(f"seq_lens has {lens.shape[0]} "
                                     f"entries for a batch of {b}")
                if (lens < 1).any() or (lens > s0).any():
                    raise ValueError(
                        f"seq_lens must lie in [1, {s0}] (the input "
                        f"rectangle width); got {lens.tolist()}")
            total = sb + max_new_tokens
            mgr = PagedKVManager(b * -(-total // kv_block_size),
                                 kv_block_size)
            tables, _ = mgr.tables_for_batch([total] * b)
            new_tokens = cache[sig](
                (dec_params,), (padded, torch.from_numpy(lens).to(dev),
                                tables.to(dev)),
                seed, temperature, top_p)
        else:
            s0_t = torch.tensor(s0, dtype=torch.int64, device=dev)
            weights = (dec_params,) if prefill_with_quant \
                else (params, dec_params)
            new_tokens = cache[sig](weights, (padded, s0_t), seed,
                                    temperature, top_p)
        out = torch.cat([ids, new_tokens], dim=1)
        if eos_token_id is not None:
            # host-side trim: cut after every row has hit EOS
            hit = (new_tokens == eos_token_id).cpu().numpy()
            if hit.any(axis=1).all():
                last = int(hit.argmax(axis=1).max())
                out = out[:, :s0 + last + 1]
        return out

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 seed: Optional[int] = None):
        """Eager decode over the concat caches of ``forward(caches=)``
        (the JAX ``generate``: not one program, a forward per token). The
        first token reads the prompt's last logits; generation stops early
        once every row's last token is `eos_token_id`. Returns [b, s0 +
        the tokens made]."""
        params = self._params()
        dev = params["llama.embed_tokens.weight"].device
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids).to(dev, torch.int64)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(torch.randint(2 ** 62, (1,))) if seed is None
                        else int(seed))

        def pick(logits):
            return _sample_next(logits.to(torch.float32), gen, do_sample,
                                temperature, int(top_k), top_p)[:, None]

        with torch.no_grad():
            logits, caches = self(
                ids, caches=[(None, None)] * self.config.num_hidden_layers)
            out = [ids]
            last = pick(logits[:, -1])
            offset = ids.shape[1]
            for step in range(max_new_tokens):
                out.append(last)
                if eos_token_id is not None \
                        and bool((last == eos_token_id).all()):
                    break
                if step == max_new_tokens - 1:
                    break   # the last token needs no further forward
                logits, caches = self(last, caches=caches,
                                      position_offset=offset)
                offset += 1
                last = pick(logits[:, -1])
        return torch.cat(out, dim=1)


class LlamaPretrainingCriterion(nn.Module):
    """The JAX criterion (its llama.py:2753-2768): the mean over every
    position of logsumexp(logits) - logits[label] in f32. Labels are NOT
    shifted against the logits, whatever the JAX docstring says; the
    port reproduces the computation."""

    def __init__(self, config: Optional[LlamaConfig] = None):
        super().__init__()

    def forward(self, logits, labels):
        lg32 = logits.to(torch.float32)
        lse = torch.logsumexp(lg32, dim=-1)
        picked = torch.gather(lg32, -1, labels.long()[..., None])[..., 0]
        return torch.mean(lse - picked)


# ---------------------------------------------------------------------------
# training over a mesh: the rule table, a rank's blocks, its heads
# ---------------------------------------------------------------------------

MP_AXIS = "mp"


def llama_sharding_rules():
    """(param-name-suffix, partition dims) table, the JAX package's
    (weights [in, out]): the embedding's vocab over the ZeRO axis and its
    h over mp; q / k / v / gate / up column-parallel, o / down
    row-parallel; the lm head's vocab over mp."""
    return [
        ("embed_tokens.weight", ("sharding", MP_AXIS)),     # [vocab, h]
        ("q_proj.weight", ("sharding", MP_AXIS)),           # [h, nh*dh]
        ("k_proj.weight", ("sharding", MP_AXIS)),
        ("v_proj.weight", ("sharding", MP_AXIS)),
        ("o_proj.weight", (MP_AXIS, "sharding")),           # [nh*dh, h]
        ("gate_proj.weight", ("sharding", MP_AXIS)),
        ("up_proj.weight", ("sharding", MP_AXIS)),
        ("down_proj.weight", (MP_AXIS, "sharding")),
        ("lm_head.weight", ("sharding", MP_AXIS)),          # [h, vocab]
        ("layernorm.weight", (None,)),
        ("norm.weight", (None,)),
    ]


def _param_sharding(mesh, name: str, ndim: int, shape) -> tuple:
    """A parameter's spec by the rule table (JAX's `_param_sharding`): a
    dim takes its axis where the mesh has it and it divides the dim."""
    for suffix, dims in llama_sharding_rules():
        if name.endswith(suffix):
            spec = []
            for i in range(ndim):
                d = dims[i] if i < len(dims) else None
                if d is not None and d in mesh.axis_names \
                        and shape[i] % int(mesh.shape[d]) == 0:
                    spec.append(d)
                else:
                    spec.append(None)
            return tuple(spec)
    return (None,) * ndim


def shard_llama(model: "LlamaForCausalLM", mesh=None) -> "LlamaForCausalLM":
    """Lay every parameter out per the rule table, TP over ``mp`` and
    ZeRO-3 / FSDP over ``sharding``: each rank (all holding the same full
    weights) keeps its block of each, and the model then trains at the
    rank's heads and columns with the ZeRO gathers (the JAX
    ``shard_llama``, where XLA makes the collectives). Without a mesh
    (argument or global) the model is returned unchanged."""
    from ..parallel import mesh as mesh_mod
    from ..parallel.placement import dist_attr
    from ..parallel.sharding import ShardPlan

    mesh = mesh or mesh_mod.get_global_mesh()
    if mesh is None:
        return model
    specs, shapes = {}, {}
    for name, p in model.named_parameters():
        attr = dist_attr(p)
        shapes[name] = tuple(attr.global_shape) if attr else tuple(p.shape)
        specs[name] = _param_sharding(mesh, name, p.ndim, shapes[name])
    return model.apply_shard_plan(ShardPlan(mesh, specs, shapes))


def gather_params(model_or_params) -> Dict[str, torch.Tensor]:
    """The full parameters (detached) of a sharded model or params dict:
    every block all-gathered over its axes (every rank calls it); plain
    tensors pass through. The inverse of `shard_llama`."""
    from ..parallel.sharding import gather_tensor

    params = dict(model_or_params.named_parameters()) \
        if isinstance(model_or_params, nn.Module) else model_or_params
    return {k: gather_tensor(v).detach() for k, v in params.items()}


class TrainTP:
    """The mp axis of the sharded training forward: the rank's q heads
    (`nq`; the JAX model splits heads over mp), whether k / v are
    all-gathered (mp does not divide the kv heads: JAX then keeps them
    whole, llama.py:273-280) and which kv heads the rank's q heads read
    (`kv_index`), and whether the MLP, the embedding's columns and the
    lm head's vocab are split. A layout the forward cannot compute at a
    rank's heads raises."""

    def __init__(self, cfg: LlamaConfig, plan):
        self.ref = plan.mesh.axis_ref(MP_AXIS)
        mp, rank = self.ref.size, self.ref.rank
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

        def dims(suffix):
            return {plan.mp_dim(n) for n in plan.specs if n.endswith(suffix)}

        attn = (dims("q_proj.weight"), dims("k_proj.weight"),
                dims("v_proj.weight"), dims("o_proj.weight"))
        if attn != ({1}, {1}, {1}, {0}) or nh % mp:
            raise NotImplementedError(
                f"training at mp={mp} needs q / k / v split by columns, o "
                f"by rows and the {nh} heads divisible by mp (mp dims "
                f"{attn}; ROADMAP \"Trainer options the port refuses\")")
        self.nq = nh // mp
        self.kv_gather = nkv % mp != 0
        self.kv_index = None
        if self.kv_gather:
            g = nh // nkv
            heads = [t // g for t in range(rank * self.nq,
                                           (rank + 1) * self.nq)]
            uniq = sorted(set(heads))
            per = self.nq // len(uniq)
            if self.nq % len(uniq) or any(
                    heads[j] != uniq[j // per] for j in range(self.nq)):
                uniq = heads      # one kv head a q head
            self.kv_index = torch.tensor(uniq, dtype=torch.long)
        self._on = {}
        mlp = (dims("gate_proj.weight"), dims("up_proj.weight"),
               dims("down_proj.weight"))
        if mlp not in (({1}, {1}, {0}), ({None}, {None}, {None})):
            raise NotImplementedError(
                f"mp dims of the MLP {mlp} (ROADMAP \"Trainer options the "
                "port refuses\")")
        self.mlp_split = mlp[0] == {1}
        emb = dims("embed_tokens.weight")
        if emb == {0}:
            raise NotImplementedError(
                "an embedding split by vocab over mp (ROADMAP \"Trainer "
                "options the port refuses\")")
        self.embed_split = emb == {1}
        self.head_split = dims("lm_head.weight") == {1}

    def kv_index_on(self, device) -> torch.Tensor:
        """`kv_index` on `device` (copied there once)."""
        if device not in self._on:
            self._on[device] = self.kv_index.to(device)
        return self._on[device]


# ---------------------------------------------------------------------------
# functional serving path over the decode-params dict
# ---------------------------------------------------------------------------

def _mm(x, w):
    """Matmul against a decode weight: dense [K, N], or a weight-only
    pair -- int8 [N, K] or packed int4 [N, K // 2] (told apart by the
    stored K, as in JAX) with per-channel f32 scales [N]. Both sum in f32,
    scale in f32 and round once to x's dtype (``int4_matmul`` /
    ``int8_weight_matmul``: the GEMV kernel for M <= 64 rows on the card,
    the dequantize-then-matmul route above)."""
    if isinstance(w, tuple):
        wq, sc = w
        k = x.shape[-1]
        x2 = x.reshape(-1, k).contiguous()
        if wq.shape[1] != k:          # packed int4: two nibbles per byte
            out = int4_matmul(x2, wq, sc)
        else:
            out = int8_weight_matmul(x2, wq, sc)
        return out.reshape(*x.shape[:-1], wq.shape[0])
    if x.dtype != w.dtype:
        # the bf16 head gather of an f32 stream meets an f32 o-proj: JAX
        # promotes the product to f32
        x = x.to(torch.promote_types(x.dtype, w.dtype))
    return x @ w


def _sample_next(logits, generator: Optional[torch.Generator], do_sample,
                 temperature, top_k, top_p):
    """Next token from [B, V] logits: greedy argmax (first index on
    ties, like jnp.argmax), or top-k / nucleus sampling drawn with the
    caller's generator (its stream differs from jax.random's).
    `temperature` and `top_p` may be floats or 0-d tensors on the logits'
    device (the generation programs' inputs: a graph reads them without
    a host sync, so changing them needs no new capture)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    if isinstance(temperature, torch.Tensor):
        temperature = torch.clamp(temperature, min=1e-6)
    else:
        temperature = max(float(temperature), 1e-6)
    logits = logits.to(torch.float32) / temperature
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


# ---------------------------------------------------------------------------
# stacked decode-layer parameters (decode_megakernel="scan"): every
# per-layer weight on a leading layer axis, made once at engine build
# ---------------------------------------------------------------------------

STACKED_PREFIX = "llama.layers.stacked."

# the per-layer weights the scan megakernel streams, in the call order of
# decode_layers_megakernel
STACKED_LAYER_NAMES = (
    "input_layernorm.weight",
    "post_attention_layernorm.weight",
    "self_attn.q_proj.weight",
    "self_attn.k_proj.weight",
    "self_attn.v_proj.weight",
    "self_attn.o_proj.weight",
    "mlp.gate_proj.weight",
    "mlp.up_proj.weight",
    "mlp.down_proj.weight",
)


def stack_decode_layer_params(p: dict, n_layers: int) -> dict:
    """A new decode-params dict in which every weight of
    `STACKED_LAYER_NAMES` moves from its ``llama.layers.{i}.`` entries into
    one ``llama.layers.stacked.<name>`` entry stacked along a leading
    layer axis (weight-only pairs stack both members); the per-layer
    entries are dropped from the new dict, so once the caller drops its
    own dict each weight lives on the device once. Every program reads
    layer slices back through `_lw`."""
    out = dict(p)
    for name in STACKED_LAYER_NAMES:
        per = [out.pop(f"llama.layers.{i}.{name}") for i in range(n_layers)]
        if isinstance(per[0], tuple):
            out[STACKED_PREFIX + name] = (torch.stack([w[0] for w in per]),
                                          torch.stack([w[1] for w in per]))
        else:
            out[STACKED_PREFIX + name] = torch.stack(per)
    return out


def _lw(p, i, name):
    """Layer `i`'s weight `name` from a decode-params dict: the per-layer
    entry, or a slice of the stacked entry (a view, no copy)."""
    w = p.get(f"llama.layers.{i}.{name}")
    if w is not None:
        return w
    st = p[STACKED_PREFIX + name]
    if isinstance(st, tuple):
        return (st[0][i], st[1][i])
    return st[i]


def _layer_kv(kcs, vcs, i, n_layers):
    """(kc_i, vc_i, page_off): layer `i`'s K/V pool entries. Per-layer
    lists return entry i with offset 0; the scan layout's one-entry lists
    hold ONE layer-major pool where layer i owns page rows [i * pp,
    (i + 1) * pp), so readers add `page_off` to their block-table ids
    (a slice would be a view too, but the kernels take whole pools)."""
    if len(kcs) == n_layers:
        return kcs[i], vcs[i], 0
    kc, vc = kcs[0], vcs[0]
    pool = kc[0] if isinstance(kc, tuple) else kc
    return kc, vc, i * (pool.shape[0] // n_layers)


def _layers(cfg, p, h, pos_ids, attend, tp=None):
    """The decoder stack over the decode-params dict, from embedded
    tokens h [b, s, hidden]: L x (rms / attention / mlp) -> final rms.
    q and k are rotary-encoded at `pos_ids` ([s] or [b, s]); layer i's
    attention context comes from ``attend(i, q, k, v)``. Returns (h_final,
    [(k_i, v_i)]) with the rotary-applied K/V [b, s, nkv, dh] per layer.

    With `tp` (ServingTP) the params are the rank's slice: q / k / v
    carry its local heads (so do the returned K/V), and the attention
    context all-gathers along the head axis before the replicated o-proj
    (`ServingTP.gather_heads`, the one collective a layer)."""
    nh, nkv, dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    # the head counts the projections reshape at: the rank's under tp
    nh_l = tp.nh_local if tp is not None else nh
    nkv_l = tp.nkv_local if tp is not None else nkv
    eps = cfg.rms_norm_eps
    b, s, _ = h.shape
    kvs = []
    for i in range(cfg.num_hidden_layers):
        x = _k_rms(h, _lw(p, i, "input_layernorm.weight"), eps)
        q = _mm(x, _lw(p, i, "self_attn.q_proj.weight")).reshape(
            b, s, nh_l, dh)
        k = _mm(x, _lw(p, i, "self_attn.k_proj.weight")).reshape(
            b, s, nkv_l, dh)
        v = _mm(x, _lw(p, i, "self_attn.v_proj.weight")).reshape(
            b, s, nkv_l, dh)
        q, k = apply_rotary_emb(q, k, position_ids=pos_ids,
                                base=cfg.rope_theta)
        kvs.append((k, v))
        if tp is None:
            attn = attend(i, q, k, v)
        else:
            # the split plans size their grid by the model's kv heads, so
            # a rank splits each row as one device does
            with model_kv_heads(tp.kv_shards):
                attn = attend(i, q, k, v)
            attn = tp.gather_heads(attn)
        h = h + _mm(attn.reshape(b, s, nh * dh),
                    _lw(p, i, "self_attn.o_proj.weight"))
        x2 = _k_rms(h, _lw(p, i, "post_attention_layernorm.weight"), eps)
        gate = _mm(x2, _lw(p, i, "mlp.gate_proj.weight"))
        up = _mm(x2, _lw(p, i, "mlp.up_proj.weight"))
        h = h + _mm(F.silu(gate) * up, _lw(p, i, "mlp.down_proj.weight"))
    return _k_rms(h, p["llama.norm.weight"], eps), kvs


def _make_prefill(cfg, b, sb, tp=None):
    """Per-layer prefill over the decode-params dict: embed ->
    L x (rms / attention / mlp) -> final rms. Returns (h_final,
    [(k_i, v_i)]) with rotary-applied K/V [b, sb, nkv, dh] per layer;
    the caller owns the cache layout. With `tp` the flash attention runs
    over the rank's heads and the K/V are its local kv heads."""
    def prefill(p, ids):
        h = p["llama.embed_tokens.weight"][ids]          # [b, sb, h]
        return _layers(cfg, p, h, torch.arange(sb, device=h.device),
                       lambda i, q, k, v: flash_attention(q, k, v,
                                                          causal=True),
                       tp=tp)

    return prefill


def _split_pool(entry):
    """A pool entry -> (pool, scale): (int8 pool, f32 scale) pairs split,
    a bf16 / f32 pool comes with scale None."""
    return entry if isinstance(entry, tuple) else (entry, None)


def _pool_pair(kcs, vcs, i, n_layers):
    """Layer `i`'s pools as (kc, vc, k_scale, v_scale, page_off); the
    scales are None for bf16 / f32 pools."""
    kc, vc, poff = _layer_kv(kcs, vcs, i, n_layers)
    (kc, ksc), (vc, vsc) = _split_pool(kc), _split_pool(vc)
    return kc, vc, ksc, vsc, poff


def _make_window_prefill(cfg, tn, paged_attention, tp=None,
                         window_lens: bool = True):
    """The prefill shared by the cached-prefix suffix prefill and the
    unified step's chunk lane: `tn` new tokens per row at positions
    cached[:, None] + arange(tn), each layer attending the row's cached
    pool pages plus the window through `paged_attention` (the
    prefix-prefill or ragged wrapper). Pool entries may be (int8 pool, f32
    scale) pairs: the wrapper then dequantizes inside its f32 math.

    With `tp` the params and pools are the rank's (local heads). Under cp
    the rank holds only its pages: the cached phase runs as
    online-softmax partials over its own pages (position valid AND
    owned), merged across the cp group, and the causal window, computed
    alike on every rank, joins once (the JAX cp branches). `window_lens`
    says whether the window's columns and rows past new_lens are pad (the
    chunk lane) or live (the prefix suffix, whose cp branch in JAX reads
    no suffix lengths)."""
    n_layers = cfg.num_hidden_layers
    scale = 1.0 / math.sqrt(cfg.head_dim)
    cp = tp is not None and tp.cp > 1

    def prefill(p, kcs, vcs, ids, tables, cached, new_lens=None):
        h = p["llama.embed_tokens.weight"][ids]          # [b, tn, h]
        pos_ids = cached.to(torch.int64)[:, None] \
            + torch.arange(tn, device=h.device)[None, :]

        def attend(i, q, k, v):
            kc, vc, ksc, vsc, poff = _pool_pair(kcs, vcs, i, n_layers)
            tbl = tables + poff if poff else tables
            if not cp:
                return paged_attention(q, k, v, kc, vc, tbl, cached,
                                       new_lens, scale=scale, k_scale=ksc,
                                       v_scale=vsc)
            loc, owned = cp_local_view(tbl, tp.pps(kc), tp.c_index)
            page = kc.shape[2]
            pos_ok = torch.arange(loc.shape[1] * page, device=h.device)[
                None, :] < cached.to(torch.int64)[:, None]
            valid = pos_ok & torch.repeat_interleave(owned, page, dim=1)
            part = tp.merge_attn_partials(*paged_partials(
                q, kc, vc, loc, valid, scale=scale, k_scale=ksc,
                v_scale=vsc))
            lens = new_lens if window_lens else None
            live = None
            if window_lens:
                live = (torch.arange(tn, device=h.device)[None, :]
                        < new_lens.to(torch.int64)[:, None])[..., None]
            win = causal_window_partials(q, k, v, lens, scale=scale)
            return finalize_partials(*combine_partials(part, win),
                                     live).to(h.dtype)

        return _layers(cfg, p, h, pos_ids, attend, tp=tp)

    return prefill


def _make_prefill_with_prefix(cfg, b, sb, w_pre, block_size, tp=None):
    """Suffix prefill over a cached block-aligned prefix (the JAX
    function's single-device branch): hidden states for the `sb` uncached
    suffix tokens only, attending over the prefix pages named by
    `prefix_tables` [b, w_pre] plus the suffix, causally, through
    ``prefix_prefill_attention``. `prefix_lens` [b] are cached token
    counts (whole pages); suffix positions start there.

    Returns prefill(p, kcs, vcs, ids, prefix_tables, prefix_lens,
    suffix_lens=None) -> (h_final [b, sb, h], [(k_i, v_i)]) with
    rotary-applied suffix K/V [b, sb, nkv, dh] per layer; the caller owns
    the page scatter. Pad rows (>= suffix_lens) attend nothing and come
    out of the attention as zeros."""
    if sb % block_size or w_pre < 1:
        raise ValueError(
            f"prefix prefill needs a suffix bucket that is a whole number "
            f"of pages ({sb} % {block_size}) and a prefix table at least "
            f"one page wide (w_pre {w_pre})")
    return _make_window_prefill(cfg, sb, prefix_prefill_attention, tp=tp,
                                window_lens=False)


def _make_chunk_prefill(cfg, tn, tp=None):
    """Chunk lane of the unified serving step (the JAX function's
    single-device branch): one prefill window of `tn` tokens for one
    request, attending its committed tokens (earlier windows or a cached
    prefix, named by `chunk_table` [1, w]) plus the window causally,
    through ``ragged_paged_attention``. `cached_len` [1] may be any
    token count; `new_len` [1] is the true chunk length (window rows past
    it are pad rows, zeroed by the attention).

    Returns prefill(p, kcs, vcs, ids, chunk_table, cached_len, new_len)
    -> (h_final [1, tn, h], [(k_i, v_i)]) with rotary-applied window K/V
    [1, tn, nkv, dh] per layer; the caller owns the page scatter."""
    return _make_window_prefill(cfg, tn, ragged_paged_attention, tp=tp)


def _make_verify_window(cfg, b, w, tp=None):
    """Speculative-verify body (the JAX function's single-device branch):
    the chunk lane of `_make_chunk_prefill` batched over `b` slots at a
    fixed window of `w` = spec_k + 1 tokens, the slot's pending token and
    its drafts, through ``ragged_paged_attention``. `tables` [b, W] are
    the slots' block tables, `cached_lens` [b] their committed token
    counts (token-granular), `new_lens` [b] the true window lengths (1 =
    no drafts; rows past it are pad rows, zeroed by the attention).

    Returns verify(p, kcs, vcs, ids, tables, cached_lens, new_lens) ->
    (h_final [b, w, hidden], [(k_i, v_i)]) with rotary-applied window K/V
    [b, w, nkv, dh] per layer; the caller owns the per-column page
    scatter and the head, whose row j scores the token after window
    token j. Under tp: the rank's heads (mp); cp raises, as in JAX."""
    if tp is not None and tp.cp > 1:
        raise NotImplementedError(
            "speculative verify windows do not compose with serving_cp "
            "(the page-sharded merge of a multi-row window is not in the "
            "JAX package either)")
    return _make_window_prefill(cfg, w, ragged_paged_attention, tp=tp)


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


def quantize_kv_pages(kv):
    """Symmetric absmax int8 quantization of whole K/V pages (the JAX
    package's ``quantize_kv_pages``, op for op).

    kv: [..., block_size, dh], reduced per (page, kv head) over the
    trailing two axes. The absmax is taken in f32 before any rounding to a
    narrower type; scale = absmax / 127, values divide by the scale (never
    multiply by its reciprocal) and round half to even, so identical f32
    inputs give identical bytes in both frameworks. Returns (int8 same
    shape, scale [...] f32); an all-zero page keeps scale 0 (dequantizes
    to exact zeros)."""
    kf = kv.to(torch.float32)
    amax = torch.amax(torch.abs(kf), dim=(-2, -1)) / 127.0
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    q = torch.round(kf / safe[..., None, None]).to(torch.int8)
    return q, amax


def make_paged_kv_q8_helpers(b, n_pre, nkv, dh, block_size, tables):
    """int8 twins of `make_paged_kv_helpers`, over (int8 pool
    [max_pages, nkv, block, dh], f32 scale [max_pages, nkv]) pairs:

    - `to_pages_q8(kv)` -> (int8 pages, scales): the prefill transpose
      fused with quantize-on-scatter;
    - `kv_write_q8(kct, vct, k, v, lens)`: the per-token decode commit,
      IN PLACE on both tensors of each pair (the JAX version returns new
      arrays). The page's absmax scale is monotone: a token louder than
      the page's absmax grows the scale and the stored rows are rescaled
      in the same read-modify-write; `slot == 0` resets the scale, so a
      recycled page never inherits its previous owner's absmax.

    As in `make_paged_kv_helpers`, the page column of a row frozen at
    lens == W*block_size is clamped to W - 1 (JAX clamps the gather)."""
    to_pages, _ = make_paged_kv_helpers(b, n_pre, nkv, dh, block_size,
                                        tables)

    def to_pages_q8(kv):
        return quantize_kv_pages(to_pages(kv))

    def _commit_token(pool, scales, tok, page, slot):
        rows = torch.arange(b, device=tok.device)
        tokf = tok.to(torch.float32)                           # [b, nkv, dh]
        tok_amax = torch.amax(torch.abs(tokf), dim=-1) / 127.0  # [b, nkv]
        # a fresh page (slot 0): the scale its previous owner left behind
        # is dead, the absmax chain starts from this token
        old = torch.where((slot == 0)[:, None], torch.zeros_like(tok_amax),
                          scales[page])
        new = torch.maximum(old, tok_amax)
        safe = torch.where(new > 0, new, torch.ones_like(new))
        ratio = old / safe                                      # <= 1
        pg = torch.round(pool[page].to(torch.float32)
                         * ratio[..., None, None])
        pg[rows, :, slot, :] = torch.round(tokf / safe[..., None])
        pool[page] = torch.clamp(pg, -127, 127).to(torch.int8)
        scales[page] = new

    def kv_write_q8(kct, vct, k, v, lens):
        lens = lens.to(torch.int64)
        col = torch.clamp(lens // block_size, max=tables.shape[1] - 1)
        rows = torch.arange(b, device=lens.device)
        page = tables[rows, col].to(torch.int64)
        slot = lens % block_size
        _commit_token(*kct, k[:, 0], page, slot)
        _commit_token(*vct, v[:, 0], page, slot)
        return kct, vct

    return to_pages_q8, kv_write_q8


def _make_decode_step(cfg, b, max_seq=None, kv_write=None, kv_attend=None,
                      tp=None):
    """Single-token decode step over the decode-params dict; the KV
    store is injected:

      kv_write(kc, vc, k, v, pos)  -> (kc, vc)   store the token's K/V
      kv_attend(q1, kc, vc, pos)   -> ctx [B, Hq, D]

    (kc / vc are a layer's cache entries, (int8 pool, scale) pairs on int8
    pools). `pos` counts the tokens already cached: a [B] tensor (one per
    row, the paged batch) or a scalar (the contiguous caches).

    Defaults (both None): contiguous caches [B, Hkv, max_seq, D], written
    IN PLACE at `pos` (the JAX dynamic_update_slice, whose start index
    clamps to max_seq - 1 where torch would raise) and attended through
    ``decode_attention`` (group 1) or ``gqa_decode_attention``.

    With `tp` the step computes the rank's heads over its pools and
    all-gathers the context before the o-proj (`_layers`); the GQA group
    comes from the rank's head counts, never the model's."""
    n_layers = cfg.num_hidden_layers
    group = (tp.nh_local // tp.nkv_local) if tp is not None \
        else cfg.num_attention_heads // cfg.num_key_value_heads
    head_logits = _make_head_logits(cfg)

    if kv_write is None:
        if max_seq is None:
            raise ValueError("the contiguous-cache decode step needs "
                             "max_seq")

        def kv_write(kc, vc, k, v, pos):
            start = torch.clamp(pos.to(torch.int64), 0, max_seq - 1)
            start = start.expand(b) if start.ndim == 0 else start
            rows = torch.arange(b, device=kc.device)
            kc[rows, :, start, :] = k[:, 0].to(kc.dtype)
            vc[rows, :, start, :] = v[:, 0].to(vc.dtype)
            return kc, vc

    if kv_attend is None:
        def kv_attend(q1, kc, vc, pos):
            lens = pos.to(torch.int32).expand(b).contiguous()
            if group == 1:
                return decode_attention(q1, kc, vc, lens)
            return gqa_decode_attention(q1, kc, vc, lens)

    def decode_step(p, kcs, vcs, tok, pos):
        """tok [B, 1] token ids; pos: tokens already cached (the new
        token's position), [B] or a scalar."""
        pos = torch.as_tensor(pos, device=tok.device)
        h = p["llama.embed_tokens.weight"][tok[:, 0]][:, None, :]

        def attend(i, q, k, v):
            kc, vc, poff = _layer_kv(kcs, vcs, i, n_layers)
            if poff:
                raise ValueError(
                    "the multi-kernel decode step takes per-layer pools; "
                    "the layer-stacked pool is served by the scan "
                    "megakernel")
            kv_write(kc, vc, k, v, pos)
            return kv_attend(q[:, 0].contiguous(), kc, vc, pos)

        pos_ids = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
        h, _ = _layers(cfg, p, h, pos_ids, attend, tp=tp)
        return head_logits(h, p)[:, -1], kcs, vcs

    return decode_step


def make_paged_decode_step(cfg, b, block_size, tables,
                           kv_cache_dtype: str = "bf16", tp=None):
    """`_make_decode_step` over paged pools [P, nkv, block_size, dh]
    with block table `tables` [b, W] int32: the token's K/V is written
    in place, then ``paged_decode_attention`` attends positions <= pos.
    On int8 pools (`kv_cache_dtype="int8"`) every pool entry is an (int8
    pool, f32 scale) pair: the q8 commit writes the token and the int8
    kernel attends with the scales.

    With `tp` the pools hold the rank's kv heads. Under cp they hold its
    pages (plus the sink row): the commit aims pages other ranks own at
    the sink (`cp_write_rows`; the q8 commit then reads and rewrites the
    sink), and the attention runs as `decode_paged_partials` over the
    owned pages, merged across the cp group and normalized."""
    helpers = make_paged_kv_q8_helpers if kv_cache_dtype == "int8" \
        else make_paged_kv_helpers
    nkv = tp.nkv_local if tp is not None else cfg.num_key_value_heads
    if tp is None or tp.cp <= 1:
        _, kv_write = helpers(b, 0, nkv, cfg.head_dim, block_size, tables)

        def kv_attend(q1, kc, vc, pos):
            (kc, ksc), (vc, vsc) = _split_pool(kc), _split_pool(vc)
            return paged_decode_attention(q1, kc, vc, tables,
                                          pos.to(torch.int32), k_scale=ksc,
                                          v_scale=vsc)

        return _make_decode_step(cfg, b, kv_write=kv_write,
                                 kv_attend=kv_attend, tp=tp)

    def kv_write(kc, vc, k, v, pos):
        pps = tp.pps(_split_pool(kc)[0])
        _, write = helpers(b, 0, nkv, cfg.head_dim, block_size,
                           cp_write_rows(tables, pps, tp.c_index))
        return write(kc, vc, k, v, pos)

    def kv_attend(q1, kc, vc, pos):
        (kc, ksc), (vc, vsc) = _split_pool(kc), _split_pool(vc)
        loc, owned = cp_local_view(tables, tp.pps(kc), tp.c_index)
        m, l, acc = tp.merge_attn_partials(*decode_paged_partials(
            q1, kc, vc, loc, pos, owned, k_scale=ksc, v_scale=vsc))
        return finalize_partials(m, l, acc).to(q1.dtype)

    return _make_decode_step(cfg, b, kv_write=kv_write, kv_attend=kv_attend,
                             tp=tp)


def _decode_tail(decode_step, p_dec, kcs, vcs, last_logits, s0, generator,
                 temperature, top_p, ids_dtype, max_new, eos_token_id,
                 do_sample, top_k, b):
    """The shared post-prefill decode loop: the first token from the
    prompt's last logits, then `max_new - 1` single-token decode steps (a
    Python loop, unrolled into the generation program's graph; the JAX
    package scans). `s0` (a scalar, or one length a row) lives on the
    device and nothing is read back inside the loop. With `eos_token_id`,
    a row that emitted it keeps emitting it. Returns [b, max_new] in
    `ids_dtype`."""
    def sample(logits):
        return _sample_next(logits.to(torch.float32), generator, do_sample,
                            temperature, top_k, top_p)

    tok = sample(last_logits)
    done = tok == eos_token_id if eos_token_id is not None \
        else torch.zeros((b,), dtype=torch.bool, device=tok.device)
    pos = torch.as_tensor(s0, device=tok.device).to(torch.int32)
    out = [tok]
    for _ in range(max_new - 1):
        logits, kcs, vcs = decode_step(p_dec, kcs, vcs, tok[:, None], pos)
        nxt = sample(logits)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok, pos = nxt, pos + 1
    return torch.stack(out, dim=1).to(ids_dtype)


def _generate_max_seq(sb: int, max_new: int) -> int:
    """The contiguous caches' length: sb + max_new below 512, else that
    rounded up to a multiple of 512 (the JAX jit_generate's)."""
    total = sb + max_new
    return total if total < 512 else ((total + 511) // 512) * 512


def _last_row(x, s0, sb: int):
    """x[:, s0 - 1] ([b, sb, ...] -> [b, ...]) for a prompt length `s0`
    on the device, clamped into [0, sb) like JAX's dynamic index: a gather
    on the card, no host read."""
    last = torch.clamp(torch.as_tensor(s0, device=x.device).to(torch.int64)
                       - 1, 0, sb - 1)
    return x.index_select(1, last.reshape(1))[:, 0]


def _contiguous_caches(kvs, b, nkv, max_seq, dh, dtype):
    """The prompt's per-layer K/V [b, sb, nkv, dh] copied into zeroed
    contiguous caches [b, nkv, max_seq, dh] of `dtype` (positions from
    sb on are written by the decode steps). Returns (kcs, vcs)."""
    kcs, vcs = [], []
    for k, v in kvs:
        for caches, x in ((kcs, k), (vcs, v)):
            c = torch.zeros((b, nkv, max_seq, dh), dtype=dtype,
                            device=x.device)
            c[:, :, :x.shape[1]] = x.transpose(1, 2)
            caches.append(c)
    return kcs, vcs


def build_quant_generate(cfg, b, sb, max_new, max_seq=None,
                         eos_token_id=None, do_sample=False, top_k=0):
    """The quant-only generation program (the JAX ``build_quant_generate``):
    prefill and decode read only the ``decode_params`` layout (weight-only
    pairs plus the dense embedding and norms), so no full-precision
    parameter set exists on the device.

    Returns ``run(dec_params, ids_padded, s0, generator, temperature,
    top_p) -> new_tokens [b, max_new]``, the eager body (``jit_generate``
    runs it as one `GenerateProgram`, a CUDA graph on the card):
    ids_padded [b, sb]; `s0` is the true prompt length, one for every
    row, an int or a tensor on the device (read there, never on the
    host). The prompt prefills through ``_make_prefill`` (flash
    attention; the weight-only matmuls at M = b * sb rows); its K/V fills
    contiguous caches [b, nkv, max_seq, dh] in the activation dtype, with
    max_seq = sb + max_new below 512, else rounded up to a multiple of
    512; the first token comes from the logits at position s0 - 1, then
    ``_decode_tail``'s decode steps write at s0, s0 + 1, ... ."""
    nkv, dh = cfg.num_key_value_heads, cfg.head_dim
    if max_seq is None:
        max_seq = _generate_max_seq(sb, max_new)
    if max_seq < sb:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt "
                         f"bucket {sb}")
    head_logits = _make_head_logits(cfg)
    prefill = _make_prefill(cfg, b, sb)
    decode_step = _make_decode_step(cfg, b, max_seq)

    def run(p_dec, ids, s0, generator=None, temperature=1.0, top_p=1.0):
        h, kvs = prefill(p_dec, ids)
        kcs, vcs = _contiguous_caches(kvs, b, nkv, max_seq, dh, h.dtype)
        del kvs
        # logits at the TRUE last prompt position
        last_logits = head_logits(_last_row(h, s0, sb)[:, None], p_dec)[:, -1]
        return _decode_tail(decode_step, p_dec, kcs, vcs, last_logits, s0,
                            generator, temperature, top_p, ids.dtype,
                            max_new, eos_token_id, do_sample, top_k, b)

    return run


def _build_jit_generate(model, cfg, b, sb, max_new, max_seq, eos_token_id,
                        do_sample, top_k):
    """The JAX ``_build_jit_generate``: run(params, dec_params, ids, s0,
    generator, temperature, top_p) -> new_tokens [b, max_new]. The prompt
    prefills through the model's own forward (``params`` by name, through
    ``torch.func.functional_call``; flash attention) with concat caches
    ``[(None, None)] * L``; its K/V fill contiguous caches [b, nkv,
    max_seq, dh]; the first token reads the logits at s0 - 1; then
    ``_decode_tail`` runs the contiguous GQA decode step over
    ``dec_params`` (dense, or weight-only pairs). Pad K/V slots at [s0,
    sb) sit above the decode watermark until overwritten."""
    nkv, dh = cfg.num_key_value_heads, cfg.head_dim
    n_layers = cfg.num_hidden_layers
    decode_step = _make_decode_step(cfg, b, max_seq)

    def run(p, p_dec, ids, s0, generator=None, temperature=1.0, top_p=1.0):
        with torch.no_grad():
            logits, kvs = torch.func.functional_call(
                model, p, (ids,), {"caches": [(None, None)] * n_layers})
        kcs, vcs = _contiguous_caches(kvs, b, nkv, max_seq, dh,
                                      kvs[0][0].dtype)
        del kvs
        last_logits = _last_row(logits, s0, sb)
        return _decode_tail(decode_step, p_dec, kcs, vcs, last_logits, s0,
                            generator, temperature, top_p, ids.dtype,
                            max_new, eos_token_id, do_sample, top_k, b)

    return run


def build_paged_generate(cfg, b, sb, max_new, block_size: int = 64,
                         eos_token_id=None, do_sample=False, top_k=0,
                         serving_mp=None):
    """Generation over a paged KV cache with block tables (the JAX
    ``build_paged_generate``, single-device branch). Returns
    run(dec_params, ids, s0_vec, tables, generator, temperature, top_p)
    -> new_tokens [b, max_new], the eager body (``jit_generate`` runs it
    as one `GenerateProgram`).

    Per layer, K/V pools [b * pages_per_seq, nkv, block_size, dh] are made
    inside `run` (zeroed), bf16 / the activation dtype, or, when
    ``resolve_kv_cache_dtype()`` says "int8" at BUILD time, (int8 pool,
    f32 scale [pages, nkv]) pairs. `tables` [b, pages_per_seq] int32 map
    each row's logical blocks to pool pages. The prompt prefills over the
    padded rectangle (``_make_prefill``) and its K/V scatter into the
    rows' first sb / block_size pages (quantize-on-scatter on int8 pools);
    each row's first token reads its own position s0_vec[row] - 1; decode
    steps through ``make_paged_decode_step`` or, when
    ``resolve_decode_megakernel()`` asks for a rung at build time,
    ``_megakernel_or_fallback_step`` (scan steps down to full here: this
    program keeps per-layer params and pools).

    ``serving_mp > 1`` (argument or FLAGS_serving_mp, read at build) runs
    the program on every rank of an initialized process group of mp ranks
    (SPMD; `ServingTP.bind`): `run` takes the full params or the rank's
    slice (`shard_serving_params`), the pools hold the rank's kv heads and
    the o-proj activations all-gather once a layer. Every rank returns
    the same tokens. The returned `run` carries the geometry as
    ``run.tp`` (None at mp = 1)."""
    nkv, dh = cfg.num_key_value_heads, cfg.head_dim
    n_layers = cfg.num_hidden_layers
    if sb % block_size:
        raise ValueError(f"bucketed prompt length {sb} must be a multiple "
                         f"of block_size {block_size}")
    tp = make_serving_tp(cfg, serving_mp, serving_cp=1)
    if tp is not None:
        tp.bind()
        nkv = tp.nkv_local
    total = sb + max_new
    pages_per_seq = -(-total // block_size)
    n_pre = sb // block_size
    kv_dtype = resolve_kv_cache_dtype()
    use_mega = resolve_decode_megakernel()
    if use_mega == "scan":
        import warnings

        warnings.warn(
            "decode_megakernel='scan' requested, but jit_generate keeps "
            "per-layer params and pools (the stacked re-layout is the "
            "serving engine's \u2014 stack_decode_layer_params at engine "
            "build); serving the 'full' rung", stacklevel=2)
        use_mega = "full"
    head_logits = _make_head_logits(cfg)
    base_prefill = _make_prefill(cfg, b, sb, tp=tp)
    helpers = make_paged_kv_q8_helpers if kv_dtype == "int8" \
        else make_paged_kv_helpers
    to_pages, _ = helpers(b, n_pre, nkv, dh, block_size, None)

    def pool(dtype, dev):
        shape = (b * pages_per_seq, nkv, block_size, dh)
        if kv_dtype == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:2], dtype=torch.float32, device=dev))
        return torch.zeros(shape, dtype=dtype, device=dev)

    def scatter(kc, vc, k, v, pages):
        for entry, x in ((kc, k), (vc, v)):
            if kv_dtype == "int8":
                q, sc = to_pages(x)
                entry[0][pages] = q
                entry[1][pages] = sc
            else:
                entry[pages] = to_pages(x).to(entry.dtype)

    def run(p_dec, ids, s0_vec, tables, generator=None, temperature=1.0,
            top_p=1.0):
        if tp is not None:
            p_dec = shard_serving_params(p_dec, tp)
        dtype = p_dec["llama.embed_tokens.weight"].dtype
        dev = ids.device
        kcs = [pool(dtype, dev) for _ in range(n_layers)]
        vcs = [pool(dtype, dev) for _ in range(n_layers)]
        h, kvs = base_prefill(p_dec, ids)
        pages = tables[:, :n_pre].to(torch.int64)
        for i, (k, v) in enumerate(kvs):
            scatter(kcs[i], vcs[i], k, v, pages)
        del kvs
        # each row's own last-position logits (ragged batch)
        rows = torch.arange(b, device=dev)
        h_last = h[rows, s0_vec.to(torch.int64) - 1][:, None, :]
        last_logits = head_logits(h_last, p_dec)[:, -1]
        step = make_paged_decode_step(cfg, b, block_size, tables,
                                      kv_cache_dtype=kv_dtype, tp=tp)
        if use_mega != "off":
            step = _megakernel_or_fallback_step(cfg, b, tables, p_dec, kcs,
                                                vcs, step, mode=use_mega,
                                                tp=tp)
        return _decode_tail(step, p_dec, kcs, vcs, last_logits, s0_vec,
                            generator, temperature, top_p, ids.dtype,
                            max_new, eos_token_id, do_sample, top_k, b)

    run.tp = tp
    return run


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


def megakernel_rung_order(mode: str):
    """The fallback ladder below (and including) `mode`, strongest first:
    a refused rung steps DOWN one fusion level at a time -- scan -> full
    -> attn -> off -- never sideways."""
    return MEGAKERNEL_MODES[MEGAKERNEL_MODES.index(mode)::-1]


def _megakernel_rung_reason(rung, cfg, b, p, kcs, vcs, tables,
                            on_card: Optional[bool] = None,
                            tp=None) -> Optional[str]:
    """None when fusion rung `rung` can serve this decode step's operands
    (layer 0's weights stand in for every layer), else the reason the
    rung steps down. Shape-only: meta tensors serve as spec views.
    `on_card` adds the CUDA kernel's limits (default: whether the pool
    is a CUDA tensor). Under `tp` the params and pools are the rank's,
    and the o-proj is checked at its local contraction slice."""
    if rung == "off":
        return None
    if tp is not None and tp.cp > 1:
        # the fused kernel normalizes in its epilogue: it has no
        # online-softmax partials for the cross-rank cp merge
        return ("serving_cp > 1: the fused layer kernel cannot emit "
                "online-softmax partials for the cross-rank cp merge")
    if rung in ("full", "scan") and tp is not None:
        return (f"serving_mp > 1: the {rung} rung fuses the MLP past "
                "the per-layer o-proj psum, which must stay a cross-rank "
                "collective between the fused halves")
    kc0, vc0 = kcs[0], vcs[0]
    ksc = vsc = None
    if isinstance(kc0, tuple):
        (kc0, ksc), (vc0, vsc) = kc0, vc0
    h_spec = torch.empty((b, 1, cfg.hidden_size), device="meta",
                         dtype=p["llama.embed_tokens.weight"].dtype)
    kw = dict(k_scale=ksc, v_scale=vsc, on_card=on_card)
    if rung == "scan":
        if any(STACKED_PREFIX + n not in p for n in STACKED_LAYER_NAMES):
            return ("scan needs the stacked-parameter re-layout "
                    "(stack_decode_layer_params \u2014 the serving engine "
                    "builds it at engine build)")
        return megakernel_scan_supported(
            h_spec, *(p[STACKED_PREFIX + n] for n in STACKED_LAYER_NAMES),
            kc0, vc0, tables, n_layers=cfg.num_hidden_layers, **kw)
    layer = [_lw(p, 0, n) for n in STACKED_LAYER_NAMES]
    if rung == "full":
        return megakernel_full_supported(h_spec, *layer, kc0, vc0, tables,
                                         **kw)
    w_in, _, wq, wk, wv, wo = layer[:6]
    if tp is not None:
        wo = _tp_slice_o_proj(wo, tp, spec_only=True)
    return megakernel_supported(h_spec, w_in, wq, wk, wv, wo, kc0, vc0,
                                tables, **kw)


def plan_megakernel_rung(mode, cfg, b, p, kcs, vcs, tables,
                         on_card: Optional[bool] = None, tp=None):
    """(served_rung, refusals) for a requested decode_megakernel mode:
    walk the ladder strongest first, stepping down one fusion level per
    refusal; `refusals` is [(rung, reason), ...]. 'off' always serves.
    Under mp the full and scan rungs step down to attn, under cp every
    rung to off (`_megakernel_rung_reason`)."""
    refusals = []
    for rung in megakernel_rung_order(mode):
        reason = _megakernel_rung_reason(rung, cfg, b, p, kcs, vcs, tables,
                                         on_card=on_card, tp=tp)
        if reason is None:
            return rung, refusals
        refusals.append((rung, reason))
    return "off", refusals


def warn_refusals(refusals, rung: str, where: str = "here") -> None:
    """One warning per refused rung, naming its reason and what serves."""
    import warnings

    down = "the multi-kernel path" if rung == "off" else f"the '{rung}' rung"
    for refused, reason in refusals:
        warnings.warn(f"decode_megakernel rung '{refused}' unsupported "
                      f"{where} ({reason}); serving {down}", stacklevel=3)


def _megakernel_or_fallback_step(cfg, b, tables, p, kcs, vcs, base,
                                 mode: str = "attn", warn: bool = True,
                                 tp=None):
    """The strongest supported fused decode step at or below `mode`, else
    `base` (the multi-kernel step). Each refused rung warns once by name
    with its reason; `warn=False` callers warned when they planned."""
    rung, refusals = plan_megakernel_rung(mode, cfg, b, p, kcs, vcs, tables,
                                          tp=tp)
    if warn and refusals:
        warn_refusals(refusals, rung)
    if rung == "off":
        return base
    return _make_decode_step_megakernel(cfg, b, tables, mode=rung, tp=tp)


def _make_decode_step_megakernel(cfg, b, tables, mode: str = "attn",
                                 tp=None):
    """`_make_decode_step`'s paged twin at fusion rung `mode` (the JAX
    function's single-device branch), over block table `tables` [b, W]
    int32; the pools are updated in place:

    - 'attn': ``decode_layer_megakernel`` once per layer; the MLP half
      and the lm head keep ``_k_rms`` and ``_mm``;
    - 'full': ``decode_layer_megakernel_full`` once per layer;
    - 'scan': ``decode_layers_megakernel`` once per step over the stacked
      weights (``stack_decode_layer_params``) and the layer-major pool.
    The final rms_norm and the lm head follow in every rung.

    Under `tp` (attn only: the plan steps full and scan down) each rank
    runs the kernel over its heads and pools with its contraction slice
    of the o-proj and ``residual=False``: the kernel emits the f32 o-proj
    partial, `psum_partial` sums the ranks' partials and the residual is
    added once, after the sum. With quantized collectives at
    lane-aligned shapes the kernel emits the partial already int8
    (``quantize_out``) and ``quantized_psum_prequant`` ships it."""
    n_layers, eps = cfg.num_hidden_layers, cfg.rms_norm_eps
    head_logits = _make_head_logits(cfg)
    kw = dict(rope_base=cfg.rope_theta, eps=eps)
    H = cfg.hidden_size
    # the in-kernel quantize needs the flat [b H] payload to split into
    # whole 128-lane blocks per rank (JAX `quantize_wire`)
    quantize_wire = (tp is not None and tp.mp > 1 and tp.quantized
                     and H % 128 == 0 and (b * H) % (tp.mp * 128) == 0)
    # the rank's o-proj contraction slices, made at the first step (before
    # a capture) and kept per weight
    o_local = {}

    def wo_of(p, i):
        w = _lw(p, i, "self_attn.o_proj.weight")
        if tp is None:
            return w
        key = (i, id(w[0] if isinstance(w, tuple) else w))
        if key not in o_local:
            o_local[key] = _tp_slice_o_proj(w, tp)
        return o_local[key]

    def embed_lens(p, tok, pos):
        h = p["llama.embed_tokens.weight"][tok[:, 0]][:, None, :]
        pos = torch.as_tensor(pos, device=tok.device).to(torch.int32)
        return h, (pos if pos.ndim == 1 else pos.expand(b)).contiguous()

    def pools(kc, vc):
        """(pool operands, scale kwargs) of one pool entry."""
        if isinstance(kc, tuple):
            (kcp, ksc), (vcp, vsc) = kc, vc
            return (kcp, vcp), dict(k_scale=ksc, v_scale=vsc)
        return (kc, vc), {}

    def finish(h, p, kcs, vcs):
        h = _k_rms(h, p["llama.norm.weight"], eps)
        return head_logits(h, p)[:, -1], kcs, vcs

    if mode == "scan":
        def decode_step(p, kcs, vcs, tok, pos):
            h, lens = embed_lens(p, tok, pos)
            pl, sc = pools(kcs[0], vcs[0])
            h, _, _ = decode_layers_megakernel(
                h, lens, tables,
                *(p[STACKED_PREFIX + n] for n in STACKED_LAYER_NAMES), *pl,
                n_layers=n_layers, **sc, **kw)
            return finish(h, p, kcs, vcs)

        return decode_step

    if mode == "full":
        def decode_step(p, kcs, vcs, tok, pos):
            h, lens = embed_lens(p, tok, pos)
            for i in range(n_layers):
                pl, sc = pools(kcs[i], vcs[i])
                h, _, _ = decode_layer_megakernel_full(
                    h, lens, tables,
                    *(_lw(p, i, n) for n in STACKED_LAYER_NAMES), *pl,
                    **sc, **kw)
            return finish(h, p, kcs, vcs)

        return decode_step

    def decode_step(p, kcs, vcs, tok, pos):
        h, lens = embed_lens(p, tok, pos)
        for i in range(n_layers):
            pl, sc = pools(kcs[i], vcs[i])
            out, _, _ = decode_layer_megakernel(
                h, lens, tables, _lw(p, i, "input_layernorm.weight"),
                *(_lw(p, i, f"self_attn.{n}_proj.weight") for n in "qkv"),
                wo_of(p, i), *pl, **sc, **kw, residual=tp is None,
                quantize_out=quantize_wire)
            if tp is None:
                h = out
            else:
                if quantize_wire:
                    q8, q8s = out
                    red = quantized_psum_prequant(
                        q8, q8s, tp.mp_ref, shape=(b, 1, H),
                        dtype=torch.float32)
                else:
                    red = tp.psum_partial(out)
                h = (h.to(torch.float32) + red).to(h.dtype)
            x2 = _k_rms(h, _lw(p, i, "post_attention_layernorm.weight"),
                        eps)
            gate = _mm(x2, _lw(p, i, "mlp.gate_proj.weight"))
            up = _mm(x2, _lw(p, i, "mlp.up_proj.weight"))
            h = h + _mm(F.silu(gate) * up, _lw(p, i, "mlp.down_proj.weight"))
        return finish(h, p, kcs, vcs)

    return decode_step


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


SERVING_MP_FALLBACK_MSG = (
    "kv heads not divisible by serving_mp; falling back to "
    "replicated-KV head-sharded-Q (each rank streams the FULL kv "
    "pools: no per-rank KV memory win, query compute still shards)")


class PageShardingError(ValueError):
    """A paged-pool geometry cannot shard along the page axis as asked:
    the fleet page count does not split evenly across the cp ranks."""


class ServingTP:
    """Head and page geometry of a sharded serving program (the JAX
    `ServingTP`), over torch.distributed ranks.

    - q / k / v projections shard by head over `mp`: rank m of an mp
      group owns q heads [m nh_local, (m + 1) nh_local) and kv heads
      [m nkv_local, (m + 1) nkv_local), so GQA groups stay whole. The
      pools (and their int8 scale sidecars) hold the local kv heads;
      block tables, lengths and budgets are replicated.
    - Attention is rank-local. `gather_heads` all-gathers the per-rank
      attention outputs along the head axis, the one collective a layer
      (cast to bf16 before the wire); the o-proj and everything outside
      attention run replicated.
    - MQA fallback (kv heads % mp != 0): k / v and the pools replicate,
      q still shards (one warning).
    - Under `cp` the pools shard by page: global page g lives on cp rank
      g // pps. Each rank attends its own pages as online-softmax
      partials and `merge_attn_partials` merges them across the cp group;
      the fresh window is computed alike on every rank and joins once.

    The geometry (and its errors) needs no process group. `bind()` ties
    the seams to this rank's mp and cp groups (rank = c * mp + m); only
    the three seams make collectives, naming the groups by their
    `GroupRef` (`mp_ref`, `cp_ref`), so under
    `parallel.ranks.traced_rank` a ServingTP binds as that rank with no
    live group and its programs trace (the tuner's sharded candidates)."""

    def __init__(self, cfg, mp: int, quantized: Optional[bool] = None,
                 cp: int = 1):
        self.quantized = resolve_quantized_collectives(quantized)
        self.cp = int(cp)
        if self.cp < 1:
            raise ValueError(f"serving_cp must be >= 1, got {cp}")
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        if nh % mp:
            raise ValueError(
                f"serving_mp={mp} does not divide num_attention_heads "
                f"{nh}; query heads must shard evenly")
        self.mp = int(mp)
        self.nh = nh
        self.head_dim = cfg.head_dim
        self.nh_local = nh // mp
        self.kv_sharded = nkv % mp == 0
        self.nkv_local = nkv // mp if self.kv_sharded else nkv
        # how many ways the pools' kv heads are split (1: replicated)
        self.kv_shards = self.mp if self.kv_sharded else 1
        if self.kv_sharded and self.nh_local % self.nkv_local:
            raise ValueError(
                f"serving_mp={mp} breaks the GQA grouping: {nh} q heads "
                f"/ {nkv} kv heads shard to {self.nh_local}/"
                f"{self.nkv_local} per rank")
        if not self.kv_sharded:
            if self.nh_local % nkv:
                raise ValueError(
                    f"serving_mp={mp} with {nkv} kv heads leaves "
                    f"{self.nh_local} q heads per rank: not a whole "
                    "number of kv groups; no valid replicated-KV grid")
            import warnings

            warnings.warn(f"serving_mp={mp} with {nkv} kv heads: "
                          + SERVING_MP_FALLBACK_MSG, stacklevel=3)
        self.rank = 0
        self.mp_group = self.cp_group = None
        self.backend = None
        self._refs(0)

    def _refs(self, rank: int):
        from ..parallel.ranks import serving_group_keys

        self.rank = int(rank)
        self.mp_ref, self.cp_ref = serving_group_keys(self.mp, self.cp,
                                                      self.rank)

    def bind(self):
        """Tie the seams to this rank's groups of the default process
        group, which must hold exactly mp * cp ranks (under
        `parallel.ranks.traced_rank`: to that rank's group keys, with no
        group)."""
        import torch.distributed as dist

        from ..parallel.ranks import LAUNCHER, serving_groups, tracing_rank

        world = self.mp * self.cp
        traced = tracing_rank()
        if traced is not None:
            self._refs(traced % world)
            return self
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"serving_mp={self.mp} x serving_cp={self.cp} runs one "
                f"process per rank under torch.distributed and needs an "
                f"initialized default process group of {world} ranks: "
                f"start the ranks with `{LAUNCHER} script.py` and call "
                "paddle_tpu_torch.parallel.ranks.init_ranks() (or "
                "torch.distributed.init_process_group) before building")
        if dist.get_world_size() != world:
            raise ValueError(
                f"serving_mp={self.mp} x serving_cp={self.cp} needs a "
                f"default process group of {world} ranks, got "
                f"{dist.get_world_size()} (start them with `{LAUNCHER}`)")
        self._refs(dist.get_rank())
        self.backend = dist.get_backend()
        self.mp_group, self.cp_group = serving_groups(self.mp, self.cp)
        return self

    @property
    def m_index(self) -> int:
        """This rank's position in its mp group (its head shard)."""
        return self.rank % self.mp

    @property
    def c_index(self) -> int:
        """This rank's position in its cp group (its page shard)."""
        return self.rank // self.mp

    def gather_heads(self, ctx):
        """All-gather the per-rank attention outputs [..., nh_local, dh]
        along the head axis -> [..., nh, dh]: the one collective a layer.
        An f32 payload is cast to bf16 before the wire (JAX
        `gather_heads`: every rank rounds alike, and the wire halves);
        with quantized collectives it ships as int8 blocks."""
        if self.mp <= 1:
            return ctx
        if ctx.dtype == torch.float32:
            ctx = ctx.to(torch.bfloat16)
        if self.quantized:
            return quantized_all_gather(ctx, self.mp_ref,
                                        dim=ctx.ndim - 2)
        return all_gather(ctx, self.mp_ref, dim=ctx.ndim - 2)

    def psum_partial(self, partial):
        """Sum the ranks' f32 o-proj partials (the megakernel path's
        collective); quantized collectives run the two-hop int8 psum."""
        if self.mp <= 1:
            return partial
        if self.quantized:
            return quantized_psum(partial, self.mp_ref)
        return all_reduce(partial, self.mp_ref)

    def merge_attn_partials(self, m, l, acc):
        """Merge the cp ranks' online-softmax partials: M = max m,
        w = exp(m - M), l = sum l w, acc = sum acc w. Only the stats and
        the weighted accumulator cross the wire; with quantized
        collectives the accumulator takes the int8 psum, the stats stay
        exact."""
        if self.cp <= 1:
            return m, l, acc
        m_g = all_reduce(m, self.cp_ref, op="max")
        w = torch.exp(m - m_g)
        l_g = all_reduce(l * w, self.cp_ref)
        acc_w = acc * w[..., None]
        if self.quantized:
            acc_g = quantized_psum(acc_w, self.cp_ref)
        else:
            acc_g = all_reduce(acc_w, self.cp_ref)
        return m_g, l_g, acc_g

    def pps(self, pool) -> int:
        """Pages a cp rank owns, from its pool (rows past them: the sink
        row, `kernels.partial_attention`)."""
        return pool.shape[0] - 1 if self.cp > 1 else pool.shape[0]


def make_serving_tp(cfg, serving_mp: Optional[int] = None,
                    quantized_collectives: Optional[bool] = None,
                    serving_cp: Optional[int] = None):
    """ServingTP geometry for the resolved (mp, cp) degrees, or None at
    mp = cp = 1 (the single-device programs take no TP plumbing). The
    result is not bound to process groups yet (`ServingTP.bind`)."""
    mp = resolve_serving_mp(serving_mp)
    cp = resolve_serving_cp(serving_cp)
    if mp <= 1 and cp <= 1:
        return None
    return ServingTP(cfg, mp, quantized=quantized_collectives, cp=cp)


def _tp_sharded_name(name: str, tp: ServingTP) -> bool:
    return name.endswith("q_proj.weight") or (
        tp.kv_sharded and (name.endswith("k_proj.weight")
                           or name.endswith("v_proj.weight")))


def _tp_full_width(name: str, tp: ServingTP) -> int:
    n_heads = tp.nh if name.endswith("q_proj.weight") \
        else tp.nkv_local * tp.mp
    return n_heads * tp.head_dim


def shard_serving_params(params: dict, tp: ServingTP,
                         rank: Optional[int] = None) -> dict:
    """Rank `rank`'s slice of a decode-params dict (default: the rank tp
    is bound to): q, and k / v when the kv heads shard, split on their
    output-head axis -- dense [in, out] (or stacked [L, in, out]) on the
    last axis, weight-only pairs (w [out, in_packed], scale [out]; or
    stacked) on the output axis of both -- into copies of their own;
    everything else (o-proj included: it takes the gathered heads) is the
    caller's tensor, replicated. A dict already holding local widths is
    returned as it is."""
    m = (tp.rank if rank is None else int(rank)) % tp.mp
    out = dict(params)
    if tp.mp <= 1:
        return out
    for name, w in params.items():
        if not _tp_sharded_name(name, tp):
            continue
        full = _tp_full_width(name, tp)
        stacked = name.startswith(STACKED_PREFIX)
        if isinstance(w, tuple):
            ax = 1 if stacked else 0
            if w[0].shape[ax] != full:
                continue               # already this rank's slice
            n = full // tp.mp
            out[name] = tuple(a.narrow(ax, m * n, n).clone() for a in w)
        else:
            if w.shape[-1] != full:
                continue
            n = full // tp.mp
            out[name] = w.narrow(w.ndim - 1, m * n, n).contiguous()
    return out


def _tp_slice_o_proj(w, tp: ServingTP, spec_only: bool = False):
    """This rank's contraction slice of the (replicated) o-proj for the
    megakernel's partial: dense [nh dh, H] rows, or a pair's (w [H, nh
    dh]) columns with the per-output scale kept whole. `spec_only`
    returns meta tensors of the slice's shape (for the build-time plan)."""
    m = tp.m_index
    if isinstance(w, tuple):
        wq, sc = w
        k = wq.shape[1] // tp.mp
        if spec_only:
            return (torch.empty((wq.shape[0], k), dtype=wq.dtype,
                                device="meta"), sc)
        return (wq[:, m * k:(m + 1) * k].contiguous(), sc)
    k = w.shape[0] // tp.mp
    if spec_only:
        return torch.empty((k, w.shape[1]), dtype=w.dtype, device="meta")
    return w[m * k:(m + 1) * k]


def serving_block_size_candidates(cfg, *, prompt_bucket: int,
                                  kv_cache_dtype: str = "bf16",
                                  max_candidates: int = 2) -> list:
    """KV page sizes (``block_size``) a serving engine could be built at
    for this model, ascending: the divisors of `prompt_bucket` (whole
    pages a bucket, the engine's admission rule) that the card's kernels
    take. The paged decode and prefill kernels take any page; the
    megakernel's shared memory grows with it
    (`decode_megakernel.page_fits_card`, the limit its launch checks), so
    the static autotuner (analysis/tuner.py) proposes only pages the
    kernels serve. `max_candidates` > 0 keeps the largest that many
    (larger pages mean fewer table entries and scatter rows)."""
    from ..kernels.decode_megakernel import page_fits_card

    quant_kv = resolve_kv_cache_dtype(kv_cache_dtype) == "int8"
    extent = int(prompt_bucket)
    out = [bs for bs in range(1, extent + 1)
           if extent % bs == 0 and page_fits_card(cfg, bs, quant_kv)]
    return out[-max_candidates:] if max_candidates > 0 else out


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
            raise PageShardingError(
                f"fleet page count {self.max_pages} not divisible by "
                f"cp {cp}: the page axis shards contiguously "
                f"({self.max_pages % cp} pages would have no owner)")
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
