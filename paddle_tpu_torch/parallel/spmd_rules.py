"""Per-op SPMD rules for semi-auto sharding propagation (counterpart of
paddle_tpu/parallel/spmd_rules.py; reference:
paddle/phi/infermeta/spmd_rules/*.cc).

Each rule infers an op's output layout from its inputs' (and the reverse
rules, Paddle's InferSpmdReverse, an input layout from a constraint on
the output), through einsum-like axis notation:

    rule = get_spmd_rule("matmul")
    ins, outs, partial = rule.infer_forward((x_spec, x.shape),
                                            (w_spec, w.shape))

A "spec" is a tuple with one entry per tensor dim: a mesh-axis name, a
tuple of axis names, or None (replicated); outputs may carry `partial`
axes (contracted dims that were sharded). The rule table is plain Python
over spec tuples, the JAX module's own. Where the JAX package hands a
layout to XLA (``with_sharding_constraint``, ``device_put``), the port
lays a rank's blocks out itself through `api.reshard`
(`with_spmd_constraint`, `apply_backward_constraint`, `shard_parameters`).
"""
from __future__ import annotations

import string
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .placement import dist_attr, spec_to_placements

__all__ = ["SpmdRule", "get_spmd_rule", "register_spmd_rule",
           "register_spmd_reverse", "with_spmd_constraint",
           "shard_parameters", "infer_backward_layout",
           "apply_backward_constraint"]


Spec = Tuple  # per-dim: None | str | tuple of str


def _norm(spec, ndim: int) -> List:
    spec = [s[0] if isinstance(s, tuple) and len(s) == 1 else s
            for s in (spec or ())]
    spec += [None] * (ndim - len(spec))
    return spec[:ndim]


def _merge_axis(candidates: List) -> Optional[Any]:
    """Merge one notation letter's proposals from several inputs: first
    non-None wins; conflicts resolve to the first (the reference merges by
    shard count — first-wins matches its common path)."""
    for c in candidates:
        if c is not None:
            return c
    return None


def infer_einsum(notation: str, *in_specs_shapes):
    """Core engine (reference: ShardingMergeForTensors + the per-op
    notations). notation: e.g. "mk,kn->mn"; each input is (spec, shape).
    Returns (new_in_specs, out_spec, partial_axes)."""
    lhs, out_axes = notation.split("->")
    in_axes = lhs.split(",")
    if len(in_axes) != len(in_specs_shapes):
        raise ValueError(f"{notation}: expected {len(in_axes)} inputs")
    letter_map: Dict[str, List] = {}
    for axes, (spec, shape) in zip(in_axes, in_specs_shapes):
        spec = _norm(spec, len(axes))
        for i, letter in enumerate(axes):
            # size-1 dims never propagate sharding (broadcast semantics)
            if shape is not None and i < len(shape) and shape[i] == 1:
                continue
            letter_map.setdefault(letter, []).append(spec[i])
    merged = {k: _merge_axis(v) for k, v in letter_map.items()}
    new_ins = []
    for axes, (spec, shape) in zip(in_axes, in_specs_shapes):
        new_ins.append(tuple(
            None if (shape is not None and i < len(shape)
                     and shape[i] == 1) else merged.get(letter)
            for i, letter in enumerate(axes)))
    out = tuple(merged.get(letter) for letter in out_axes)
    # contracted letters that were sharded -> output is partial over them
    partial = []
    for letter, ax in merged.items():
        if letter not in out_axes and ax is not None:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                partial.append(a)
    return new_ins, out, tuple(partial)


def infer_einsum_backward(notation: str, in_specs_shapes, out_spec):
    """Reverse engine (reference: the InferSpmdReverse bodies, e.g.
    matmul.h:30): input specs derive ONLY from the output constraint —
    the reference's reverse tests assert existing input dims_mappings do
    not influence the result. Letters the output doesn't mention
    (contracted dims) come back replicated. Returns (new_in_specs,
    out_spec)."""
    lhs, out_axes = notation.split("->")
    in_axes = lhs.split(",")
    out_n = _norm(out_spec, len(out_axes))
    merged = {letter: out_n[i] for i, letter in enumerate(out_axes)}
    new_ins = []
    for axes, (spec, shape) in zip(in_axes, in_specs_shapes):
        new_ins.append(tuple(
            None if (shape is not None and i < len(shape) and shape[i] == 1)
            else merged.get(letter)
            for i, letter in enumerate(axes)))
    out = tuple(merged.get(letter) for letter in out_axes)
    return new_ins, out


class SpmdRule:
    """reference: phi::distributed::SpmdRule — infer_forward maps input
    dist attrs to (inferred input attrs, output attrs); infer_backward
    (the reference's InferSpmdReverse, e.g. matmul.h:30 MatmulInferSpmdReverse)
    maps a constraint on the OUTPUT back to input dist attrs."""

    def __init__(self, name: str, fn: Callable, rev: Optional[Callable] = None):
        self.name = name
        self._fn = fn
        self._rev = rev

    def infer_forward(self, *inputs, **attrs):
        """inputs: (spec, shape) pairs. Returns (in_specs, out_specs,
        partial_axes) — out_specs a single spec or list of specs."""
        return self._fn(*inputs, **attrs)

    def infer_backward(self, *inputs, out=None, **attrs):
        """inputs: (spec, shape) pairs (spec may be None); out: the output
        spec (or list of specs for multi-output ops) to propagate back.
        Returns (in_specs, out_spec) — the reference's InferSpmdReverse
        contract."""
        if self._rev is None:
            raise NotImplementedError(
                f"SPMD rule {self.name!r} has no reverse (InferSpmdReverse)")
        return self._rev(*inputs, out=out, **attrs)


_RULES: Dict[str, SpmdRule] = {}


def register_spmd_rule(name: str):
    """reference: PD_REGISTER_SPMD_RULE."""

    def deco(fn):
        rev = _RULES[name]._rev if name in _RULES else None
        _RULES[name] = SpmdRule(name, fn, rev)
        return fn

    return deco


def register_spmd_reverse(name: str):
    """Attach an InferSpmdReverse body to a registered rule."""

    def deco(fn):
        _RULES[name]._rev = fn
        return fn

    return deco


def get_spmd_rule(name: str) -> SpmdRule:
    """reference: phi.get_spmd_rule (used throughout
    test/auto_parallel/spmd_rules/)."""
    if name not in _RULES:
        raise ValueError(
            f"no SPMD rule for {name!r}; registered: {sorted(_RULES)}")
    return _RULES[name]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _letters(n: int, reserved: str = "") -> str:
    return "".join(c for c in string.ascii_lowercase
                   if c not in reserved)[:n]


@register_spmd_rule("matmul")
def _matmul(x, y, trans_x: bool = False, trans_y: bool = False):
    """reference: matmul.cc — mk,kn->mn with batched broadcasting."""
    (xs, xsh), (ys, ysh) = x, y
    xnd, ynd = len(xsh), len(ysh)
    if trans_x:
        xs = _norm(xs, xnd)
        xs[-2], xs[-1] = xs[-1], xs[-2]
        xsh = list(xsh)
        xsh[-2], xsh[-1] = xsh[-1], xsh[-2]
    if trans_y:
        ys = _norm(ys, ynd)
        ys[-2], ys[-1] = ys[-1], ys[-2]
        ysh = list(ysh)
        ysh[-2], ysh[-1] = ysh[-1], ysh[-2]
    batch = _letters(max(xnd, ynd) - 2, reserved="kmn")
    x_axes = batch[len(batch) - (xnd - 2):] + "mk" if xnd >= 2 else "k"
    y_axes = batch[len(batch) - (ynd - 2):] + "kn" if ynd >= 2 else "k"
    out_axes = batch + ("m" if xnd >= 2 else "") + ("n" if ynd >= 2 else "")
    ins, out, partial = infer_einsum(
        f"{x_axes},{y_axes}->{out_axes}", (xs, xsh), (ys, ysh))
    return ins, out, partial


@register_spmd_rule("elementwise")
def _elementwise(*inputs):
    """reference: elementwise.cc — right-aligned broadcast."""
    nd = max(len(sh) for _, sh in inputs)
    axes = _letters(nd)
    notated = []
    for spec, sh in inputs:
        notated.append((spec, sh))
    notation = ",".join(axes[nd - len(sh):] for _, sh in inputs) \
        + "->" + axes
    return infer_einsum(notation, *notated)


@register_spmd_rule("embedding")
def _embedding(ids, table):
    """reference: embedding.cc — out[b.., h] from ids[b..] + w[v, h];
    vocab sharding makes the output partial over those axes."""
    (ispec, ish), (tspec, tsh) = ids, table
    axes = _letters(len(ish), reserved="vh")
    notation = f"{axes},vh->{axes}h"
    return infer_einsum(notation, (ispec, ish), (tspec, tsh))


def _norm_rule(x, scale, bias=None, begin_norm_axis: int = -1):
    """layer_norm.cc / rms_norm.cc: normalized trailing dims must be
    replicated; leading dims keep their sharding; scale/bias replicated."""
    (xs, xsh) = x
    nd = len(xsh)
    if begin_norm_axis < 0:
        begin_norm_axis += nd
    xs = _norm(xs, nd)
    new_x = tuple(xs[i] if i < begin_norm_axis else None for i in range(nd))
    ins = [new_x, (None,) * len(scale[1])]
    if bias is not None:
        ins.append((None,) * len(bias[1]))
    return ins, new_x, ()


register_spmd_rule("layer_norm")(_norm_rule)
register_spmd_rule("rms_norm")(_norm_rule)


@register_spmd_rule("reduction")
def _reduction(x, axis=None, keepdim: bool = False):
    """reference: reduction.cc — reduced dims drop from the output; their
    sharding becomes partial."""
    (xs, xsh) = x
    nd = len(xsh)
    xs = _norm(xs, nd)
    if axis is None:
        axis = list(range(nd))
    axis = [a % nd for a in (axis if isinstance(axis, (list, tuple))
                             else [axis])]
    out = []
    partial = []
    for i in range(nd):
        if i in axis:
            if xs[i] is not None:
                ax = xs[i]
                partial += list(ax if isinstance(ax, tuple) else (ax,))
            if keepdim:
                out.append(None)
        else:
            out.append(xs[i])
    return [tuple(xs)], tuple(out), tuple(partial)


@register_spmd_rule("softmax")
def _softmax(x, axis: int = -1):
    """reference: softmax.cc — the softmax axis must be replicated."""
    (xs, xsh) = x
    nd = len(xsh)
    axis %= nd
    xs = _norm(xs, nd)
    new = tuple(None if i == axis else xs[i] for i in range(nd))
    return [new], new, ()


@register_spmd_rule("cross_entropy_with_softmax")
def _ce(logits, labels, axis: int = -1):
    """reference: cross_entropy_with_softmax.cc — softmax axis replicated
    (the mp-sharded-vocab fast path is ParallelCrossEntropy, mpu.py)."""
    (ls, lsh) = logits
    nd = len(lsh)
    axis %= nd
    ls = _norm(ls, nd)
    new_l = tuple(None if i == axis else ls[i] for i in range(nd))
    out = tuple(s for i, s in enumerate(new_l) if i != axis)
    return [new_l, out], out, ()


@register_spmd_rule("transpose")
def _transpose(x, perm: Sequence[int]):
    """reference: transpose.cc."""
    (xs, xsh) = x
    xs = _norm(xs, len(xsh))
    out = tuple(xs[p] for p in perm)
    return [tuple(xs)], out, ()


@register_spmd_rule("reshape")
def _reshape(x, shape: Sequence[int]):
    """reference: reshape.cc via dim_trans.cc — sharding survives when a
    sharded input dim maps to an output dim group whose FIRST factor is
    that dim's size multiple (the common merge/split cases)."""
    (xs, xsh) = x
    xs = _norm(xs, len(xsh))
    shape = list(shape)
    # resolve a single -1
    import numpy as np

    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = int(np.prod(xsh)) // max(known, 1)
    out = [None] * len(shape)
    ii = oi = 0
    while ii < len(xsh) and oi < len(shape):
        isz, osz = xsh[ii], shape[oi]
        if isz == osz:
            out[oi] = xs[ii]
            ii += 1
            oi += 1
        elif isz > osz:
            # split: the sharded input dim lands on the FIRST output
            # factor when divisible
            if xs[ii] is not None and osz % _axes_len(xs[ii]) == 0:
                out[oi] = xs[ii]
            group = osz
            oi += 1
            while oi < len(shape) and group < isz:
                group *= shape[oi]
                oi += 1
            ii += 1
        else:
            # merge: first input factor's sharding carries to the output
            if out[oi] is None:
                out[oi] = xs[ii]
            group = isz
            ii += 1
            while ii < len(xsh) and group < osz:
                group *= xsh[ii]
                ii += 1
            oi += 1
    return [tuple(xs)], tuple(out), ()


def _axes_len(ax) -> int:
    return len(ax) if isinstance(ax, tuple) else 1


@register_spmd_rule("flash_attention")
def _flash(q, k, v):
    """reference: flash_attention.cc — [b, s, h, d]: batch/head shardings
    merge; seq of kv + head dim stay replicated inside the kernel."""
    (qs, qsh), (ks, ksh), (vs, vsh) = q, k, v
    ins, out, partial = infer_einsum(
        "bshd,bthd,bthd->bshd", (qs, qsh), (ks, ksh), (vs, vsh))
    # d must be replicated; t (kv seq) must be gathered for the kernel
    ins = [tuple((s[0], s[1], s[2], None)) for s in ins]
    ins[1] = (ins[1][0], None, ins[1][2], None)
    ins[2] = (ins[2][0], None, ins[2][2], None)
    out = (out[0], out[1], out[2], None)
    return ins, out, partial


@register_spmd_rule("fused_rope")
def _rope(q, *rest):
    specs = [q] + list(rest)
    ins = []
    for spec, sh in specs:
        s = _norm(spec, len(sh))
        # rotate mixes the last dim: keep it replicated
        s[-1] = None
        ins.append(tuple(s))
    return ins, list(ins[:max(1, len(ins))]), ()


@register_spmd_rule("concat")
def _concat(*inputs, axis: int = 0):
    nd = len(inputs[0][1])
    axis %= nd
    merged = []
    for i in range(nd):
        if i == axis:
            merged.append(None)  # concat dim cannot stay sharded
        else:
            merged.append(_merge_axis(
                [_norm(s, nd)[i] for s, _ in inputs]))
    spec = tuple(merged)
    return [spec] * len(inputs), spec, ()


@register_spmd_rule("split")
def _split(x, num_or_sections=None, axis: int = 0):
    (xs, xsh) = x
    nd = len(xsh)
    axis %= nd
    xs = _norm(xs, nd)
    new = tuple(None if i == axis else xs[i] for i in range(nd))
    n = num_or_sections if isinstance(num_or_sections, int) \
        else len(num_or_sections or [1])
    return [new], [new] * n, ()


@register_spmd_rule("slice")
def _slice(x, axes: Sequence[int] = ()):
    (xs, xsh) = x
    nd = len(xsh)
    xs = _norm(xs, nd)
    new = tuple(None if i in [a % nd for a in axes] else xs[i]
                for i in range(nd))
    return [new], new, ()


@register_spmd_rule("default_data_parallel")
def _ddp(*inputs):
    """reference: default_data_parallel.cc — shard dim 0 like the first
    input everywhere, replicate the rest."""
    lead = _norm(inputs[0][0], len(inputs[0][1]))[0]
    ins = [tuple([lead] + [None] * (len(sh) - 1)) for _, sh in inputs]
    return ins, ins[0] if len(ins) == 1 else list(ins), ()


@register_spmd_rule("replicated")
def _replicated(*inputs):
    """reference: replicated.cc — the conservative fallback."""
    ins = [(None,) * len(sh) for _, sh in inputs]
    return ins, ins[0] if len(ins) == 1 else list(ins), ()


# share rule bodies the way the reference maps many ops onto a few Infer
# functions: shape-preserving ops -> elementwise; scan/axis ops -> the
# axis-replicated rule; dim-count changers -> reshape; the rest fall back
# to the conservative replicated rule
for _name in ("cast", "scale", "pow", "full_like", "where", "triu",
              "add_n", "swiglu"):
    _RULES[_name] = SpmdRule(_name, _elementwise)
for _name in ("cumsum",):
    _RULES[_name] = SpmdRule(_name, _softmax)
for _name in ("argmax", "numel", "squared_l2_norm"):
    _RULES[_name] = SpmdRule(_name, _reduction)
for _name in ("flatten", "squeeze", "unsqueeze"):
    _RULES[_name] = SpmdRule(_name, _reshape)
for _name in ("gather", "gather_nd", "one_hot", "tile", "expand_as",
              "stack", "scatter", "unbind", "dim_trans", "amp_ops",
              "optimizer"):
    _RULES[_name] = SpmdRule(_name, _replicated)


# ---------------------------------------------------------------------------
# reverse (InferSpmdReverse) bodies for the high-traffic rules
# reference: paddle/phi/infermeta/spmd_rules/*.h *InferSpmdReverse
# ---------------------------------------------------------------------------

def _matmul_notation(xnd, ynd):
    batch = _letters(max(xnd, ynd) - 2, reserved="kmn")
    x_axes = batch[len(batch) - (xnd - 2):] + "mk" if xnd >= 2 else "k"
    y_axes = batch[len(batch) - (ynd - 2):] + "kn" if ynd >= 2 else "k"
    out_axes = batch + ("m" if xnd >= 2 else "") + ("n" if ynd >= 2 else "")
    return f"{x_axes},{y_axes}->{out_axes}"


@register_spmd_reverse("matmul")
def _matmul_rev(x, y, out=None, trans_x: bool = False, trans_y: bool = False):
    """reference: matmul.h:30 MatmulInferSpmdReverse."""
    (xs, xsh), (ys, ysh) = x, y
    xnd, ynd = len(xsh), len(ysh)
    xs, ys = _norm(xs, xnd), _norm(ys, ynd)
    xsh, ysh = list(xsh), list(ysh)
    if trans_x and xnd >= 2:
        xs[-2], xs[-1] = xs[-1], xs[-2]
        xsh[-2], xsh[-1] = xsh[-1], xsh[-2]
    if trans_y and ynd >= 2:
        ys[-2], ys[-1] = ys[-1], ys[-2]
        ysh[-2], ysh[-1] = ysh[-1], ysh[-2]
    ins, o = infer_einsum_backward(
        _matmul_notation(xnd, ynd), [(xs, xsh), (ys, ysh)], out)
    nx, ny = list(ins[0]), list(ins[1])
    if trans_x and xnd >= 2:
        nx[-2], nx[-1] = nx[-1], nx[-2]
    if trans_y and ynd >= 2:
        ny[-2], ny[-1] = ny[-1], ny[-2]
    return [tuple(nx), tuple(ny)], o


@register_spmd_reverse("elementwise")
def _elementwise_rev(*inputs, out=None):
    nd = max(len(sh) for _, sh in inputs)
    axes = _letters(nd)
    notation = ",".join(axes[nd - len(sh):] for _, sh in inputs) + "->" + axes
    return infer_einsum_backward(notation, list(inputs), out)


@register_spmd_reverse("embedding")
def _embedding_rev(ids, table, out=None):
    """reference: embedding.h EmbeddingInferSpmdReverse — batch axes flow
    back to ids; the hidden axis to the table's column; vocab comes back
    None (apply_backward_constraint preserves an existing vocab sharding,
    since it never appears in the output)."""
    (ispec, ish), (tspec, tsh) = ids, table
    axes = _letters(len(ish), reserved="vh")
    return infer_einsum_backward(
        f"{axes},vh->{axes}h", [(ispec, ish), (tspec, tsh)], out)


def _norm_rule_rev(x, scale, bias=None, out=None, begin_norm_axis: int = -1):
    """layer_norm.h/rms_norm.h reverse: leading output axes flow back to
    the input; normalized trailing dims and scale/bias stay replicated."""
    (xs, xsh) = x
    nd = len(xsh)
    if begin_norm_axis < 0:
        begin_norm_axis += nd
    o = _norm(out, nd)
    new_x = tuple(o[i] if i < begin_norm_axis else None for i in range(nd))
    ins = [new_x, (None,) * len(scale[1])]
    if bias is not None:
        ins.append((None,) * len(bias[1]))
    return ins, new_x


register_spmd_reverse("layer_norm")(_norm_rule_rev)
register_spmd_reverse("rms_norm")(_norm_rule_rev)


@register_spmd_reverse("reduction")
def _reduction_rev(x, out=None, axis=None, keepdim: bool = False):
    """reference: reduction.h ReductionInferSpmdReverse — kept output dims
    flow back; reduced dims keep their existing input sharding."""
    (xs, xsh) = x
    nd = len(xsh)
    xs = _norm(xs, nd)
    if axis is None:
        axis = list(range(nd))
    axis = [a % nd for a in (axis if isinstance(axis, (list, tuple))
                             else [axis])]
    kept = [i for i in range(nd) if i not in axis]
    o = _norm(out, nd if keepdim else len(kept))
    new = list(xs)
    if keepdim:
        for i in kept:
            new[i] = o[i]
    else:
        for oi, i in enumerate(kept):
            new[i] = o[oi]
    return [tuple(new)], tuple(o)


@register_spmd_reverse("softmax")
def _softmax_rev(x, out=None, axis: int = -1):
    (xs, xsh) = x
    nd = len(xsh)
    axis %= nd
    o = _norm(out, nd)
    new = tuple(None if i == axis else o[i] for i in range(nd))
    return [new], new


@register_spmd_reverse("transpose")
def _transpose_rev(x, out=None, perm: Sequence[int] = ()):
    (xs, xsh) = x
    nd = len(xsh)
    o = _norm(out, nd)
    new = [None] * nd
    for out_i, in_i in enumerate(perm):
        new[in_i] = o[out_i]
    return [tuple(new)], tuple(o)


@register_spmd_reverse("reshape")
def _reshape_rev(x, out=None, shape: Sequence[int] = ()):
    """reshape.h reverse: run the forward dim-matching with the roles
    swapped (output spec+shape is the 'input')."""
    (xs, xsh) = x
    shape = list(shape)
    import numpy as np

    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = int(np.prod(xsh)) // max(known, 1)
    ins, o, _ = _reshape((out, tuple(shape)), tuple(xsh))
    return [o], tuple(_norm(out, len(shape)))


@register_spmd_reverse("flash_attention")
def _flash_rev(q, k, v, out=None):
    """flash_attention.h reverse: batch/head flow back to q/k/v; q's seq
    axis from the output seq; kv seq + head dim replicated."""
    o = _norm(out, 4)
    qspec = (o[0], o[1], o[2], None)
    kvspec = (o[0], None, o[2], None)
    return [qspec, kvspec, kvspec], tuple(o[:3]) + (None,)


@register_spmd_reverse("split")
def _split_rev(x, out=None, num_or_sections=None, axis: int = 0):
    (xs, xsh) = x
    nd = len(xsh)
    axis %= nd
    outs = out if isinstance(out, list) else [out]
    merged = []
    for i in range(nd):
        if i == axis:
            merged.append(None)
        else:
            merged.append(_merge_axis([_norm(o, nd)[i] for o in outs]))
    spec = tuple(merged)
    return [spec], [spec] * len(outs)


@register_spmd_reverse("cross_entropy_with_softmax")
def _ce_rev(logits, labels, out=None, axis: int = -1):
    (ls, lsh) = logits
    nd = len(lsh)
    axis %= nd
    o = _norm(out, nd - 1)
    new_l = []
    oi = 0
    for i in range(nd):
        if i == axis:
            new_l.append(None)
        else:
            new_l.append(o[oi])
            oi += 1
    return [tuple(new_l), tuple(o)], tuple(o)


def infer_backward_layout(op_name: str, out_spec, *inputs, **attrs):
    """Back-propagate a sharding constraint placed on an op's OUTPUT to
    its inputs (the user-facing face of InferSpmdReverse): returns one
    spec per input. Following the reference's reverse contract, specs
    derive from the output alone — dims the output doesn't mention come
    back None (apply_backward_constraint layers existing shardings back
    on top for those)."""
    rule = get_spmd_rule(op_name)
    ins, _ = rule.infer_backward(*inputs, out=out_spec, **attrs)
    return ins


# ---------------------------------------------------------------------------
# application helpers: a rank's blocks laid out through api.reshard
# ---------------------------------------------------------------------------

def _spec_of(t) -> Tuple:
    attr = dist_attr(t)
    if attr is not None:
        return tuple(_norm(tuple(attr.spec), len(attr.global_shape)))
    return (None,) * t.ndim


def _shape_of(t) -> tuple:
    attr = dist_attr(t)
    return tuple(attr.global_shape) if attr is not None else tuple(t.shape)


def _axes_in_mesh(ax, mesh) -> bool:
    names = (ax,) if isinstance(ax, str) else tuple(ax)
    return all(n in mesh.axis_names for n in names)


def _lay_out(t, spec, mesh):
    """`t` resharded to `spec` (axes outside the mesh dropped)."""
    from .api import reshard

    keep = tuple(a if (a is None or _axes_in_mesh(a, mesh)) else None
                 for a in spec)
    return reshard(t, mesh, spec_to_placements(keep, mesh))


def with_spmd_constraint(op_name: str, out, *inputs, mesh=None,
                         in_specs: Optional[Sequence] = None, **attrs):
    """`out` (this rank's block of an op's result, taken as replicated
    when it carries no layout) laid out as the op's rule infers from its
    `inputs`' layouts (read off their DistAttrs, or `in_specs`). Without a
    mesh, `out` is returned."""
    from . import mesh as mesh_mod

    mesh = mesh or mesh_mod.get_global_mesh()
    if mesh is None:
        return out
    if in_specs is None:
        in_specs = [_spec_of(a) for a in inputs]
    rule = get_spmd_rule(op_name)
    _, out_spec, _ = rule.infer_forward(
        *[(s, _shape_of(a)) for s, a in zip(in_specs, inputs)], **attrs)
    if not isinstance(out_spec, tuple):
        return out
    return _lay_out(out, out_spec, mesh)


def apply_backward_constraint(op_name: str, out_spec, *tensors, mesh=None,
                              **attrs):
    """Lay an op's inputs (typically parameters) out from a constraint on
    its OUTPUT (InferSpmdReverse): each tensor's block is resharded, in
    place of its data, to the spec the reverse rule infers, dims the
    constraint does not reach keeping their layout unless an axis the
    constraint claims sits there. Returns the specs."""
    from . import mesh as mesh_mod

    mesh = mesh or mesh_mod.get_global_mesh()
    cur_specs = [_spec_of(t) for t in tensors]
    ins = infer_backward_layout(
        op_name, out_spec, *[(s, _shape_of(t))
                             for s, t in zip(cur_specs, tensors)], **attrs)
    claimed = set()
    for spec in ins:
        for s in spec:
            if s is not None:
                claimed.update(s if isinstance(s, tuple) else (s,))
    merged = []
    for spec, cur in zip(ins, cur_specs):
        merged.append(tuple(
            s if s is not None else
            (c if (c is None or all(
                a not in claimed for a in (c if isinstance(c, tuple) else (c,))
            )) else None)
            for s, c in zip(spec, cur)))
    if mesh is None:
        return merged
    for t, spec in zip(tensors, merged):
        placed = _lay_out(t, spec, mesh)
        t.data = placed.detach()
        t._dist = placed._dist
    return merged


def shard_parameters(model, mesh, rules: Sequence[Tuple[str, Tuple]],
                     default: Optional[Tuple] = None):
    """Lay a model's parameters out from a (name-suffix, dims) table (the
    generic form of shard_llama's rules, for any module): each parameter
    (every rank holding the same global value) becomes this rank's block,
    a dim keeping the longest prefix of its axes whose product divides
    it."""
    from .api import shard_tensor
    from .mesh import divisible_prefix

    for name, p in list(model.named_parameters()):
        dims = default
        for suffix, d in rules:
            if name.endswith(suffix):
                dims = d
                break
        if dims is None:
            continue
        spec = []
        for i in range(p.ndim):
            d = dims[i] if i < len(dims) else None
            if d is None:
                spec.append(None)
                continue
            names = (d,) if isinstance(d, str) else tuple(d)
            kept = divisible_prefix(mesh, p.shape[i], names)
            spec.append(kept[0] if len(kept) == 1 else (kept or None))
        path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(path) if path else model
        setattr(mod, leaf, shard_tensor(p, mesh,
                                        spec_to_placements(spec, mesh)))
    return model
