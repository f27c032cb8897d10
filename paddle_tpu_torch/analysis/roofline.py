"""Static roofline auditor: FLOPs and HBM bytes of a traced torch
program -> predicted time on a device row (counterpart of
paddle_tpu/analysis/roofline.py).

- **FLOPs**: products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``convolution``) count 2·B·M·N·K; reductions their input elements;
  arithmetic its output elements; data movement none. Each hand-written
  kernel operator takes its closed-form model from the `KernelConstraint`
  registry (``kernels/constraints.py``), the counts ``PERF.md``'s bound
  column divides: the paged kernels count the pages their tables name,
  not the pool.
- **HBM bytes, eager**: the port runs every operator as a kernel of its
  own (a replayed CUDA graph replays the same kernels), and nothing fuses
  them. So every call that launches reads its inputs (each distinct
  buffer once) and writes its outputs; a view launches nothing and moves
  nothing. An in-place update (``index_put_``, ``copy_``) moves only the
  update's bytes; a gather (``index``, ``embedding``) moves its result's.
  The JAX pass models XLA fusion instead (an elementwise chain is free),
  so on the same model the port's bytes are higher by its elementwise
  traffic.
- **No loops**: a torch graph is unrolled, so each node counts once and
  the decode chunk's steps and layers are all in the graph.
- **Predicted time** = ``max(compute, bandwidth) + launches x
  launch_overhead_s`` against one `device_specs` row (the card has no
  collectives yet: wire time is 0). A hand-written kernel's node is
  priced at the share of its bound the kernel reaches on that row
  (`DeviceSpec.kernel_shares`, measured on the card): its FLOPs and
  bytes take their time divided by that share. Products and the other
  operators are PyTorch's own and are priced at their bound.

Three rules ride the pass (memoized per device row):

  TPU901 bandwidth-bound-   WARNING: a call repeated in the program
         repeated           (same operator and shapes) whose intensity is
                            below the row's ridge point and whose summed
                            HBM time is >= `min_amplified_ms`.
  TPU902 padding-waste      WARNING: more than `min_fraction` of the
                            products' tensor-core FLOPs are tile padding.
  TPU903 launch-overhead-   WARNING: launch overhead is >= `max_fraction`
         bound              of the predicted time.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional

import torch

from ..kernels import _build
from ..kernels.constraints import constraint_for_op, dtype_name
from .device_specs import DEVICE_SPECS, DeviceSpec, get_spec
from .diagnostics import Diagnostic, Severity
from .graph import Graph, NodeCtx, trace_graph
from .rules import MATMUL_OPS, MMA_TILE, Rule, matmul_dims, register_rule

# calls that launch nothing: allocations and metadata
_NO_LAUNCH = frozenset({"empty", "empty_like", "new_empty", "empty_strided",
                        "new_empty_strided", "detach", "lift_fresh",
                        "sym_size", "sym_stride", "sym_numel",
                        "_local_scalar_dense"})
# gathers: read and write the result's bytes (an embedding lookup reads
# B rows, not the table)
_GATHERS = frozenset({"index", "gather", "index_select", "embedding",
                      "take", "take_along_dim"})
_REDUCTIONS = frozenset({"sum", "mean", "amax", "amin", "max", "min",
                         "argmax", "argmin", "prod", "var", "std",
                         "logsumexp", "norm", "linalg_vector_norm", "any",
                         "all", "_softmax", "_log_softmax", "cumsum",
                         "sort", "topk", "nll_loss_forward",
                         "nll_loss_backward", "_softmax_backward_data",
                         "_log_softmax_backward_data"})
# data movement: no FLOPs
_MOVES = frozenset({"_to_copy", "clone", "copy", "copy_", "cat", "stack",
                    "index_put", "index_put_", "_index_put_impl_",
                    "scatter", "scatter_", "slice_scatter", "select_scatter",
                    "zeros", "zeros_like", "ones", "ones_like", "full",
                    "full_like", "fill", "fill_", "zero_", "arange",
                    "scalar_tensor", "new_zeros", "new_ones", "new_full",
                    "constant_pad_nd", "repeat", "repeat_interleave",
                    "expand_copy", "_unsafe_view", "contiguous",
                    "masked_fill", "masked_fill_", "where", "tril", "triu",
                    "flip", "roll"})
# in-place updates: move the update's bytes only
_UPDATES = {"index_put_": 2, "_index_put_impl_": 2, "copy_": 1,
            "scatter_": 3, "index_copy_": 3, "slice_scatter": 1}


def launches_of(ctx: NodeCtx) -> bool:
    """Whether the call launches a kernel on the card: every operator but
    the views (results aliasing an argument, not written), allocations
    and host calls."""
    if not isinstance(ctx.node.target, torch._ops.OpOverload):
        return False
    if ctx.namespace == "paddle_tpu":
        return ctx.is_kernel
    if ctx.packet in _NO_LAUNCH:
        return False
    schema = ctx.schema
    rets = schema.returns if schema is not None else []
    if rets and all(r.alias_info is not None and not r.alias_info.is_write
                    for r in rets):
        return False                      # a view
    return True


def kernel_counter(ctx: NodeCtx) -> Optional[str]:
    """The launch counter (``kernels._build.LAUNCHES``) a kernel node
    adds one to on the card."""
    if not ctx.is_kernel:
        return None
    a = ctx.args
    name = a.get("what", ctx.packet)
    int8 = (a.get("k_scale") is not None
            if ctx.packet in ("paged_decode_attention",
                              "paged_prefill_attention")
            else ctx.packet == "decode_megakernel"
            and a["k_cache"].dtype == torch.int8)
    return name + (_build.INT8_SUFFIX if int8 else "")


def kernel_launches(graph: Graph) -> Dict[str, int]:
    """{launch counter: kernel nodes}: what one eager run of the program
    adds to the launch counters on the card."""
    out: Dict[str, int] = {}
    for ctx in graph.kernel_nodes():
        name = kernel_counter(ctx)
        out[name] = out.get(name, 0) + 1
    return out


def count_kernel_launches(graph: Graph) -> int:
    """Hand-written kernel launches plus products (the JAX package's
    inventory: pallas_call + dot_general) in one run of a program."""
    return sum(1 for c in graph.nodes()
               if c.is_kernel or matmul_dims(c) is not None)


def count_step_kernels(step_fn, *args, **kwargs) -> int:
    """Trace and count in one call."""
    return count_kernel_launches(trace_graph(step_fn, *args, **kwargs))


@dataclasses.dataclass
class EqnCost:
    """The cost of one call (`count` is always 1: torch graphs unroll)."""

    path: str
    prim: str
    dtype: str
    shape: tuple
    flops: int
    hbm_bytes: int
    padded_flops: int
    count: int = 1
    in_loop: bool = False
    kernel: Optional[str] = None     # the launch counter of a kernel node

    @property
    def total_flops(self) -> int:
        return self.flops * self.count

    @property
    def total_bytes(self) -> int:
        return self.hbm_bytes * self.count

    @property
    def intensity(self) -> float:
        return self.flops / self.hbm_bytes if self.hbm_bytes else \
            float("inf") if self.flops else 0.0

    def bandwidth_s(self, spec: DeviceSpec) -> float:
        return self.total_bytes / spec.hbm_gbs / spec.share_for(self.kernel)

    def compute_s(self, spec: DeviceSpec) -> float:
        return self.total_flops / spec.peak_for(self.dtype) \
            / spec.share_for(self.kernel)

    def to_dict(self) -> dict:
        return {
            "path": self.path, "prim": self.prim, "dtype": self.dtype,
            "shape": list(self.shape), "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "padded_flops": self.padded_flops,
            "count": self.count, "total_flops": self.total_flops,
            "total_bytes": self.total_bytes,
            "intensity": round(self.intensity, 3)
            if self.intensity != float("inf") else None,
            "in_loop": self.in_loop,
        }


class RooflineReport:
    """The FLOPs / bytes pass priced on one device row."""

    def __init__(self, name: str, events: List[EqnCost], spec: DeviceSpec,
                 launches: int, n_eqns: int, kernels: Dict[str, int]):
        self.name = name
        self.events = events
        self.spec = spec
        self.wire_bytes = 0
        self.kernel_launches = launches
        self.kernels = kernels
        self.mp = 1
        self.n_eqns = n_eqns

    @property
    def total_flops(self) -> int:
        return sum(e.total_flops for e in self.events)

    @property
    def total_hbm_bytes(self) -> int:
        return sum(e.total_bytes for e in self.events)

    def flops_by_dtype(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            if e.flops:
                out[e.dtype] = out.get(e.dtype, 0) + e.total_flops
        return out

    @property
    def matmul_flops(self) -> int:
        """FLOPs of the products outside the kernels (the JAX pass's
        dot_general FLOPs)."""
        return sum(e.total_flops for e in self.events
                   if e.prim.split(".")[1] in MATMUL_OPS)

    @property
    def padding_waste_flops(self) -> int:
        return sum((e.padded_flops - e.flops) * e.count for e in self.events)

    @property
    def total_padded_flops(self) -> int:
        return sum(e.padded_flops * e.count for e in self.events)

    @property
    def padding_waste_fraction(self) -> float:
        padded = self.total_padded_flops
        return self.padding_waste_flops / padded if padded else 0.0

    @property
    def compute_s(self) -> float:
        return sum(e.compute_s(self.spec) for e in self.events)

    @property
    def bandwidth_s(self) -> float:
        return sum(e.bandwidth_s(self.spec) for e in self.events)

    @property
    def wire_s(self) -> float:
        return 0.0

    @property
    def launch_overhead_s(self) -> float:
        return self.kernel_launches * self.spec.launch_overhead_s

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s > self.bandwidth_s \
            else "bandwidth"

    @property
    def predicted_step_s(self) -> float:
        return max(self.compute_s, self.bandwidth_s) \
            + self.launch_overhead_s

    @property
    def predicted_step_ms(self) -> float:
        return self.predicted_step_s * 1e3

    @property
    def predicted_mfu(self) -> float:
        by_dtype = self.flops_by_dtype()
        if not by_dtype or self.predicted_step_s <= 0:
            return 0.0
        dominant = max(by_dtype, key=by_dtype.get)
        return self.total_flops / (self.predicted_step_s
                                   * self.spec.peak_for(dominant))

    def bottlenecks(self, top: int = 8) -> List[EqnCost]:
        return sorted(self.events,
                      key=lambda e: -max(e.compute_s(self.spec),
                                         e.bandwidth_s(self.spec)))[:top]

    def to_dict(self, max_events: int = 16) -> dict:
        return {
            "target": self.name,
            "device": self.spec.name,
            "per_chip": True,
            "mp": self.mp,
            "n_eqns": self.n_eqns,
            "flops": self.total_flops,
            "flops_by_dtype": self.flops_by_dtype(),
            "hbm_bytes": self.total_hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "kernel_launches": self.kernel_launches,
            "kernels": dict(self.kernels),
            "compute_ms": self.compute_s * 1e3,
            "bandwidth_ms": self.bandwidth_s * 1e3,
            "wire_ms": 0.0,
            "launch_overhead_ms": self.launch_overhead_s * 1e3,
            "predicted_step_ms": self.predicted_step_ms,
            "predicted_mfu": round(self.predicted_mfu, 4),
            "bound": self.bound,
            "padding_waste_flops": self.padding_waste_flops,
            "padding_waste_fraction": round(self.padding_waste_fraction, 4),
            "bottlenecks": [e.to_dict()
                            for e in self.bottlenecks(max_events)],
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    def format(self, top: int = 8) -> str:
        lines = [
            f"roofline audit {self.name} on {self.spec.name}: predicted "
            f"{self.predicted_step_ms:.4f} ms per run, {self.bound}-bound, "
            f"mfu {self.predicted_mfu:.3f} ({self.n_eqns} calls)",
            f"  compute {self.compute_s * 1e3:.4f} ms "
            f"({self.total_flops / 1e9:.3f} GFLOP) | bandwidth "
            f"{self.bandwidth_s * 1e3:.4f} ms "
            f"({self.total_hbm_bytes / (1 << 20):.2f} MiB) | launch "
            f"{self.launch_overhead_s * 1e3:.4f} ms "
            f"({self.kernel_launches} launches, hand-written kernels "
            f"{dict(sorted(self.kernels.items()))})",
        ]
        if self.padding_waste_flops:
            lines.append(f"  tile padding: "
                         f"{self.padding_waste_fraction * 100:.1f}% of the "
                         "products' tensor-core FLOPs")
        ridge = self.spec.ridge_point("bfloat16")
        for e in self.bottlenecks(top):
            inten = "inf" if e.intensity == float("inf") \
                else f"{e.intensity:.1f}"
            side = "bw" if e.intensity < ridge else "compute"
            t = max(e.compute_s(self.spec), e.bandwidth_s(self.spec))
            lines.append(f"    {t * 1e3:9.4f} ms  {e.prim} {e.dtype}"
                         f"{list(e.shape)}  intensity {inten} ({side})"
                         f"  {e.path}")
        return "\n".join(lines)


def _padded(m: int, n: int, k: int, b: int, dtype) -> int:
    tile = MMA_TILE.get(dtype)
    if tile is None:
        return 2 * b * m * n * k

    def up(x, t):
        return -(-x // t) * t

    return 2 * b * up(m, tile[0]) * up(n, tile[1]) * up(k, tile[2])


def _cost(ctx: NodeCtx) -> Optional[EqnCost]:
    """The cost of one launching call."""
    outs = ctx.outputs
    out_bytes = sum(m.nbytes for m in outs)
    out_elems = sum(m.numel for m in outs)
    shape = outs[0].shape if outs else ()
    ins = ctx.input_metas()
    # each distinct input node once
    seen, in_bytes = set(), 0
    for n in ctx.node.all_input_nodes:
        if n in seen:
            continue
        seen.add(n)
        v = n.meta.get("val")
        if isinstance(v, torch.Tensor):
            in_bytes += v.numel() * v.element_size()
    if ctx.is_kernel:
        c = constraint_for_op(ctx.packet)
        model = c.roofline(ctx.args) if c and c.roofline else None
        # the largest operand's dtype prices the kernel (the streamed pool
        # or weight, not the f32 scales beside it)
        biggest = max(ins, key=lambda m: m.nbytes, default=None)
        dt = dtype_name(biggest.dtype) if biggest else "?"
        if model is None:
            model = {"flops": 0, "hbm_bytes": in_bytes + out_bytes}
        return EqnCost(ctx.path, ctx.op, dt, shape, int(model["flops"]),
                       int(model["hbm_bytes"]), int(model["flops"]),
                       kernel=kernel_counter(ctx))
    dims = matmul_dims(ctx)
    if dims is not None:
        b, m, n, k, dt = dims
        flops = 2 * b * m * n * k
        return EqnCost(ctx.path, ctx.op, dtype_name(dt), shape, flops,
                       in_bytes + out_bytes,
                       max(_padded(m, n, k, b, dt), flops))
    name = ctx.packet
    dt = dtype_name(outs[0].dtype) if outs else "?"
    if name in _UPDATES:
        idx = _UPDATES[name]
        args = ctx.node.args
        upd = args[idx] if idx < len(args) else None
        v = getattr(upd, "meta", {}).get("val")
        ub = v.numel() * v.element_size() if isinstance(v, torch.Tensor) \
            else out_bytes
        return EqnCost(ctx.path, ctx.op, dt, shape, 0, 2 * ub, 0)
    if name in _GATHERS:
        return EqnCost(ctx.path, ctx.op, dt, shape, 0, 2 * out_bytes, 0)
    if name in _REDUCTIONS:
        flops = sum(m.numel for m in ins)
        return EqnCost(ctx.path, ctx.op, dt, shape, flops,
                       in_bytes + out_bytes, flops)
    flops = 0 if name in _MOVES or name.startswith("_foreach_copy") \
        else out_elems
    if name.startswith("_foreach_") and name.endswith("_"):
        # in place over lists: every list element read, the targets
        # written
        target = ctx.node.args[0]
        tb = sum(x.meta["val"].numel() * x.meta["val"].element_size()
                 for x in target) if isinstance(target, (list, tuple)) \
            else 0
        flops = sum(x.meta["val"].numel() for x in target) \
            if isinstance(target, (list, tuple)) else 0
        return EqnCost(ctx.path, ctx.op, dt, shape, flops, in_bytes + tb,
                       flops)
    return EqnCost(ctx.path, ctx.op, dt, shape, flops, in_bytes + out_bytes,
                   flops)


def _walk(graph: Graph):
    events, launches = [], 0
    for ctx in graph.nodes():
        if not launches_of(ctx):
            continue
        launches += 1
        e = _cost(ctx)
        if e is not None:
            events.append(e)
    return events, launches


def audit_graph(graph: Graph, device=None) -> RooflineReport:
    """The roofline pass over a traced `Graph`, priced on one device row
    (the walk runs once a graph; each registered row's report is kept)."""
    spec = get_spec(device)
    cache = getattr(graph, "_roofline_reports", None)
    if cache is None:
        cache = graph._roofline_reports = {}
    registered = DEVICE_SPECS.get(spec.name) is spec
    rep = cache.get(spec.name) if registered else None
    if rep is None:
        raw = getattr(graph, "_roofline_raw", None)
        if raw is None:
            raw = graph._roofline_raw = _walk(graph)
        events, launches = raw
        rep = RooflineReport(graph.name, events, spec, launches,
                             len(graph.nodes()), kernel_launches(graph))
        if registered:
            cache[spec.name] = rep
    return rep


def audit_roofline(fn, *args, device=None, name: Optional[str] = None,
                   **kwargs) -> RooflineReport:
    """Trace and audit in one call (nothing runs). `device` is a row
    name, a `DeviceSpec`, or None (the card's row, else the H100's)."""
    return audit_graph(trace_graph(fn, *args, name=name, **kwargs),
                       device=device)


def resolve_audit_roofline(audit_roofline_param: Optional[bool]) -> bool:
    """An explicit True / False wins; None follows FLAGS_audit_roofline
    (PADDLE_TPU_AUDIT_ROOFLINE) or PADDLE_TPU_LINT, which implies it."""
    if audit_roofline_param is not None:
        return bool(audit_roofline_param)
    from ..framework.flags import flag

    return bool(flag("audit_roofline")) or bool(flag("tpu_lint"))


@register_rule
class BandwidthBoundLoopRule(Rule):
    """TPU901: a call the program repeats (the same operator and shapes:
    a layer's or a step's, unrolled) whose intensity is below the row's
    ridge point and whose summed HBM time is at least `min_amplified_ms`
    (default 0.5 ms; 0 disables): memory-bound work done over and over,
    the feeder for fusion and for quantized streams."""

    id = "TPU901"
    name = "bandwidth-bound-in-loop"
    default_severity = Severity.WARNING
    MIN_AMPLIFIED_MS = 0.5
    MAX_REPORTS = 4

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        min_ms = float(self.config.get("min_amplified_ms",
                                       self.MIN_AMPLIFIED_MS) or 0)
        if min_ms <= 0:
            return
        rep = audit_graph(graph, self.config.get("device"))
        spec = rep.spec
        groups: Dict[tuple, List[EqnCost]] = {}
        for e in rep.events:
            if e.hbm_bytes:
                groups.setdefault((e.prim, e.shape, e.dtype, e.flops,
                                   e.hbm_bytes), []).append(e)
        found = []
        for (prim, shape, dt, flops, nb), evs in groups.items():
            if len(evs) < 2:
                continue
            ridge = spec.ridge_point(dt)
            if evs[0].intensity >= ridge:
                continue
            bw_ms = sum(e.bandwidth_s(spec) for e in evs) * 1e3
            if bw_ms >= min_ms:
                found.append((bw_ms, ridge, evs))
        found.sort(key=lambda x: -x[0])
        for bw_ms, ridge, evs in found[:self.MAX_REPORTS]:
            e = evs[0]
            yield self.diag(
                f"{e.prim} {e.dtype}{list(e.shape)} runs {len(evs)} times "
                f"at intensity {e.intensity:.1f} FLOP/byte, below the "
                f"{spec.name} ridge point {ridge:.0f}, and streams "
                f"{e.hbm_bytes} bytes a call = {bw_ms:.2f} ms of HBM time",
                where=e.path,
                hint="fuse it into its neighbours (serving decode: "
                     "FLAGS_decode_megakernel), quantize the streamed "
                     "bytes, or batch wider; raise "
                     "TPU901.min_amplified_ms if it is at its roofline")
        if len(found) > self.MAX_REPORTS:
            yield self.diag(f"{len(found) - self.MAX_REPORTS} more "
                            "bandwidth-bound repeated call(s) elided",
                            where=graph.name)


@register_rule
class PaddingWasteRule(Rule):
    """TPU902: more than `min_fraction` (default 0.2) of the products'
    tensor-core FLOPs go to tile padding (m16n8k16), at least
    `min_waste_flops` (default 1e7)."""

    id = "TPU902"
    name = "padding-waste"
    default_severity = Severity.WARNING
    MIN_FRACTION = 0.2
    MIN_WASTE_FLOPS = 10_000_000

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        min_frac = float(self.config.get("min_fraction", self.MIN_FRACTION))
        min_waste = float(self.config.get("min_waste_flops",
                                          self.MIN_WASTE_FLOPS))
        rep = audit_graph(graph, self.config.get("device"))
        waste, frac = rep.padding_waste_flops, rep.padding_waste_fraction
        if waste < min_waste or frac < min_frac:
            return
        worst = max((e for e in rep.events if e.padded_flops > e.flops),
                    key=lambda e: e.padded_flops - e.flops, default=None)
        detail = "" if worst is None else \
            f"; worst: {worst.prim} {worst.dtype}{list(worst.shape)}"
        yield self.diag(
            f"{frac * 100:.0f}% of the products' tensor-core FLOPs "
            f"({waste / 1e6:.1f} MFLOP a run) are tile padding{detail}",
            where=graph.name,
            hint="pad dims to the tensor-core tile (TPU101 names each "
                 "site) or batch wider")


@register_rule
class LaunchOverheadBoundRule(Rule):
    """TPU903: the launches' fixed cost is at least `max_fraction`
    (default 0.25) of the predicted time, and at least `min_overhead_ms`
    (default 0.2): the program is dispatch-bound."""

    id = "TPU903"
    name = "launch-overhead-bound"
    default_severity = Severity.WARNING
    MAX_FRACTION = 0.25
    MIN_OVERHEAD_MS = 0.2

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        max_frac = float(self.config.get("max_fraction", self.MAX_FRACTION))
        min_ms = float(self.config.get("min_overhead_ms",
                                       self.MIN_OVERHEAD_MS))
        rep = audit_graph(graph, self.config.get("device"))
        overhead_ms = rep.launch_overhead_s * 1e3
        step_ms = rep.predicted_step_ms
        if overhead_ms < min_ms or step_ms <= 0 \
                or overhead_ms < max_frac * step_ms:
            return
        yield self.diag(
            f"{rep.kernel_launches} launches a run cost a predicted "
            f"{overhead_ms:.2f} ms, {overhead_ms / step_ms * 100:.0f}% of "
            f"the {step_ms:.2f} ms predicted on {rep.spec.name}",
            where=graph.name,
            hint="fuse the step (FLAGS_decode_megakernel collapses a "
                 "layer's launches); TPU105 names the distinct launches")
