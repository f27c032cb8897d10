"""The communication audit: the bytes-on-wire pass over a traced program
and a per-rank collective cost model (counterpart of
paddle_tpu/analysis/comms.py).

The wire-side twin of `analysis/memory.py`: where the liveness pass
bounds bytes resident, this pass inventories every collective a program
executes and bounds the bytes each rank puts on the wire.

- **Inventory**: every node of the collective operators
  (``paddle_tpu_comm::all_gather`` / ``all_reduce`` / ``all_to_all`` /
  ``broadcast`` / ``reduce_scatter`` / ``ppermute``,
  `parallel/collectives.py`), one per call. Kinds take the
  JAX primitives' names (an all_reduce is ``psum`` / ``pmax`` /
  ``pmin``), and a group's axis is its registry key's axis part
  (``"mp@0,1"`` -> ``mp``), so reports compare one to one with JAX's.
- **Cost model** (ring algorithms, per rank): all-reduce moves
  ``2(n-1)/n`` of its operand, all-gather / all-to-all / broadcast
  ``(n-1)/n`` of the full (gathered) payload, a ``ppermute`` hop its
  payload once where the rank sends (a receive alone puts nothing on
  its wire: a pipeline stage's boundary); a group of 1 moves nothing.
  A rank traces its own shard, so operand bytes are per rank by
  construction.
- **Sites from unrolled steps**: a torch graph has no loops (a Python
  loop unrolls), so every node counts once. A program that repeats one
  step `steps` times (the engine's decode chunk: steps_per_sync decode
  steps, the graph's ``unrolled_steps``) has its collectives folded onto
  one step: when the node sequence is `steps` repeats of one step's
  sequence (same kinds, shapes, dtypes and groups, in order), each of the
  step's collectives is one site with ``count = steps`` and ``in_loop``
  set, the JAX pass's scan amplification. A sequence that does not repeat
  stays unfolded.
- **No implicit reshards**: SPMD ranks only make the collectives they
  call, so nothing is inserted behind the author's back:
  ``n_implicit_reshards`` is 0 and TPU802 stays silent by construction
  (kept registered, with JAX's config key, so rule sets compare).
- **Quantized-collective recognition** (`_mark_quantized`): each hop of
  the quantized collectives is one int8 node carrying the payload with
  its f32 scales packed in, so any int8 collective is the rewrite's wire
  (``quantized_wire_bytes``, ``n_quantized_sites``); an int8 payload
  never fires TPU803.

Rules over the one (memoized) pass:

  TPU401 collectives         dead (result unused) and duplicate
                             collectives, an axis outside `mesh_axes`,
                             and (with `max_collective_bytes`) large
                             float payloads (rules.py).
  TPU801 collective-in-loop  one site's amplified wire bytes a program
                             execution above `max_step_wire_bytes`
                             (default 32 MiB).
  TPU802 implicit-reshard    registered, silent on SPMD ranks.
  TPU803 quantizable-        a float-payload collective moving >=
         collective          `min_bytes` (default 1 MiB, amplified).

Use::

    from paddle_tpu_torch.analysis import comms
    rep = comms.audit_comms(fn, *example_args)
    eng.warm(audit_comms=True);  eng.audit_comms()   # fleet report
    python -m paddle_tpu_torch.analysis --comms --format json
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional

from ..parallel.collectives import COMM_NAMESPACE
from .diagnostics import Diagnostic, Severity
from .graph import Graph, NodeCtx, trace_graph
from .rules import Rule, register_rule

ALL_REDUCE_PRIMS = frozenset({"psum", "psum2", "pmax", "pmin"})
GATHER_PRIMS = frozenset({"all_gather", "pgather"})
COLLECTIVE_PRIMS = ALL_REDUCE_PRIMS | GATHER_PRIMS | frozenset({
    "all_to_all", "ppermute", "reduce_scatter", "broadcast",
})
_REDUCE_KIND = {"sum": "psum", "max": "pmax", "min": "pmin"}


def is_collective(ctx: NodeCtx) -> bool:
    """A call of one of the collective operators."""
    return ctx.namespace == COMM_NAMESPACE


def collective_kind(ctx: NodeCtx) -> str:
    """The JAX primitive name of a collective node."""
    if ctx.packet == "all_reduce":
        return _REDUCE_KIND[ctx.node.args[3]]
    return ctx.packet


def collective_axes(ctx: NodeCtx) -> tuple:
    """The mesh axis a collective node runs over (its group key's axis)."""
    return (str(ctx.node.args[1]).split("@", 1)[0],)


def collective_size(ctx: NodeCtx) -> int:
    return int(ctx.node.args[2])


def _wire_factor(kind: str, n: int) -> float:
    """Per-rank ring-cost factor applied to the payload base (operand
    bytes for reduce-class ops, gathered bytes for gather-class)."""
    if n <= 1:
        return 0.0
    if kind in ALL_REDUCE_PRIMS:
        return 2.0 * (n - 1) / n
    if kind == "ppermute":
        return 1.0
    return (n - 1) / n


@dataclasses.dataclass
class CommEvent:
    """One communication site. `wire_bytes` is the per-rank cost-model
    estimate for ONE occurrence; `count` is the number of unrolled steps
    folded onto it."""

    kind: str
    path: str
    axes: tuple
    n_devices: int
    payload_bytes: int
    float_payload_bytes: int
    wire_bytes: int
    count: int
    shape: tuple
    dtype: str
    in_loop: bool
    implicit: bool = False
    detail: str = ""
    quantized: bool = False

    @property
    def total_wire_bytes(self) -> int:
        return self.wire_bytes * max(self.count, 1)

    @property
    def total_float_payload_bytes(self) -> int:
        return self.float_payload_bytes * max(self.count, 1)

    def signature(self) -> tuple:
        return (self.kind, self.axes, self.shape, self.dtype)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "path": self.path,
            "axes": list(self.axes), "n_devices": self.n_devices,
            "payload_bytes": self.payload_bytes,
            "float_payload_bytes": self.float_payload_bytes,
            "wire_bytes": self.wire_bytes, "count": self.count,
            "total_wire_bytes": self.total_wire_bytes,
            "shape": list(self.shape), "dtype": self.dtype,
            "in_loop": self.in_loop, "implicit": self.implicit,
            "detail": self.detail, "quantized": self.quantized,
        }


class CommsReport:
    """Result of the bytes-on-wire pass: every site, loop-amplified
    per-rank totals, and the per-axis / per-kind splits (JAX's report,
    key for key)."""

    def __init__(self, name: str, events: List[CommEvent], mp: int):
        self.name = name
        self.events = events
        # the largest group (or the mesh size the caller stated)
        self.mp = mp

    @property
    def collectives(self) -> List[CommEvent]:
        return [e for e in self.events if e.kind != "reshard"]

    @property
    def reshards(self) -> List[CommEvent]:
        return [e for e in self.events if e.kind == "reshard"]

    @property
    def total_wire_bytes(self) -> int:
        """Per-rank bytes on wire for ONE execution of the program."""
        return sum(e.total_wire_bytes for e in self.events)

    @property
    def total_float_payload_bytes(self) -> int:
        return sum(e.total_float_payload_bytes for e in self.collectives)

    @property
    def implicit_reshard_bytes(self) -> int:
        return sum(e.total_wire_bytes for e in self.reshards)

    @property
    def n_collective_sites(self) -> int:
        return len(self.collectives)

    @property
    def n_collectives(self) -> int:
        """Amplified occurrence count: a per-layer gather of a 16-step
        chunk counts 16 per site."""
        return sum(max(e.count, 1) for e in self.collectives)

    @property
    def quantized_events(self) -> List[CommEvent]:
        return [e for e in self.events if e.quantized]

    @property
    def quantized_wire_bytes(self) -> int:
        return sum(e.total_wire_bytes for e in self.quantized_events)

    @property
    def n_quantized_sites(self) -> int:
        return sum(1 for e in self.quantized_events if "int" in e.dtype)

    def per_axis(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            key = ",".join(e.axes) if e.axes else "<unknown>"
            out[key] = out.get(key, 0) + e.total_wire_bytes
        return out

    def per_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + e.total_wire_bytes
        return out

    def top_talkers(self, top: int = 8) -> List[CommEvent]:
        return sorted(self.events, key=lambda e: -e.total_wire_bytes)[:top]

    def to_dict(self, max_events: int = 16) -> dict:
        return {
            "target": self.name,
            "per_chip": True,
            "mp": self.mp,
            "n_collective_sites": self.n_collective_sites,
            "n_collectives": self.n_collectives,
            "n_implicit_reshards": len(self.reshards),
            "bytes_on_wire": self.total_wire_bytes,
            "float_payload_bytes": self.total_float_payload_bytes,
            "implicit_reshard_bytes": self.implicit_reshard_bytes,
            "quantized_wire_bytes": self.quantized_wire_bytes,
            "n_quantized_sites": self.n_quantized_sites,
            "per_axis": self.per_axis(),
            "per_kind": self.per_kind(),
            "top_talkers": [e.to_dict()
                            for e in self.top_talkers(max_events)],
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    def format(self, top: int = 8) -> str:
        kb = 1 / 1024
        lines = [
            f"comms audit {self.name}: {self.total_wire_bytes * kb:.2f} "
            f"KiB on wire per rank per execution "
            f"(mp={self.mp}, {self.n_collective_sites} site(s), "
            f"{self.n_collectives} amplified occurrence(s), "
            f"{len(self.reshards)} implicit reshard(s))",
        ]
        for axis, b in sorted(self.per_axis().items()):
            lines.append(f"  axis {axis}: {b * kb:.2f} KiB")
        if self.n_quantized_sites:
            lines.append(
                f"  quantized (int8+scale) sites: "
                f"{self.n_quantized_sites}, "
                f"{self.quantized_wire_bytes * kb:.2f} KiB on wire")
        for e in self.top_talkers(top):
            amp = f" x{e.count}" if e.count > 1 else ""
            q = "  [q8]" if e.quantized else ""
            lines.append(
                f"    {e.total_wire_bytes * kb:9.2f} KiB  {e.kind}"
                f"[{','.join(e.axes)}] {e.dtype}{list(e.shape)}{amp}"
                f"  {e.path}{q}")
        return "\n".join(lines)


def _event(ctx: NodeCtx) -> CommEvent:
    kind = collective_kind(ctx)
    n = collective_size(ctx)
    x = ctx.args["x"]
    out = ctx.outputs[0]
    in_bytes = x.nbytes
    if kind == "ppermute" and int(ctx.node.args[3]) < 0:
        in_bytes = 0    # a receive alone: the peer's wire, not this rank's
    base = out.nbytes if kind in GATHER_PRIMS else in_bytes
    return CommEvent(
        kind=kind, path=ctx.path, axes=collective_axes(ctx), n_devices=n,
        payload_bytes=in_bytes,
        float_payload_bytes=in_bytes if x.dtype.is_floating_point else 0,
        wire_bytes=int(base * _wire_factor(kind, n)), count=1,
        shape=tuple(x.shape), dtype=str(x.dtype).replace("torch.", ""),
        in_loop=False)


def _fold_steps(events: List[CommEvent], steps: int) -> List[CommEvent]:
    """Fold `steps` unrolled repeats of one step's collectives onto one
    step (count = steps); unchanged when the sequence does not repeat."""
    if steps <= 1 or not events or len(events) % steps:
        return events
    period = len(events) // steps
    sigs = [e.signature() for e in events]
    if any(sigs[i] != sigs[i % period] for i in range(len(sigs))):
        return events
    out = []
    for e in events[:period]:
        out.append(dataclasses.replace(e, count=steps, in_loop=True))
    return out


def _mark_quantized(events: List[CommEvent]) -> None:
    """Each quantized hop of `parallel/collectives.py` ships ONE int8
    buffer (payload plus its f32 scales packed in); nothing else the port
    puts on a collective is int8, so every int8 collective is the
    rewrite's wire. Its full packed bytes are attributed to it."""
    for e in events:
        if e.kind == "reshard" or "int8" not in e.dtype:
            continue
        e.quantized = True
        e.detail = e.detail or "int8 payload + packed f32 scales"


def audit_graph(graph: Graph) -> CommsReport:
    """The bytes-on-wire pass over a traced `Graph` (memoized on the
    graph: TPU401 and the TPU80x rules share one pass). The graph's
    ``unrolled_steps`` folds a chunk's steps into sites, and its
    ``mesh_size`` (else the largest group) is the report's `mp`."""
    rep = getattr(graph, "_comms_report", None)
    if rep is None:
        events = [_event(ctx) for ctx in graph.nodes()
                  if is_collective(ctx)]
        events = _fold_steps(events, graph.unrolled_steps)
        _mark_quantized(events)
        mp = graph.mesh_size or max((e.n_devices for e in events),
                                    default=1)
        rep = CommsReport(graph.name, events, int(mp))
        graph._comms_report = rep
    return rep


def audit_comms(fn, *args, name: Optional[str] = None, steps: int = 1,
                grad: bool = False, **kwargs) -> CommsReport:
    """Trace and audit in one call (fake tensors: nothing runs, no
    collective is made, no live process group is needed). `steps` is the
    number of unrolled steps the program repeats (folded into sites)."""
    g = trace_graph(fn, *args, name=name, grad=grad, **kwargs)
    g.unrolled_steps = int(steps)
    return audit_graph(g)


def resolve_audit_comms(audit_comms_param: Optional[bool]) -> bool:
    """An explicit True / False wins; None follows FLAGS_audit_comms
    (PADDLE_TPU_AUDIT_COMMS) or PADDLE_TPU_LINT, which implies it."""
    if audit_comms_param is not None:
        return bool(audit_comms_param)
    from ..framework.flags import flag

    return bool(flag("audit_comms")) or bool(flag("tpu_lint"))


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@register_rule
class CollectiveLoopAmplificationRule(Rule):
    """TPU801: a collective repeated by the program's steps whose
    amplified wire bytes (per-rank bytes x steps) exceed the per-execution
    budget: a per-layer all-gather reads as tiny per call, but "1 per
    layer x 32 layers x 16 steps" is what the link carries.

    Config: `max_step_wire_bytes` (default 32 MiB; 0 disables)."""

    id = "TPU801"
    name = "collective-in-loop"
    default_severity = Severity.WARNING
    MAX_STEP_WIRE_BYTES = 1 << 25

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        budget = int(self.config.get("max_step_wire_bytes",
                                     self.MAX_STEP_WIRE_BYTES) or 0)
        if budget <= 0:
            return
        for e in audit_graph(graph).collectives:
            if not e.in_loop and e.count <= 1:
                continue
            total = e.total_wire_bytes
            if total <= budget:
                continue
            yield self.diag(
                f"{e.kind} over {e.axes} moves {e.wire_bytes} bytes "
                f"per iteration x {e.count} loop iterations = {total} "
                f"bytes on wire per rank per step (> {budget} budget)",
                where=e.path,
                hint="hoist the collective out of the loop, rewrite as "
                     "reduce-scatter + gather at the boundary, shrink "
                     "the chunk, or quantize the payload (TPU803); "
                     "raise TPU801.max_step_wire_bytes if the budget "
                     "is wrong for this program")


@register_rule
class ImplicitReshardRule(Rule):
    """TPU802: a reshard the compiler inserted behind the author's back.
    SPMD ranks make only the collectives they call, so the port's
    programs have none and the rule is silent by construction; it stays
    registered with JAX's `min_bytes` (default 64 KiB) so rule sets and
    configs compare."""

    id = "TPU802"
    name = "implicit-reshard"
    default_severity = Severity.WARNING
    MIN_BYTES = 1 << 16

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        min_bytes = int(self.config.get("min_bytes", self.MIN_BYTES))
        for e in audit_graph(graph).reshards:
            if e.total_wire_bytes < min_bytes:
                continue
            yield self.diag(
                f"implicit reshard {e.detail} of {e.dtype}"
                f"{list(e.shape)} moves ~{e.wire_bytes} bytes per rank",
                where=e.path)


@register_rule
class QuantizableCollectiveRule(Rule):
    """TPU803: a float-payload collective moving >= `min_bytes`
    (amplified): the absmax-int8 + f32-scale rewrite
    (`quantized_collectives`) cuts its wire bytes. int8 payloads never
    fire.

    Config: `min_bytes` (default 1 MiB; 0 disables)."""

    id = "TPU803"
    name = "quantizable-collective"
    default_severity = Severity.WARNING
    MIN_BYTES = 1 << 20

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        min_bytes = int(self.config.get("min_bytes", self.MIN_BYTES))
        if min_bytes <= 0:
            return
        for e in audit_graph(graph).collectives:
            total = e.total_float_payload_bytes
            if not total or total < min_bytes:
                continue
            amp = (f" x {e.count} iterations = {total} bytes"
                   if e.count > 1 else "")
            yield self.diag(
                f"{e.kind} over {e.axes} moves "
                f"{e.float_payload_bytes} bytes of float payload per "
                f"occurrence{amp} on a hot path — an int8 payload "
                f"would cut the wire bytes ~{_quant_ratio(e.dtype)}x",
                where=e.path,
                hint="quantize the payload: absmax int8 + f32 scale "
                     "sidecar (quantized_collectives=True / "
                     "FLAGS_quantized_collectives); raise "
                     "TPU803.min_bytes if this payload must stay float")


def _quant_ratio(dtype: str) -> int:
    return {"float64": 8, "float32": 4, "bfloat16": 2,
            "float16": 2}.get(dtype, 2)
