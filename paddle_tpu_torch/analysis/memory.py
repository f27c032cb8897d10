"""Static memory auditor: liveness over a traced torch program -> peak
device-memory estimate and the in-place analysis (counterpart of
paddle_tpu/analysis/memory.py).

- **Liveness**: every buffer (input, captured constant, call result) gets
  a live range over the program's calls in order. A view (``view``,
  ``reshape`` of a contiguous tensor, ``select``, ``slice``,
  ``as_strided``, ``expand``, ``t``: any result whose schema aliases an
  argument) is its base's storage, not a buffer of its own.
- **In place instead of donation**: an in-place call (``copy_``,
  ``index_put_``, ``scatter_``, ``_foreach_*_``, a kernel operator with a
  ``Tensor(a!)`` argument such as the megakernel's pool commit) writes
  into its target's buffer. The port's programs update their pools and
  parameters in place where the JAX package donates them, so an input
  written in place counts as donated (``donated_bytes``). An input is the
  caller's, so it stays live for the whole program.
- The peak is the device's, of one program (one card; ``mp`` is 1).

Three rules ride the pass:

  TPU701 donation-miss     ERROR: a program makes a fresh full-size copy
                           of an input that it then drops (a pool updated
                           out of place): input and copy are both
                           resident, the footprint doubles.
  TPU702 hbm-over-budget   WARNING: the peak exceeds `hbm_budget_bytes`
                           (default: the device row's capacity less a
                           headroom; 0 disables).
  TPU703 live-range-bloat  WARNING: an intermediate >= `min_bytes` held
                           live across >= `max_live_eqns` calls.

Use::

    from paddle_tpu_torch.analysis import memory
    rep = memory.audit_memory(fn, *example_args)
    rep.peak_bytes;  print(rep.format())

    eng.warm(audit_memory=True);  eng.metrics()["memory_audit"]
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.fx

from .diagnostics import Diagnostic, Severity
from .graph import Graph, tensor_meta, trace_graph
from .rules import Rule, register_rule

# calls that write a full-size copy of their first argument with part of
# it replaced: the out-of-place twins of the in-place updates
_FUNCTIONAL_UPDATES = frozenset({
    "index_put", "scatter", "scatter_add", "scatter_reduce", "index_copy",
    "index_add", "slice_scatter", "select_scatter", "masked_scatter",
    "index_fill", "masked_fill", "copy", "_index_put_impl",
})


def _nbytes(meta) -> int:
    return 0 if meta is None else meta.nbytes


@dataclasses.dataclass
class Buffer:
    """One device allocation of the audited program; `def_t` /
    `last_use_t` index its calls (-1: before the first call, the inputs
    and captured constants)."""

    bid: int
    label: str
    shape: tuple
    dtype: str
    bytes: int
    kind: str              # 'input' | 'const' | 'intermediate'
    def_t: int
    last_use_t: int = -1
    donated: bool = False   # an input the program writes in place
    is_output: bool = False
    input_index: Optional[int] = None
    # last READ (inputs and constants stay live to the end; the in-place
    # analysis needs their true last use)
    content_last_use_t: int = -1

    def to_dict(self) -> dict:
        return {
            "label": self.label, "shape": list(self.shape),
            "dtype": self.dtype, "bytes": self.bytes, "kind": self.kind,
            "def_t": self.def_t, "last_use_t": self.last_use_t,
            "donated": self.donated, "is_output": self.is_output,
        }


class MemoryReport:
    """Result of the liveness pass: the peak, the per-buffer timeline and
    the in-place analysis (`donation`: ``donated_bytes`` are the inputs
    updated in place, ``misses`` the out-of-place copies of TPU701)."""

    def __init__(self, name: str, buffers: List[Buffer], n_eqns: int,
                 peak_bytes: int, peak_t: int, peak_where: str,
                 live_bytes: List[int], eqn_paths: List[str],
                 donation: dict):
        self.name = name
        self.buffers = buffers
        self.n_eqns = n_eqns
        self.mp = 1
        self.peak_bytes = peak_bytes
        self.peak_t = peak_t
        self.peak_where = peak_where
        self._live_bytes = live_bytes
        self._eqn_paths = eqn_paths
        self.donation = donation

    @property
    def input_bytes(self) -> int:
        return sum(b.bytes for b in self.buffers if b.kind == "input")

    @property
    def const_bytes(self) -> int:
        return sum(b.bytes for b in self.buffers if b.kind == "const")

    @property
    def output_bytes(self) -> int:
        return sum(b.bytes for b in self.buffers if b.is_output)

    def live_at(self, t: int) -> List[Buffer]:
        return [b for b in self.buffers if b.def_t <= t <= b.last_use_t]

    def peak_buffers(self, top: int = 8) -> List[Buffer]:
        return sorted(self.live_at(self.peak_t), key=lambda b: -b.bytes)[:top]

    def timeline(self, max_points: int = 64) -> List[dict]:
        n = len(self._live_bytes)
        if n == 0:
            return []
        stride = max(1, n // max_points)
        idx = sorted(set(range(0, n, stride)) | {self.peak_t, n - 1})
        return [{"t": t, "where": self._eqn_paths[t],
                 "live_bytes": self._live_bytes[t]} for t in idx
                if 0 <= t < n]

    def to_dict(self, max_buffers: int = 16) -> dict:
        return {
            "target": self.name,
            "peak_hbm_bytes": self.peak_bytes,
            "peak_at": {"t": self.peak_t, "where": self.peak_where},
            "per_chip": True,
            "mp": self.mp,
            "n_eqns": self.n_eqns,
            "n_buffers": len(self.buffers),
            "input_bytes": self.input_bytes,
            "const_bytes": self.const_bytes,
            "output_bytes": self.output_bytes,
            "donation": self.donation,
            "peak_buffers": [b.to_dict()
                             for b in self.peak_buffers(max_buffers)],
            "timeline": self.timeline(),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    def format(self, top: int = 8) -> str:
        mb = 1 / (1 << 20)
        lines = [
            f"memory audit {self.name}: predicted peak "
            f"{self.peak_bytes * mb:.2f} MiB on the device "
            f"({self.n_eqns} calls, {len(self.buffers)} buffers)",
            f"  peak at [{self.peak_t}] {self.peak_where}",
        ]
        for b in self.peak_buffers(top):
            flags = []
            if b.kind == "input":
                flags.append("updated in place" if b.donated else "input")
            if b.kind == "const":
                flags.append("const")
            if b.is_output:
                flags.append("output")
            lines.append(
                f"    {b.bytes * mb:9.3f} MiB  {b.dtype}{list(b.shape)}"
                f"  live [{b.def_t}..{b.last_use_t}]  {b.label}"
                + (f"  ({', '.join(flags)})" if flags else ""))
        d = self.donation
        lines.append(
            f"  in place: {d['donated_bytes'] * mb:.2f} MiB of inputs "
            f"updated in place, {d['missed_bytes'] * mb:.2f} MiB in "
            f"{len(d['misses'])} out-of-place cop(ies)")
        for m in d["misses"]:
            lines.append(
                f"    MISS {m['bytes'] * mb:.3f} MiB {m['dtype']}"
                f"{m['shape']}: output {m['output']} copies input "
                f"{m['input']}, which the program could update in place")
        return "\n".join(lines)


class _Auditor:
    """One pass over a `Graph`: buffers, aliases, live ranges."""

    def __init__(self, graph: Graph):
        self.g = graph
        self.buffers: List[Buffer] = []
        self._parent: List[int] = []
        self.paths: List[str] = []
        self._updates = []          # (t, operand bid, out bid)

    def _new(self, meta, label, kind, def_t, input_index=None) -> int:
        bid = len(self.buffers)
        self.buffers.append(Buffer(
            bid=bid, label=label,
            shape=tuple(meta.shape) if meta else (),
            dtype=str(meta.dtype).replace("torch.", "") if meta else "?",
            bytes=_nbytes(meta), kind=kind, def_t=def_t, last_use_t=def_t,
            input_index=input_index))
        self._parent.append(bid)
        return bid

    def _find(self, bid: int) -> int:
        while self._parent[bid] != bid:
            self._parent[bid] = self._parent[self._parent[bid]]
            bid = self._parent[bid]
        return bid

    def _use(self, bid: int, t: int):
        buf = self.buffers[self._find(bid)]
        buf.last_use_t = max(buf.last_use_t, t)

    def run(self) -> MemoryReport:
        env: Dict[torch.fx.Node, object] = {}
        n_in = 0
        for n in self.g.graph.nodes:
            if n.op == "placeholder":
                env[n] = self._new(tensor_meta(n.meta.get("val")),
                                   f"in[{n_in}]", "input", -1, n_in)
                n_in += 1
            elif n.op == "get_attr":
                env[n] = self._new(tensor_meta(n.meta.get("val")),
                                   f"const[{n.target}]", "const", -1)
        t = 0
        for n in self.g.graph.nodes:
            if n.op != "call_function":
                continue
            if not isinstance(n.target, torch._ops.OpOverload):
                # operator.getitem of a multi-output call
                src = env.get(n.args[0])
                env[n] = src[n.args[1]] if isinstance(src, list) else src
                continue
            self._call(n, env, t)
            self.paths.append(self.g.ctx(n).path)
            t += 1
        T = t
        out = next(n for n in self.g.graph.nodes if n.op == "output")
        out_bids = set()
        for x in torch.utils._pytree.tree_leaves(out.args):
            bid = env.get(x) if isinstance(x, torch.fx.Node) else None
            if isinstance(bid, int):
                root = self._find(bid)
                out_bids.add(root)
                self.buffers[root].is_output = True
                self.buffers[root].last_use_t = T
        # inputs and constants are the caller's for the whole run; their
        # true last read stays for the in-place analysis
        for buf in self.buffers:
            if buf.bid == self._find(buf.bid) \
                    and buf.kind in ("input", "const"):
                buf.content_last_use_t = buf.last_use_t
                buf.last_use_t = T
        self._donation(T)
        return self._sweep(T)

    def _call(self, n: torch.fx.Node, env, t: int):
        schema = n.target._schema
        args = list(n.args) + [n.kwargs.get(a.name) for a in
                               schema.arguments[len(n.args):]]
        alias_of = {}
        for a, v in zip(schema.arguments, args):
            vals = v if isinstance(v, (list, tuple)) else [v]
            for x in vals:
                bid = env.get(x) if isinstance(x, torch.fx.Node) else None
                if isinstance(bid, int):
                    self._use(bid, t)
                    info = a.alias_info
                    if info is not None:
                        for s in info.before_set:
                            alias_of.setdefault(s, bid)
                        if info.is_write:
                            root = self.buffers[self._find(bid)]
                            if root.kind == "input":
                                root.donated = True
        val = n.meta.get("val")
        vals = list(val) if isinstance(val, (list, tuple)) else [val]
        bids = []
        for i, v in enumerate(vals):
            # a list return (split, unbind) covers every element
            ret = schema.returns[min(i, len(schema.returns) - 1)] \
                if schema.returns else None
            info = getattr(ret, "alias_info", None)
            src = None
            if info is not None:
                src = next((alias_of[s] for s in info.before_set
                            if s in alias_of), None)
            if src is not None:
                bids.append(src)          # a view or the in-place target
                continue
            meta = tensor_meta(v)
            bids.append(None if meta is None
                        else self._new(meta, f"{self.g.name}/t{t}",
                                       "intermediate", t))
        env[n] = bids if isinstance(val, (list, tuple)) else bids[0]
        name = n.target._opname
        if name in _FUNCTIONAL_UPDATES and args \
                and isinstance(env.get(args[0]), int) \
                and isinstance(bids[0], int):
            self._updates.append((t, env[args[0]], bids[0]))

    def _donation(self, T: int):
        roots = [b for b in self.buffers if b.bid == self._find(b.bid)]
        misses, used_in, used_out = [], set(), set()

        def add(cand: Buffer, out: Buffer):
            used_in.add(cand.bid)
            used_out.add(out.bid)
            misses.append({"shape": list(out.shape), "dtype": out.dtype,
                           "bytes": out.bytes, "output": out.label,
                           "input": cand.label,
                           "input_index": cand.input_index})

        # 1. an out-of-place update whose input's last read is the update
        #    itself, and whose copy the program returns
        for t, in_bid, out_bid in self._updates:
            cand = self.buffers[self._find(in_bid)]
            out = self.buffers[self._find(out_bid)]
            if cand.kind == "input" and not cand.donated \
                    and not cand.is_output and out.is_output \
                    and cand.content_last_use_t <= t \
                    and cand.bid not in used_in and out.bid not in used_out:
                add(cand, out)
        # 2. a returned fresh buffer shaped like an input that is dead
        #    strictly before it is made and never written in place
        free: Dict[tuple, List[Buffer]] = {}
        for b in roots:
            if b.kind == "input" and not b.donated and not b.is_output \
                    and b.bid not in used_in:
                free.setdefault((b.shape, b.dtype), []).append(b)
        for b in roots:
            if not b.is_output or b.kind != "intermediate" \
                    or b.bid in used_out:
                continue
            pool = free.get((b.shape, b.dtype), [])
            cand = next((c for c in pool
                         if c.content_last_use_t < b.def_t), None)
            if cand is not None:
                pool.remove(cand)
                add(cand, b)
        self.donation = {
            "donated_bytes": sum(b.bytes for b in roots
                                 if b.kind == "input" and b.donated),
            "missed_bytes": sum(m["bytes"] for m in misses),
            "misses": misses,
        }

    def _sweep(self, T: int) -> MemoryReport:
        n = max(T, 1)
        delta = np.zeros(n + 2, np.int64)
        roots = [b for b in self.buffers if b.bid == self._find(b.bid)]
        for b in roots:
            lo = max(b.def_t, 0)
            hi = max(min(b.last_use_t, T), lo)
            delta[lo] += b.bytes
            delta[hi + 1] -= b.bytes
        live = np.cumsum(delta)[:n]
        peak_t = int(np.argmax(live))
        paths = self.paths or [self.g.name]
        return MemoryReport(
            name=self.g.name, buffers=roots, n_eqns=T,
            peak_bytes=int(live[peak_t]), peak_t=peak_t,
            peak_where=paths[min(peak_t, len(paths) - 1)],
            live_bytes=[int(x) for x in live], eqn_paths=paths,
            donation=self.donation)


def trace_for_memory(fn, *args, name: Optional[str] = None,
                     **kwargs) -> Graph:
    """Trace `fn(*args)` for the auditor (`trace_graph`: fakes only,
    nothing runs)."""
    return trace_graph(fn, *args, name=name, **kwargs)


def audit_graph(graph: Graph) -> MemoryReport:
    """The liveness pass over a traced `Graph` (memoized on it: the
    three memory rules share one pass)."""
    rep = getattr(graph, "_memory_report", None)
    if rep is None:
        rep = graph._memory_report = _Auditor(graph).run()
    return rep


def audit_memory(fn, *args, name: Optional[str] = None,
                 **kwargs) -> MemoryReport:
    """Trace and audit in one call."""
    return audit_graph(trace_graph(fn, *args, name=name, **kwargs))


def pytree_local_bytes(tree) -> int:
    """Bytes of the tensors of a pytree (the engine's budget: params +
    pools)."""
    return sum(int(x.numel() * x.element_size())
               for x in torch.utils._pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def resolve_audit_memory(audit_memory_param: Optional[bool]) -> bool:
    """An explicit True / False wins; None follows FLAGS_audit_memory
    (PADDLE_TPU_AUDIT_MEMORY) or PADDLE_TPU_LINT, which implies it."""
    if audit_memory_param is not None:
        return bool(audit_memory_param)
    from ..framework.flags import flag

    return bool(flag("audit_memory")) or bool(flag("tpu_lint"))


@register_rule
class DonationMissRule(Rule):
    """TPU701: a program output that is a fresh full-size copy of an
    input the program then drops: a pool updated out of place
    (``pool.index_put(...)`` returned) keeps the stale and the updated
    pool resident, twice the bytes. The port's programs update pools in
    place (``index_put_``, ``copy_``, the megakernel's commit), which the
    pass counts as donated. Config: `min_bytes` (default 64 KiB)."""

    id = "TPU701"
    name = "donation-miss"
    default_severity = Severity.ERROR
    MIN_BYTES = 1 << 16

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        rep = audit_graph(graph)
        min_bytes = int(self.config.get("min_bytes", self.MIN_BYTES))
        for m in rep.donation["misses"]:
            if m["bytes"] < min_bytes:
                continue
            yield self.diag(
                f"output {m['output']} ({m['dtype']}{m['shape']}, "
                f"{m['bytes'] / (1 << 20):.2f} MiB) is a fresh copy of "
                f"input {m['input']}, which the program drops: both stay "
                "resident and the buffer's footprint doubles",
                where=graph.name,
                hint="update the input in place (index_put_, copy_, "
                     "out=): the engine's programs commit into their "
                     "pools in place")


@register_rule
class HBMBudgetRule(Rule):
    """TPU702: the predicted peak exceeds the budget: by default the
    device row's capacity less a headroom (`device_specs.auto_hbm_budget`;
    `TPU702.device` picks the row), or `hbm_budget_bytes` (0 disables)."""

    id = "TPU702"
    name = "hbm-over-budget"
    default_severity = Severity.WARNING

    def __init__(self, severity: Optional[Severity] = None, **config):
        super().__init__(severity, **config)
        self._auto = "hbm_budget_bytes" not in self.config
        if self._auto:
            from .device_specs import auto_hbm_budget

            self._budget = auto_hbm_budget(self.config.get("device")
                                           or "h100-sxm")
            return
        raw = self.config.get("hbm_budget_bytes", 0)
        try:
            self._budget = int(raw or 0)
        except (TypeError, ValueError):
            raise ValueError(
                f"TPU702.hbm_budget_bytes must be an integer byte count, "
                f"got {raw!r}")

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        if self._budget <= 0:
            return
        rep = audit_graph(graph)
        if rep.peak_bytes <= self._budget:
            return
        top = ", ".join(f"{b.label} {b.bytes / (1 << 20):.1f} MiB"
                        for b in rep.peak_buffers(3))
        src = "auto device-row" if self._auto else "configured"
        yield self.diag(
            f"predicted peak {rep.peak_bytes / (1 << 20):.2f} MiB exceeds "
            f"the {src} {self._budget / (1 << 20):.2f} MiB budget (peak at "
            f"{rep.peak_where}; largest: {top})",
            where=graph.name,
            hint="shrink the pool budget (kv_pool_bytes=) or the batch, "
                 "update threaded buffers in place, or raise "
                 "TPU702.hbm_budget_bytes if the headroom is real")


@register_rule
class LiveRangeBloatRule(Rule):
    """TPU703: a large intermediate held live across many calls: the
    recompute or free-earlier candidates. Config: `min_bytes` (default
    1 MiB), `max_live_eqns` (default 150)."""

    id = "TPU703"
    name = "live-range-bloat"
    default_severity = Severity.WARNING
    MIN_BYTES = 1 << 20
    MAX_LIVE_EQNS = 150
    MAX_REPORTS = 4

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        min_bytes = int(self.config.get("min_bytes", self.MIN_BYTES))
        cap = int(self.config.get("max_live_eqns", self.MAX_LIVE_EQNS))
        rep = audit_graph(graph)
        found = sorted(((b.last_use_t - max(b.def_t, 0), b)
                        for b in rep.buffers
                        if b.kind == "intermediate" and not b.is_output
                        and b.bytes >= min_bytes
                        and b.last_use_t - max(b.def_t, 0) >= cap),
                       key=lambda x: -x[0] * x[1].bytes)
        for span, b in found[:self.MAX_REPORTS]:
            yield self.diag(
                f"{b.dtype}{list(b.shape)} ({b.bytes / (1 << 20):.2f} MiB) "
                f"stays live across {span} calls (made at t={b.def_t}, "
                f"last used t={b.last_use_t}): recompute or free it "
                "earlier", where=b.label,
                hint="recompute at the late consumer, or consume the "
                     "value near its definition; raise "
                     "TPU703.max_live_eqns if the overlap is deliberate")
        if len(found) > self.MAX_REPORTS:
            yield self.diag(f"{len(found) - self.MAX_REPORTS} more "
                            "long-lived buffer(s) elided (first "
                            f"{self.MAX_REPORTS} shown)", where=graph.name)
