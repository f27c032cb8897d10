"""Built-in lint rules over traced torch programs (counterpart of
paddle_tpu/analysis/rules.py). The ids are the JAX package's, so its
findings and the port's compare one to one; each rule states the card's
version of its hazard (the table in ``analysis/__init__.py``):

  TPU101 tile-alignment       bf16 / f16 matmul dims off the tensor-core
                              tile (the products outside the port's
                              kernels; kernel shapes are TPU102's)
  TPU102 kernel-constraints   kernel operator shapes the CUDA kernel
                              refuses (kernels/constraints.py)
  TPU103 kv-cache-dtype       KV pools streamed in f32, or int8 pools
                              without their scales
  TPU105 fusion-miss          a program of many distinct small-output
                              launches (dispatch-bound decode steps)
  TPU201 recompile-risk       Python scalars baked into the program: one
                              CUDA graph captured per value
  TPU202 const-bloat          large tensors captured from the closure
  TPU301 dtype-promotion      bf16 -> f32 upcasts feeding compute; f32
                              products run at the CUDA-core rate
  TPU401 collectives          dead and duplicate collectives, an axis
                              outside the declared mesh, large float
                              payloads (over the comms.py inventory)
  TPU501 host-sync            device values read on the host inside a
                              program (.item(), .cpu(), .tolist())
  TPU601 ckpt-in-program      checkpoint saves inside a program
  TPU602 trace-in-program     trace / metrics emitters inside a program

Custom rules: subclass `Rule`, decorate with `@register_rule`.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Type

import torch

from ..kernels.constraints import (constraint_for_op, dtype_name,
                                   missing_scale_finding)
from .diagnostics import Diagnostic, Severity
from .graph import Graph, NodeCtx

RULES: Dict[str, Type["Rule"]] = {}

# the products the card runs outside the port's kernels
MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm",
                        "matmul", "_scaled_mm", "convolution", "linear"})
# the tensor-core tile one mma.sync instruction takes, by operand dtype
# (m, n, k): bf16 / f16 m16n8k16, int8 m16n8k32; f32 runs on CUDA cores
MMA_TILE = {torch.bfloat16: (16, 8, 16), torch.float16: (16, 8, 16),
            torch.int8: (16, 8, 32)}


def register_rule(cls: Type["Rule"]) -> Type["Rule"]:
    """Class decorator: adds the rule to the default pipeline set."""
    RULES[cls.id] = cls
    return cls


class Rule:
    """Base lint rule: subclasses set `id` / `name` / `default_severity`
    and implement `check(graph)` yielding Diagnostics."""

    id: str = "TPU000"
    name: str = "base"
    description: str = ""
    default_severity: Severity = Severity.WARNING

    def __init__(self, severity: Optional[Severity] = None, **config):
        self.severity = self.default_severity if severity is None \
            else severity
        self.config = config

    def diag(self, message: str, where: str = "",
             hint: Optional[str] = None,
             severity: Optional[Severity] = None) -> Diagnostic:
        return Diagnostic(rule=self.id,
                          severity=self.severity if severity is None
                          else severity,
                          message=message, where=where, hint=hint)

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        raise NotImplementedError


def matmul_dims(ctx: NodeCtx):
    """(B, M, N, K, operand dtype) of a matmul node, None for others."""
    if ctx.namespace != "aten" or ctx.packet not in MATMUL_OPS:
        return None
    ins = [m for m in ctx.input_metas() if len(m.shape) >= 2]
    outs = ctx.outputs
    if len(ins) < 2 or not outs:
        return None
    if ctx.packet == "convolution":
        w, out = ins[1], outs[0]
        k = 1
        for s in w.shape[1:]:
            k *= s
        return 1, out.numel // w.shape[0], w.shape[0], k, ins[0].dtype
    a, b = (ins[-2], ins[-1])
    out = outs[0]
    k = a.shape[-1]
    m, n = a.shape[-2], b.shape[-1]
    batch = out.numel // max(m * n, 1)
    return batch, m, n, k, a.dtype


def _dedupe(found):
    for key, paths in found.items():
        sites = "" if len(paths) == 1 else f" ({len(paths)} sites)"
        yield key, paths[0], sites


# ---------------------------------------------------------------------------
# TPU101: tensor-core tile alignment of matmuls
# ---------------------------------------------------------------------------

@register_rule
class TileAlignmentRule(Rule):
    """bf16 / f16 / int8 products whose M, N or K is not a multiple of
    the mma tile (m16n8k16; k32 for int8): the library kernel pads the
    ragged edge and pays the padded FLOPs. The port's own kernels state
    their shape limits in `KernelConstraint` (head_dim 64 / 128, pages of
    the pool, the GEMV's K multiple of 32), which TPU102 checks: for
    kernel operators the two rules would say the same thing, so TPU101
    looks only at the products outside them. f32 products run on CUDA
    cores and have no tile."""

    id = "TPU101"
    name = "tile-alignment"
    default_severity = Severity.WARNING
    MIN_DIM = 8

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        found: Dict[tuple, list] = {}
        for ctx in graph.nodes():
            dims = matmul_dims(ctx)
            if dims is None or dims[4] not in MMA_TILE:
                continue
            _, m, n, k, dt = dims
            tm, tn, tk = MMA_TILE[dt]
            for role, size, mult in (("M", m, tm), ("N", n, tn),
                                     ("K", k, tk)):
                if size >= self.MIN_DIM and size % mult:
                    key = (role, size, mult, dtype_name(dt))
                    found.setdefault(key, []).append(ctx.path)
        for (role, size, mult, dt), where, sites in _dedupe(found):
            yield self.diag(
                f"{role} dim {size} of a {dt} product is not a multiple "
                f"of the {mult}-wide tensor-core tile{sites}",
                where=where,
                hint=f"pad to {-(-size // mult) * mult} or fold the ragged "
                     "dim into the batch")


# ---------------------------------------------------------------------------
# TPU102: kernel operators vs the card's limits
# ---------------------------------------------------------------------------

@register_rule
class KernelConstraintRule(Rule):
    """Kernel operator nodes checked against the `KernelConstraint`
    registry (kernels/constraints.py), the shape math of the wrappers'
    own checks: a finding here is a launch the CUDA kernel refuses."""

    id = "TPU102"
    name = "kernel-constraints"
    default_severity = Severity.ERROR

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        found: Dict[tuple, list] = {}
        notes: Dict[str, str] = {}
        for ctx in graph.kernel_nodes():
            c = constraint_for_op(ctx.packet)
            if c is None:
                continue
            notes[c.name] = c.note
            for sev, msg in c.check(ctx.args):
                found.setdefault((c.name, msg, sev), []).append(ctx.path)
        for (cname, msg, sev), where, sites in _dedupe(found):
            yield self.diag(f"{cname}: {msg}{sites}", where=where,
                            hint=notes[cname] or None,
                            severity=Severity[sev.upper()])


# ---------------------------------------------------------------------------
# TPU103: KV pool dtype hygiene
# ---------------------------------------------------------------------------

KV_KERNELS = ("paged_decode_attention", "paged_prefill_attention",
              "contiguous_decode_attention", "decode_megakernel")


@register_rule
class KVCacheDtypeRule(Rule):
    """At the kernels that stream KV pools: pools in f32 (decode is
    HBM-bound on KV bytes, so f32 pools pay 2x bf16 and 4x int8 every
    step), and int8 pools consumed without their scales."""

    id = "TPU103"
    name = "kv-cache-dtype"
    default_severity = Severity.WARNING

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        found: Dict[tuple, list] = {}
        for ctx in graph.kernel_nodes():
            if ctx.packet not in KV_KERNELS:
                continue
            a = ctx.args
            pool = a.get("key_cache", a.get("k_cache"))
            if pool is None:
                continue
            if pool.dtype == torch.float32:
                found.setdefault((ctx.packet, "KV pools streamed in "
                                  "float32: decode and prefill are "
                                  "bandwidth-bound, so f32 pools pay 2x "
                                  "the bf16 bytes (4x int8) every step",
                                  "warning"), []).append(ctx.path)
            finding = missing_scale_finding(a)
            if finding is not None:
                found.setdefault((ctx.packet, finding[1], finding[0]),
                                 []).append(ctx.path)
        for (op, msg, sev), where, sites in _dedupe(found):
            yield self.diag(
                f"{op}: {msg}{sites}", where=where,
                hint="serve bfloat16 pools, or int8 with scales through "
                     "kv_cache_dtype='int8' (PADDLE_TPU_KV_CACHE_DTYPE)",
                severity=Severity[sev.upper()])


# ---------------------------------------------------------------------------
# TPU105: fusion miss
# ---------------------------------------------------------------------------

@register_rule
class FusionMissRule(Rule):
    """A program whose launches (kernel operators and products) are many
    DISTINCT small-output calls is dispatch-bound: each launch pays the
    card's fixed launch cost (a replayed CUDA graph removes the host's
    share, not the device's) and its tiny outputs round-trip HBM.
    Distinctness is by (operator, shapes), so the unrolled layers and
    steps of a decode chunk count one layer's launches once: the
    per-step fusion-boundary count the megakernel
    (FLAGS_decode_megakernel) collapses.

    Config: `max_kernels` (default 6), `small_bytes` (default 1 MiB)."""

    id = "TPU105"
    name = "fusion-miss"
    default_severity = Severity.WARNING
    MAX_KERNELS = 6
    SMALL_BYTES = 1 << 20

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        max_kernels = self.config.get("max_kernels", self.MAX_KERNELS)
        small = self.config.get("small_bytes", self.SMALL_BYTES)
        sigs: Dict[tuple, NodeCtx] = {}
        total = 0
        for ctx in graph.nodes():
            if not (ctx.is_kernel or matmul_dims(ctx) is not None):
                continue
            out_bytes = max((m.nbytes for m in ctx.outputs), default=0)
            if out_bytes >= small:
                continue
            sig = (ctx.op, tuple(m.shape for m in ctx.input_metas()),
                   tuple(m.shape for m in ctx.outputs))
            sigs.setdefault(sig, ctx)
            total += 1
        n = len(sigs)
        if n <= max_kernels:
            return
        n_kernel = sum(1 for c in sigs.values() if c.is_kernel)
        first = next(iter(sigs.values()))
        yield self.diag(
            f"the program launches {n} distinct small-output kernels "
            f"({n_kernel} hand-written, {n - n_kernel} products; {total} "
            f"launches) — more than the {max_kernels}-launch fusion "
            "budget: per-launch dispatch and HBM round-trips between tiny "
            "ops dominate",
            where=first.path,
            hint="fuse the step (serving decode: "
                 "FLAGS_decode_megakernel=attn|full|scan serves the "
                 "layer's attention block, the whole layer, or every "
                 "layer as one launch)")


# ---------------------------------------------------------------------------
# TPU201: Python scalars baked into a program
# ---------------------------------------------------------------------------

@register_rule
class RecompileRiskRule(Rule):
    """A Python scalar that enters a program is baked into the CUDA graph
    the program captures: each new value needs a capture of its own (one
    graph per value, `framework/cuda_graph.py` GraphSite), or replays
    the old value. Thread values that change (a loss scale, a step
    count) as tensors the program reads."""

    id = "TPU201"
    name = "recompile-risk"
    default_severity = Severity.WARNING
    BENIGN_VALUES = (0, 1, -1, 2, 0.5, -0.5, 1e-6, 1e-5, 1e-12)
    MAX_REPORTS = 8

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        arg_vals = graph.scalar_args
        seen = set()
        n = 0
        for val, ctx, argname in graph.scalar_literals():
            if arg_vals is not None:
                # a float argument never matches an int literal (2.5
                # is no 2); an int argument stored as a float matches
                label = next((lbl for a, lbl in arg_vals if a == val
                              and not (isinstance(a, float)
                                       and not isinstance(val, float))),
                             None)
                if label is None or val in seen:
                    continue
                seen.add(val)
                yield self.diag(
                    f"python scalar argument {label} (= {val!r}) is baked "
                    f"into `{ctx.op}` ({argname}); every new value "
                    "captures a CUDA graph of its own",
                    where=ctx.path,
                    hint="pass it as a tensor the program reads (a static "
                         "input the host copies into), or keep it fixed "
                         "on purpose")
                continue
            if val in self.BENIGN_VALUES or val in seen:
                continue
            seen.add(val)
            n += 1
            if n > self.MAX_REPORTS:
                yield self.diag("more scalar captures elided (first "
                                f"{self.MAX_REPORTS} shown)",
                                where=graph.name)
                return
            yield self.diag(
                f"python scalar {val!r} is baked into `{ctx.op}`; a "
                "different value at the next call needs another capture",
                where=ctx.path,
                hint="pass it as a tensor argument (or keep it fixed on "
                     "purpose)")


# ---------------------------------------------------------------------------
# TPU202: large captured constants
# ---------------------------------------------------------------------------

@register_rule
class ConstBloatRule(Rule):
    """Tensors the traced function captured from its closure are baked
    into the program: a captured graph names their memory, so it can
    never change; model weights captured this way (instead of passed as
    arguments) are the usual cause."""

    id = "TPU202"
    name = "const-bloat"
    default_severity = Severity.INFO
    THRESHOLD_BYTES = 1 << 20

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        threshold = self.config.get("threshold_bytes", self.THRESHOLD_BYTES)
        consts = graph.captured_consts()
        total = sum(m.nbytes for _, m in consts)
        if total >= threshold and consts:
            name, worst = max(consts, key=lambda c: c[1].nbytes)
            yield self.diag(
                f"{total / (1 << 20):.1f} MiB of tensors captured as "
                f"constants (largest: {name} {list(worst.shape)} "
                f"{dtype_name(worst.dtype)}, "
                f"{worst.nbytes / (1 << 20):.1f} MiB)",
                where=graph.name,
                hint="pass weights and buffers as arguments")


# ---------------------------------------------------------------------------
# TPU301: silent dtype promotion
# ---------------------------------------------------------------------------

LOW = (torch.bfloat16, torch.float16)
# consumers for which an upcast is deliberate numerics, not drift
SINK_OK = frozenset({"sum", "mean", "amax", "amin", "max", "min", "argmax",
                     "argmin", "var", "std", "logsumexp", "cumsum",
                     "_to_copy", "rsqrt", "_softmax", "_log_softmax",
                     "nll_loss_forward", "copy_"})


def _upcast_source(node, seen=None) -> bool:
    """Whether `node`'s value is a bf16 / f16 value widened to f32 (through
    views)."""
    seen = seen or set()
    if node in seen or node.op != "call_function":
        return False
    seen.add(node)
    name = str(node.target).split(".")[1] if "." in str(node.target) else ""
    if name in ("_to_copy", "to", "convert_element_type"):
        src = node.args[0]
        sv, dv = src.meta.get("val"), node.meta.get("val")
        return getattr(sv, "dtype", None) in LOW \
            and getattr(dv, "dtype", None) == torch.float32
    if name in ("view", "_unsafe_view", "t", "transpose", "permute",
                "expand", "reshape", "unsqueeze", "squeeze", "clone",
                "contiguous"):
        return _upcast_source(node.args[0], seen)
    return False


@register_rule
class DtypePromotionRule(Rule):
    """f32 upcasts inside bf16 compute. Two shapes:

    - a bf16 -> f32 conversion whose result feeds elementwise compute:
      the tensor doubles its HBM traffic from there on;
    - an f32 product over an operand widened from bf16: it runs on the
      CUDA cores at the f32 rate (67 TFLOP/s on the H100 row against 989
      for bf16; the port does not enable TF32).

    Reductions and the kernels' own f32 accumulation do not trip it."""

    id = "TPU301"
    name = "dtype-promotion"
    default_severity = Severity.WARNING
    MAX_REPORTS = 8

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        n = elided = 0
        for ctx in graph.nodes():
            dims = matmul_dims(ctx)
            if dims is not None:
                if dims[4] == torch.float32 and any(
                        _upcast_source(x) for x in ctx.node.all_input_nodes):
                    yield self.diag(
                        "f32 product over an operand widened from bf16: it "
                        "runs at the CUDA-core f32 rate",
                        where=ctx.path,
                        hint="multiply in bfloat16 with f32 accumulation "
                             "(torch.mm(..., out_dtype=torch.float32))")
                continue
            if ctx.packet not in ("_to_copy", "convert_element_type"):
                continue
            if not _upcast_source(ctx.node):
                continue
            compute = [c for c in graph.consumers(ctx.node)
                       if c.packet not in SINK_OK and not c.is_kernel
                       and matmul_dims(c) is None]
            if not compute:
                continue
            n += 1
            if n > self.MAX_REPORTS:
                elided += 1
                continue
            out = ctx.outputs[0]
            ops = sorted({c.packet for c in compute})
            yield self.diag(
                f"bfloat16→float32 upcast of {list(out.shape)} feeds "
                f"compute ({', '.join(ops[:4])}); the path pays f32 "
                "bandwidth from here on",
                where=ctx.path,
                hint="check for a stray f32 operand promoting the whole "
                     "expression; cast it down once at the source")
        if elided:
            yield self.diag(f"{elided} more upcast finding(s) elided "
                            f"(first {self.MAX_REPORTS} shown)",
                            where=graph.name)


# ---------------------------------------------------------------------------
# TPU401: collective hygiene
# ---------------------------------------------------------------------------

@register_rule
class CollectiveRule(Rule):
    """Four checks over the collective operators' nodes (the
    ``analysis/comms.py`` inventory, which also carries the byte math):

    - dead: the collective's result is never used, yet every rank still
      pays the exchange (a send-only ``ppermute`` hop excepted);
    - duplicate: two identical collectives over the same operand and
      group (fold into one);
    - unknown axis: the group's axis is not in the `mesh_axes=` the
      caller declared (skipped when not declared), ERROR;
    - unquantized large payload: a collective moving more than
      `max_collective_bytes` (default 0 = off: TPU803 owns the
      default-threshold size check) of float data, amplified by the
      program's unrolled steps; a site repeated by the steps reports at
      the rule's severity, a one-shot one at INFO.
    """

    id = "TPU401"
    name = "collectives"
    default_severity = Severity.WARNING

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        from . import comms as _comms

        mesh_axes = self.config.get("mesh_axes")
        max_bytes = self.config.get("max_collective_bytes", 0)
        if max_bytes:
            for ev in _comms.audit_graph(graph).collectives:
                payload = ev.float_payload_bytes
                amplified = ev.total_float_payload_bytes
                if not payload or amplified <= max_bytes:
                    continue
                if ev.in_loop:
                    amp = (f" x {ev.count} iterations = {amplified} "
                           f"bytes" if ev.count > 1 else "")
                    desc = (f"per iteration inside a loop body"
                            f"{amp} (> {max_bytes})")
                else:
                    desc = f"(> {max_bytes}) per call"
                yield self.diag(
                    f"{ev.kind} over {ev.axes} moves {payload} "
                    f"bytes of float payload " + desc,
                    where=ev.path,
                    severity=None if ev.in_loop else Severity.INFO,
                    hint="quantize the payload (absmax int8 + f32 "
                         "scale sidecar: quantized_collectives) or "
                         "shrink it; raise max_collective_bytes= if "
                         "this size is intended")
        seen: Dict[tuple, NodeCtx] = {}
        for ctx in graph.nodes():
            if not _comms.is_collective(ctx):
                continue
            kind = _comms.collective_kind(ctx)
            axes = _comms.collective_axes(ctx)
            if mesh_axes is not None:
                for a in axes:
                    if a not in mesh_axes:
                        yield self.diag(
                            f"{kind} over axis {a!r} which is not in the "
                            f"mesh axes {tuple(mesh_axes)}",
                            where=ctx.path,
                            hint="a collective outside the mesh's groups "
                                 "raises at run time (no group is "
                                 "registered for it)",
                            severity=Severity.ERROR)
            # a send-only hop (a ppermute receiving nothing) returns an
            # empty tensor: its work is the send
            send_only = kind == "ppermute" and int(ctx.node.args[4]) < 0
            if not ctx.node.users and not send_only:
                yield self.diag(
                    f"result of {kind} over {axes} is never used (a dead "
                    "collective still makes every rank exchange)",
                    where=ctx.path,
                    hint="delete it, or consume its result")
                continue
            key = (ctx.op, tuple(str(a) for a in ctx.node.args[1:]),
                   ctx.node.args[0])
            prev = seen.get(key)
            if prev is not None:
                yield self.diag(
                    f"duplicate {kind} over {axes} on the same operand "
                    f"(first at {prev.path})",
                    where=ctx.path,
                    hint="reuse the first result; each copy is a full "
                         "exchange")
            else:
                seen[key] = ctx


# ---------------------------------------------------------------------------
# TPU501 / 601 / 602: host calls inside a program
# ---------------------------------------------------------------------------

def _host_call_name(ctx: NodeCtx) -> Optional[str]:
    if ctx.namespace == "paddle_tpu" and ctx.packet == "host_callback":
        return str(ctx.node.args[0])
    return None


def host_syncs(graph: Graph) -> List[tuple]:
    """(ctx, what) of every node that reads a device value on the host:
    ``.item()`` / ``.tolist()`` (``_local_scalar_dense``), a copy of a
    card tensor to the CPU (``.cpu()``), and the host calls a traced
    program made (`kernels._build.mark_host_call`)."""
    out = []
    for ctx in graph.nodes():
        name = _host_call_name(ctx)
        if name is not None:
            out.append((ctx, f"host call {name}"))
        elif ctx.packet == "_local_scalar_dense":
            out.append((ctx, ".item() / .tolist()"))
        elif ctx.packet in ("_to_copy", "to", "copy_"):
            src = ctx.node.args[0] if ctx.packet != "copy_" \
                else ctx.node.args[1]
            sv = getattr(src, "meta", {}).get("val")
            dv = ctx.node.meta.get("val")
            if getattr(sv, "device", None) is not None \
                    and sv.device.type == "cuda" \
                    and getattr(dv, "device", None) is not None \
                    and dv.device.type == "cpu":
                out.append((ctx, ".cpu()"))
    return out


@register_rule
class HostSyncRule(Rule):
    """A program that reads a device value on the host (``.item()``,
    ``.cpu()``, ``.tolist()``) cannot be captured as a CUDA graph (the
    capture fails) and, eager, stalls the stream until the value
    arrives. ERROR: every program of the port is a graph."""

    id = "TPU501"
    name = "host-sync"
    default_severity = Severity.ERROR

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        for ctx, what in host_syncs(graph):
            yield self.diag(
                f"{what} inside the program: the host waits for the card "
                "here, and a CUDA graph capture of the program fails",
                where=ctx.path,
                hint="keep the value on the device, or read it back once "
                     "after the program (the engine's host sets)")


class _HostCallRule(Rule):
    PATTERN = re.compile("$^")
    what = ""
    hint = ""

    def check(self, graph: Graph) -> Iterator[Diagnostic]:
        for ctx in graph.nodes():
            name = _host_call_name(ctx)
            if name is None or not self.PATTERN.search(name):
                continue
            yield self.diag(
                f"{self.what} `{name}` inside the program: it runs once "
                "when the program is captured and never on a replay (the "
                "port raises at run time under a capture)",
                where=ctx.path, hint=self.hint)


@register_rule
class CheckpointInProgramRule(_HostCallRule):
    """A checkpoint save inside a program: seconds of host I/O at capture
    time, never repeated by a replay (``resilience/checkpoint.py``
    raises under a capture). Save on the host at step boundaries."""

    id = "TPU601"
    name = "ckpt-in-program"
    default_severity = Severity.ERROR
    PATTERN = re.compile(r"checkpoint|ckpt|(?:\b|_|\.)save(?:\b|_)"
                         r"|serialize|state_dict", re.IGNORECASE)
    what = "checkpoint save"
    hint = ("checkpoint at step boundaries on the host; "
            "resilience.CheckpointManager.save(blocking=False) keeps the "
            "step from waiting on storage")


@register_rule
class TraceEmitterInProgramRule(_HostCallRule):
    """A trace span / instant / counter inside a program: taken once at
    capture, never per replay (``observability/trace.py`` raises
    TraceUnderJitError under a capture). Trace on the host between
    dispatches."""

    id = "TPU602"
    name = "trace-in-program"
    default_severity = Severity.ERROR
    PATTERN = re.compile(r"observability|(?:\b|_|\.)spans?(?:\b|_)"
                         r"|(?:\b|_|\.)instant|(?:\b|_|\.)counter"
                         r"|record_event|emit_event|chrome_trac",
                         re.IGNORECASE)
    what = "trace emitter"
    hint = ("emit spans on the host between dispatches; the recorder "
            "raises TraceUnderJitError under a capture for this reason")


def rule_config_for(rule_id: str, config: Dict) -> Dict:
    """This rule's knobs from a mixed rule_config: unprefixed keys go to
    every rule, ``TPUxxx.key`` keys to rule TPUxxx alone."""
    out = {k: v for k, v in config.items() if "." not in k}
    prefix = rule_id + "."
    for k, v in config.items():
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out


def default_rules(severity_overrides: Optional[Dict[str, Severity]] = None,
                  **config) -> List[Rule]:
    """Every registered rule, with per-rule severity overrides
    ({'TPU501': Severity.ERROR}, or None to disable) and prefixed config
    keys routed to their rule."""
    overrides = severity_overrides or {}
    out = []
    for rule_id, cls in sorted(RULES.items()):
        if rule_id in overrides and overrides[rule_id] is None:
            continue
        out.append(cls(severity=overrides.get(rule_id),
                       **rule_config_for(rule_id, config)))
    return out
