"""Graph capture and traversal for the lint pipeline (counterpart of
paddle_tpu/analysis/graph.py, on torch graphs).

`trace_graph` turns a callable (a function of tensors, an ``nn.Module``
or a bound method of one) into a `Graph`: a ``torch.fx`` graph recorded
by ``make_fx`` over FAKE tensors (``FakeTensorMode.from_tensor``), so
tracing reads no data, allocates no device memory and launches nothing,
whatever device the inputs live on. A module's parameters and buffers are
threaded as inputs (reparametrized, as ``torch.func.functional_call``
does), so weights do not read as captured constants. Python scalars among
the arguments stay in the closure, as a CUDA graph capture would bake
them in, and are recorded for the recompile-risk rule (TPU201).

Every hand-written kernel is an operator ``paddle_tpu::<name>``
(``kernels/_build.kernel_op``), so each launch is one node; there are no
loops in a torch graph (a Python loop unrolls), so a node's count is
always one and the graph holds every iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.fx
from torch.fx.experimental.proxy_tensor import make_fx
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils import _pytree as pytree

from ..kernels._build import OP_NAMESPACE
from ..kernels.constraints import TensorMeta

# schema types whose Python values are data a caller threads through (a
# scale, a step count), not structure (a dim, a size, a flag)
_DATA_TYPES = ("Scalar", "float", "float?", "Scalar?", "Tensor", "Tensor?")


def tensor_meta(v) -> Optional[TensorMeta]:
    if isinstance(v, torch.Tensor):
        return TensorMeta(tuple(int(s) for s in v.shape), v.dtype)
    return None


def _op_name(target) -> str:
    return str(target)          # "aten.mm.default", "paddle_tpu.rms_norm..."


@dataclasses.dataclass(frozen=True)
class NodeCtx:
    """One call in context: the fx node, its index among the program's
    calls and its location string."""

    node: torch.fx.Node
    index: int
    path: str

    @property
    def op(self) -> str:
        return _op_name(self.node.target)

    @property
    def namespace(self) -> str:
        return self.op.split(".", 1)[0]

    @property
    def packet(self) -> str:
        """The operator without namespace and overload ("mm", "rms_norm")."""
        return self.op.split(".")[1] if "." in self.op else self.op

    @property
    def is_kernel(self) -> bool:
        """A launch of one of the port's hand-written kernels."""
        return self.namespace == OP_NAMESPACE \
            and self.packet != "host_callback"

    @property
    def schema(self):
        return getattr(self.node.target, "_schema", None)

    @property
    def args(self) -> Dict[str, Any]:
        """Schema argument name -> TensorMeta (a tensor), a list of them
        (a tensor list), or the Python value."""
        out = {}
        schema = self.schema
        if schema is None:
            return out

        def meta(v):
            if isinstance(v, torch.fx.Node):
                return tensor_meta(v.meta.get("val"))
            if isinstance(v, (list, tuple)):
                return [meta(x) for x in v]
            return v

        for i, a in enumerate(schema.arguments):
            if i < len(self.node.args):
                v = self.node.args[i]
            elif a.name in self.node.kwargs:
                v = self.node.kwargs[a.name]
            else:
                v = a.default_value if a.has_default_value() else None
            out[a.name] = meta(v)
        return out

    @property
    def outputs(self) -> List[TensorMeta]:
        val = self.node.meta.get("val")
        vals = val if isinstance(val, (list, tuple)) else [val]
        return [m for m in (tensor_meta(v) for v in vals) if m is not None]

    def input_metas(self) -> List[TensorMeta]:
        return [m for m in (tensor_meta(n.meta.get("val"))
                            for n in self.node.all_input_nodes)
                if m is not None]

    def written_args(self) -> List[torch.fx.Node]:
        """Input nodes the call writes in place (schema ``Tensor(a!)``)."""
        schema = self.schema
        out = []
        if schema is None:
            return out
        for i, a in enumerate(schema.arguments):
            info = a.alias_info
            if info is None or not info.is_write:
                continue
            v = self.node.args[i] if i < len(self.node.args) \
                else self.node.kwargs.get(a.name)
            for x in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(x, torch.fx.Node):
                    out.append(x)
        return out


class Graph:
    """A traced program plus the shared indexes rules consume."""

    def __init__(self, gm: torch.fx.GraphModule, name: str = "main",
                 example_args: Optional[tuple] = None,
                 scalar_args: Optional[List[Tuple[Any, str]]] = None):
        self.gm = gm
        self.graph = gm.graph
        self.name = name
        self.example_args = example_args
        # python-scalar call arguments as (value, label) pairs (a list:
        # 2 and 2.0 hash equal and must stay distinct); None when the
        # graph was not traced by `trace_graph`
        self.scalar_args = scalar_args
        # the times the program repeats one step (a decode chunk's
        # steps_per_sync, unrolled in the graph) and the ranks it runs on
        # (None: one, or unknown); the communication audit reads both
        self.unrolled_steps = 1
        self.mesh_size: Optional[int] = None
        self._nodes: Optional[List[NodeCtx]] = None
        self._ctx: Dict[torch.fx.Node, NodeCtx] = {}

    # -- traversal -----------------------------------------------------
    def nodes(self) -> List[NodeCtx]:
        """Every call of the program (``call_function`` nodes), in
        execution order."""
        if self._nodes is None:
            acc = []
            for n in self.graph.nodes:
                if n.op != "call_function":
                    continue
                ctx = NodeCtx(n, len(acc),
                              f"{self.name}/node[{len(acc)}]:"
                              f"{_op_name(n.target)}")
                acc.append(ctx)
                self._ctx[n] = ctx
            self._nodes = acc
        return self._nodes

    def ctx(self, node: torch.fx.Node) -> Optional[NodeCtx]:
        self.nodes()
        return self._ctx.get(node)

    def consumers(self, node: torch.fx.Node) -> List[NodeCtx]:
        return [c for c in (self.ctx(u) for u in node.users)
                if c is not None]

    def kernel_nodes(self) -> List[NodeCtx]:
        return [c for c in self.nodes() if c.is_kernel]

    # -- constants / literals -----------------------------------------
    def scalar_literals(self) -> List[Tuple[Any, NodeCtx, str]]:
        """(value, ctx, argument) for every Python number a call takes as
        data (a ``Scalar``, ``float`` or ``Tensor`` schema argument)."""
        out = []
        for ctx in self.nodes():
            schema = ctx.schema
            if schema is None:
                continue
            for i, a in enumerate(schema.arguments):
                if str(a.type) not in _DATA_TYPES:
                    continue
                v = ctx.node.args[i] if i < len(ctx.node.args) \
                    else ctx.node.kwargs.get(a.name)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out.append((v, ctx, a.name))
        return out

    def captured_consts(self) -> List[Tuple[str, TensorMeta]]:
        """(name, meta) of tensors the traced function captured from its
        closure (``get_attr`` nodes)."""
        out = []
        for n in self.graph.nodes:
            if n.op == "get_attr":
                m = tensor_meta(n.meta.get("val"))
                if m is not None:
                    out.append((str(n.target), m))
        return out


def fakes_on(device, tensors) -> list:
    """Fake tensors of `tensors`' shapes and dtypes on `device` (one fake
    mode, which `trace_graph` then traces in): a program's inputs on the
    card without device memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    mode = FakeTensorMode(allow_non_fake_inputs=True, shape_env=ShapeEnv(),
                          static_shapes=True)
    with mode:
        return [torch.empty(t.shape, dtype=t.dtype, device=device)
                for t in tensors]


def _module_of(fn):
    if isinstance(fn, torch.nn.Module):
        return fn
    owner = getattr(fn, "__self__", None)
    return owner if isinstance(owner, torch.nn.Module) else None


def trace_graph(fn: Callable, *args, name: Optional[str] = None,
                scalar_args: Optional[List[Tuple[Any, str]]] = None,
                grad: bool = False, **kwargs) -> Graph:
    """Trace ``fn(*args, **kwargs)`` to a `Graph` without running it.

    Tensor leaves of the arguments (real tensors on any device, meta
    tensors, or fakes) become the graph's inputs, faked first; a module's
    parameters and buffers come first. Other leaves stay in the closure;
    the Python numbers among them are recorded as `scalar_args`. Tensors
    `fn` captures from its own closure become constants (TPU202). With
    `grad` False (the default) the call runs under ``torch.no_grad()``, as
    the engine's programs do; a training step traces with grad on."""
    flat, spec = pytree.tree_flatten((args, kwargs))
    pos = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]
    if scalar_args is None:
        scalar_args = [(a, f"arg[{i}]") for i, a in enumerate(flat)
                       if i not in pos and isinstance(a, (int, float))
                       and not isinstance(a, bool)]
    module = _module_of(fn)
    state: Dict[str, torch.Tensor] = {}
    if module is not None:
        state = dict(module.named_parameters())
        state.update(dict(module.named_buffers()))
    names = list(state)

    def pure(*tensors):
        st = dict(zip(names, tensors[:len(names)]))
        leaves = list(flat)
        for i, t in zip(pos, tensors[len(names):]):
            leaves[i] = t
        call_args, call_kwargs = pytree.tree_unflatten(leaves, spec)
        with torch.set_grad_enabled(grad):
            if module is not None:
                with _reparametrize_module(module, st):
                    out = fn(*call_args, **call_kwargs)
            else:
                out = fn(*call_args, **call_kwargs)
        return pytree.tree_leaves(out)

    inputs = [state[n] for n in names] + [flat[i] for i in pos]
    inputs = [t.detach().requires_grad_(t.requires_grad) if grad
              else t.detach() for t in inputs]
    gm = make_fx(pure, tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*inputs)
    if name is None:
        name = getattr(fn, "__name__", None) or type(fn).__name__
    return Graph(gm, name=name,
                 example_args=tuple(tensor_meta(flat[i]) for i in pos),
                 scalar_args=scalar_args)
