"""Paddle's collective communication API (``paddle.distributed.*``) on
torch tensors (counterpart of paddle_tpu/parallel/collective.py).

The JAX facade maps a group to mesh axes of one controller and its calls
to XLA collectives inside ``shard_map`` (identity outside one). Here every
rank is a process, so the calls are the real exchanges, over the
collective operators of `parallel/collectives.py` where one exists (so a
traced program records them for the communication audit) and
torch.distributed's own calls for the rest (objects, point to point,
barrier). The JAX facade stands on the JAX package's Tensor; this one
takes torch tensors. Paddle's in-place signatures are kept: `all_reduce`,
`broadcast` and `scatter` write into their tensor and return it.

Outside a process group (or in a group of one) every call is the identity
on this rank's values, as the JAX facade is outside ``shard_map``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from . import collectives as _c
from . import mesh as mesh_mod
from .ranks import GroupRef, group_ref, ranks_key, register_group

__all__ = [
    "Group", "new_group", "get_group", "all_reduce", "all_gather",
    "all_gather_object", "all_to_all", "all_to_all_single", "reduce_scatter",
    "broadcast", "reduce", "scatter", "gather", "barrier", "send", "recv",
    "isend", "irecv", "ReduceOp", "stream",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A process group by its ranks (Paddle's communication Group):
    `ref` is the collectives' reference to it."""

    def __init__(self, ref: GroupRef, ranks: List[int], pg=None,
                 id: int = 0):
        self.ref = ref
        self.ranks = list(ranks)
        self.pg = pg
        self.id = id

    @property
    def nranks(self) -> int:
        return self.ref.size

    world_size = nranks

    @property
    def rank(self) -> int:
        return self.ref.rank

    @property
    def process_group(self):
        return self.pg

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_groups: List[Group] = []


def _world() -> Group:
    if not dist.is_initialized():
        return Group(GroupRef("world", 1, 0), [0])
    n = dist.get_world_size()
    return Group(GroupRef("world", n, dist.get_rank()), list(range(n)),
                 dist.group.WORLD)


def new_group(ranks=None, backend=None, timeout=None, axis=None) -> Group:
    """A group over `ranks` (default: every rank). Every rank of the
    default group must call it, in the same order (``new_group`` is
    collective); `axis` names it for the audit (default "group")."""
    if not dist.is_initialized():
        g = Group(GroupRef(ranks_key(axis or "group", [0]), 1, 0), [0],
                  id=len(_groups) + 1)
    else:
        ranks = list(range(dist.get_world_size())) if ranks is None \
            else sorted(int(r) for r in ranks)
        pg = dist.new_group(ranks, backend=backend)
        ref = register_group(axis or "group", ranks, pg) \
            if dist.get_rank() in ranks else GroupRef(
                ranks_key(axis or "group", ranks), len(ranks), -1)
        g = Group(ref, ranks, pg, id=len(_groups) + 1)
    _groups.append(g)
    return g


def get_group(id: int = 0) -> Optional[Group]:
    """Group `id` (0: the default group)."""
    if id == 0:
        return _world()
    for g in _groups:
        if g.id == id:
            return g
    return None


def _ref(group) -> GroupRef:
    """The collectives' reference for a facade group argument: None (the
    global mesh's dp axis when one is set, else the default group), a
    Group, a mesh axis name, or a GroupRef / ProcessGroup."""
    if group is None:
        mesh = mesh_mod.get_global_mesh()
        if mesh is not None and "dp" in mesh.refs:
            return mesh.axis_ref("dp")
        if not dist.is_initialized():
            return GroupRef("world", 1, 0)
        return group_ref(None)
    if isinstance(group, Group):
        return group.ref
    if isinstance(group, str):
        mesh = mesh_mod.get_global_mesh()
        if mesh is None or group not in mesh.refs:
            raise ValueError(f"no mesh axis {group!r}: set a global mesh "
                             "(parallel.mesh.build_mesh / set_global_mesh)")
        return mesh.axis_ref(group)
    return group_ref(group)


def _pg(group):
    from .ranks import resolve_group

    ref = _ref(group)
    return None if ref.size == 1 else resolve_group(ref.key)


def _reduce(x: torch.Tensor, op, ref: GroupRef) -> torch.Tensor:
    if op in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN):
        return _c.all_reduce(x, ref, op=op)
    if op == ReduceOp.AVG:
        return _c.all_reduce(x, ref) / ref.size
    if op == ReduceOp.PROD:
        # a gather and a product: exact for zeros and negatives
        return torch.prod(_c.all_gather(x[None], ref, 0), dim=0)
    raise ValueError(f"unknown reduce op {op!r}")


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce `tensor` over the group in place; returns it."""
    ref = _ref(group)
    if ref.size > 1:
        with torch.no_grad():
            tensor.copy_(_reduce(tensor, op, ref))
    return tensor


def all_gather(tensor_list, tensor=None, group=None, sync_op=True,
               axis=0):
    """Paddle's ``all_gather(tensor_list, tensor)``: every rank's `tensor`
    appended to `tensor_list` in rank order. The functional form (the
    tensor alone) returns them stacked on a new leading dim."""
    if tensor is None and not isinstance(tensor_list, list):
        tensor, tensor_list = tensor_list, None
    ref = _ref(group)
    out = _c.all_gather(tensor[None], ref, 0) if ref.size > 1 \
        else tensor[None]
    if tensor_list is not None:
        tensor_list.extend(out[i] for i in range(out.shape[0]))
        return None
    return out


def all_gather_object(object_list, obj, group=None):
    """Every rank's picklable `obj` appended to `object_list`."""
    ref = _ref(group)
    if ref.size == 1:
        object_list.append(obj)
        return
    out = [None] * ref.size
    dist.all_gather_object(out, obj, group=_pg(group))
    object_list.extend(out)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """This rank's chunk of the group's reduction of `tensor_list`
    concatenated (or of `tensor`), split evenly on dim 0; written into
    `tensor` when a list is given. An all-reduce and a slice: gloo has no
    reduce-scatter."""
    ref = _ref(group)
    src = torch.cat(list(tensor_list)) if tensor_list is not None \
        else tensor
    if src.shape[0] % ref.size:
        raise ValueError(f"reduce_scatter: dim 0 ({src.shape[0]}) does not "
                         f"split into {ref.size} ranks")
    red = _reduce(src, op, ref) if ref.size > 1 else src
    out = red.reshape(ref.size, -1, *src.shape[1:])[ref.rank]
    if tensor_list is not None:
        with torch.no_grad():
            tensor.copy_(out)
        return tensor
    return out


def all_to_all(out_tensor_list, in_tensor_list=None, group=None,
               sync_op=True):
    """List form: in_tensor_list[j] goes to rank j; the result's j-th
    entry came from rank j (tensors of one shape)."""
    if in_tensor_list is None:
        in_tensor_list, out_tensor_list = out_tensor_list, None
    ref = _ref(group)
    if ref.size == 1:
        res = list(in_tensor_list)
    else:
        x = _c.all_to_all(torch.stack(list(in_tensor_list)), ref)
        res = [x[i] for i in range(x.shape[0])]
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(res)
        return None
    return res


def all_to_all_single(out_tensor, in_tensor=None, out_split_sizes=None,
                      in_split_sizes=None, group=None, sync_op=True):
    """`in_tensor` split evenly on dim 0 across the group; the chunks
    received concatenate on dim 0 (uneven splits are refused)."""
    if in_tensor is None:
        in_tensor, out_tensor = out_tensor, None
    if out_split_sizes or in_split_sizes:
        if len(set(list(out_split_sizes or []) + list(in_split_sizes
                                                      or []))) > 1:
            raise NotImplementedError("all_to_all_single: uneven splits")
    ref = _ref(group)
    n = ref.size
    if in_tensor.shape[0] % n:
        raise ValueError(f"all_to_all_single: dim 0 ({in_tensor.shape[0]}) "
                         f"does not split into {n} ranks")
    out = in_tensor if n == 1 else _c.all_to_all(
        in_tensor.reshape(n, -1, *in_tensor.shape[1:]), ref).reshape(
            in_tensor.shape)
    if out_tensor is not None:
        with torch.no_grad():
            out_tensor.copy_(out)
        return out_tensor
    return out


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Rank `src`'s (a global rank, Paddle's convention) `tensor` on every
    rank, in place."""
    ref = _ref(group)
    if ref.size > 1:
        g = group if isinstance(group, Group) else None
        idx = g.get_group_rank(src) if g is not None else int(src)
        with torch.no_grad():
            tensor.copy_(_c.broadcast(tensor, ref, idx))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on every rank (Paddle leaves non-`dst` ranks'
    values unspecified)."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank `src`'s tensor_list[i] written into rank i's `tensor`."""
    ref = _ref(group)
    if ref.size == 1:
        if tensor_list:
            with torch.no_grad():
                tensor.copy_(tensor_list[0])
        return tensor
    stacked = torch.stack(list(tensor_list)) if tensor_list \
        else torch.empty((ref.size, *tensor.shape), dtype=tensor.dtype,
                         device=tensor.device)
    g = group if isinstance(group, Group) else None
    idx = g.get_group_rank(src) if g is not None else int(src)
    with torch.no_grad():
        tensor.copy_(_c.broadcast(stacked, ref, idx)[ref.rank])
    return tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's `tensor` into `gather_list` (on every rank)."""
    return all_gather(gather_list if gather_list is not None else [],
                      tensor, group=group)


def barrier(group=None):
    if _ref(group).size > 1:
        dist.barrier(group=_pg(group))


def _p2p(tensor, peer, group, send_: bool):
    """Point to point through the ``ppermute`` operator (`collectives.
    send_recv`), so a traced program records it; `peer` is a rank of the
    default group. Synchronous, as JAX's isend / irecv are."""
    ref = _ref(group)
    if ref.size == 1:
        return tensor
    pg = _pg(group)
    idx = int(peer) if pg is dist.group.WORLD \
        else dist.get_group_rank(pg, int(peer))
    if send_:
        _c.send_recv(tensor, ref, dst=idx)
    else:
        got = _c.send_recv(tensor, ref, src=idx)
        with torch.no_grad():
            tensor.copy_(got)
    return tensor


def send(tensor, dst=0, group=None, sync_op=True):
    return _p2p(tensor, dst, group, True)


def recv(tensor, src=0, group=None, sync_op=True):
    return _p2p(tensor, src, group, False)


class _DoneTask:
    """The task of a point-to-point call made blocking (its host staging
    must finish before the call returns)."""

    def wait(self):
        return None

    def is_completed(self):
        return True


def isend(tensor, dst=0, group=None):
    send(tensor, dst, group)
    return _DoneTask()


def irecv(tensor, src=0, group=None):
    recv(tensor, src, group)
    return _DoneTask()


class _StreamNS:
    """``paddle.distributed.stream.*``: the same calls (the port makes
    each on the caller's stream)."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    all_to_all = staticmethod(all_to_all)
    all_to_all_single = staticmethod(all_to_all_single)
    reduce_scatter = staticmethod(reduce_scatter)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    scatter = staticmethod(scatter)
    gather = staticmethod(gather)
    send = staticmethod(send)
    recv = staticmethod(recv)


stream = _StreamNS()
