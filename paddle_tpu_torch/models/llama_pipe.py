"""Pipeline-parallel Llama training step (counterpart of
paddle_tpu/models/llama_pipe.py; reference: fleet PipelineLayer +
PipelineParallel.train_batch, pp_layers.py:257 SegmentLayers).

The decoder layers are grouped into `pp` stages; the per-stage parameter
dicts are stacked (``{sub-name: [S, layers a stage, ...]}``, each rank
keeping its stage's block, `parallel.pipeline_spmd.stack_stage_params`)
and the microbatch schedule runs on the pp ranks
(`parallel.pipeline_spmd`). The embedding, the final norm and the LM
head (the "outer" params) stay replicated over pp, as in JAX.

    step_fn, params, opt_state = make_llama_pp_train_step(model, mesh, ...)
    loss, params, opt_state = step_fn(params, opt_state, x, y)

``params`` is ``{"outer": {name: tensor}, "stages": {sub: block}}``, the
outer tensors the model's own (updated in place), the stage blocks new
tensors; ``opt_state`` an `AdamWState` keyed ``"outer/<name>"`` and
``"stages/<sub>"``. Every rank passes the same global batch:

- the rows split over the mesh's ``dp`` / ``sharding`` axes (JAX's
  ``batch_sharding`` of ``(("dp", "sharding"),)``: `trainer.row_axes`,
  `take_rows`), each rank's loss and gradients weighted by its share and
  summed over them;
- 1F1B / ZBH1 / Eager1F1B: the stages and the head in one pass
  (`pipeline_1f1b` and its twins); the embedding's gradient is closed by
  hand from the input's gradient (an index-put accumulation, JAX's
  ``.at[x].add``), every rank alike, so the outer gradients are whole on
  every rank; the head is cooperative by default when the vocab divides
  over pp (each rank holds vocab / pp of the head; the max, the sum of
  exponentials and the label's logit combine over pp: Paddle's
  ParallelCrossEntropy over the pipeline axis);
- FThenB / VPP: `pipeline_forward` / `pipeline_vpp_forward` and autograd,
  the head on every rank over the broadcast output (JAX's step); the
  last rank's head gradients and the first rank's embedding gradient are
  summed over pp (one all-reduce), so every rank holds them whole;
- inside a stage an ``mp`` axis above 1 runs the decoder layers at the
  rank's heads and columns (`TrainTP`: the layers' weights laid out by
  the rule table over mp, the outer params replicated);
- the update is JAX's AdamW with the global-norm clip, each stage
  block's squares summed over pp (and over mp where the block is split
  there), a replicated leaf counted once. The outer params start equal
  (broadcast from each axis's first rank) and stay bitwise equal over pp
  and dp, step after step.

Kernels: the stage's decoder layers launch the training kernels of
phase 13 (flash forward, dq, dkv and the delta pre-pass, rms_norm), and
the head's norm is the rms_norm kernel on every rank under the
cooperative head.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.func import functional_call

from ..device import resolve_device
from ..parallel import mesh as mesh_mod
from ..parallel.collectives import (all_gather, all_reduce, all_reduce_tree,
                                    broadcast_tree)
from ..parallel.pipeline_spmd import (pipeline_1f1b, pipeline_eager_1f1b,
                                      pipeline_forward, pipeline_vpp_forward,
                                      pipeline_zb1f1b, stack_stage_params)
from ..parallel.placement import dist_attr, spec_axes
from ..parallel.trainer import (adamw_update, init_adamw_state,
                                resolve_pipeline, row_axes, take_rows)
from .llama import (KERNEL_OPS, PLAIN_OPS, LlamaForCausalLM,
                    LlamaPretrainingCriterion, _param_sharding)

__all__ = ["make_llama_pp_train_step", "split_llama_state",
           "chunk_llama_state", "merge_llama_chunked_state",
           "merge_llama_state", "SCHEDULES"]

SCHEDULES = ("1F1B", "Eager1F1B", "FThenB", "VPP", "ZBH1")
ONE_PASS = ("1F1B", "Eager1F1B", "ZBH1")
_LAYER_PREFIX = "llama.layers."
_BATCH_SPEC = (("dp", "sharding"),)


def _parse_layer_state(state):
    """Split a flat state into (outer, per-layer list of sub-dicts)."""
    per_layer, outer = [], {}
    for k, v in state.items():
        if k.startswith(_LAYER_PREFIX):
            idx, sub = k[len(_LAYER_PREFIX):].split(".", 1)
            idx = int(idx)
            while len(per_layer) <= idx:
                per_layer.append({})
            per_layer[idx][sub] = v
        else:
            outer[k] = v
    return outer, per_layer


def _stack_layers(block):
    return {k: torch.stack([layer[k] for layer in block])
            for k in sorted(block[0])}


def split_llama_state(state: Dict[str, torch.Tensor], n_layers: int,
                      n_stages: int, mesh=None):
    """(outer params, stacked stage params): the layers in n_stages
    contiguous blocks (SegmentLayers' uniform partition), stacked
    [n_stages, layers a stage, ...]; on a pp mesh each rank keeps its
    stage's block."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages} stages")
    outer, per_layer = _parse_layer_state(state)
    lps = n_layers // n_stages
    per_stage = [_stack_layers(per_layer[s * lps:(s + 1) * lps])
                 for s in range(n_stages)]
    return outer, stack_stage_params(per_stage, mesh, axis="pp")


def chunk_llama_state(state: Dict[str, torch.Tensor], n_layers: int,
                      n_stages: int, vpp_degree: int, mesh=None):
    """(outer, chunked stage params) for VPP: n_stages * vpp_degree chunks
    of contiguous layers laid out [S, V, layers a chunk, ...] with [r, v]
    = chunk v * S + r (Megatron's interleaved assignment)."""
    n_chunks = n_stages * vpp_degree
    if n_layers % n_chunks:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_chunks} chunks (pp={n_stages} x "
                         f"V={vpp_degree})")
    outer, per_layer = _parse_layer_state(state)
    lpc = n_layers // n_chunks
    chunks = [_stack_layers(per_layer[c * lpc:(c + 1) * lpc])
              for c in range(n_chunks)]
    per_rank = [{k: torch.stack([chunks[v * n_stages + r][k]
                                 for v in range(vpp_degree)])
                 for k in chunks[0]} for r in range(n_stages)]
    return outer, stack_stage_params(per_rank, mesh, axis="pp")


def _whole(t):
    """A stacked leaf whole: a pp rank's block gathered over its axis."""
    attr = dist_attr(t)
    if attr is None or not attr.spec or "pp" not in spec_axes(attr.spec[0]):
        return t
    return all_gather(t.contiguous(), attr.mesh.axis_ref("pp"), 0)


def merge_llama_chunked_state(outer: Dict, chunked, n_layers: int) -> Dict:
    """Inverse of `chunk_llama_state` (a rank's blocks gathered over pp
    first: every pp rank calls it)."""
    state = dict(outer)
    for sub, arr in sorted(chunked.items()):
        arr = _whole(arr)
        n_stages, vpp = arr.shape[0], arr.shape[1]
        lpc = n_layers // (n_stages * vpp)
        for r in range(n_stages):
            for v in range(vpp):
                c = v * n_stages + r
                for i in range(lpc):
                    state[f"{_LAYER_PREFIX}{c * lpc + i}.{sub}"] = \
                        arr[r, v, i]
    return state


def merge_llama_state(outer: Dict, stacked, n_layers: int) -> Dict:
    """Inverse of `split_llama_state` (for state_dict / checkpoint
    export; a rank's blocks gathered over pp first)."""
    state = dict(outer)
    for sub, arr in sorted(stacked.items()):
        arr = _whole(arr)
        lps = n_layers // arr.shape[0]
        for s in range(arr.shape[0]):
            for i in range(lps):
                state[f"{_LAYER_PREFIX}{s * lps + i}.{sub}"] = arr[s, i]
    return state


def _stage_tp_plan(model, mesh):
    """The mp layout inside the stages: each decoder-layer weight by the
    rule table over mp alone, the outer params replicated."""
    from ..parallel.sharding import ShardPlan

    specs, shapes = {}, {}
    for name, p in model.named_parameters():
        shapes[name] = tuple(p.shape)
        if name.startswith(_LAYER_PREFIX):
            spec = _param_sharding(mesh, name, p.ndim, shapes[name])
            specs[name] = tuple(a if a == "mp" else None for a in spec)
        else:
            specs[name] = (None,) * p.ndim
    return ShardPlan(mesh, specs, shapes)


def make_llama_pp_train_step(model: LlamaForCausalLM, mesh=None,
                             n_micro: Optional[int] = None,
                             lr: float = 1e-4, weight_decay: float = 0.01,
                             grad_clip_norm: Optional[float] = 1.0,
                             schedule: Optional[str] = None, strategy=None,
                             vpp_degree: Optional[int] = None,
                             coop_head: Optional[bool] = None, device=None):
    """Build (step_fn, params, opt_state) (module docstring) for `model`
    (trainable weights on `device`, default the CUDA card) over `mesh`
    (default the global mesh; its pp axis the stages).

    schedule (the pipeline-scheduler passes' names): "1F1B" (the
    default), "FThenB", "VPP" (`vpp_degree` chunks a rank, default 2;
    needs n_micro % pp == 0 and layers % (pp * vpp_degree) == 0), "ZBH1",
    "Eager1F1B". `strategy`: a pass output / strategy dict whose
    ``pipeline`` section supplies schedule_mode, accumulate_steps and
    vpp_degree; explicit arguments win (`trainer.resolve_pipeline`).
    coop_head (default: on for the 1F1B family when vocab % pp == 0):
    the cooperative vocab-parallel head."""
    schedule, n_micro, vpp_degree = resolve_pipeline(strategy, schedule,
                                                     n_micro, vpp_degree)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    mesh = mesh if mesh is not None else mesh_mod.get_global_mesh()
    dev = resolve_device(device)
    cfg = model.config
    S = int(mesh.shape["pp"]) if (mesh is not None
                                  and "pp" in mesh.axis_names) else 1
    if coop_head:
        if schedule not in ONE_PASS or S == 1:
            raise ValueError(
                "coop_head=True requires a 1F1B-family schedule with a "
                f"pp axis > 1 (got schedule={schedule!r}, pp={S}); "
                "FThenB/VPP compute the head once per step outside the "
                "pipeline, so there is nothing to cooperate on")
        if cfg.vocab_size % S != 0:
            raise ValueError(
                f"coop_head needs vocab_size ({cfg.vocab_size}) divisible "
                f"by the pp axis ({S}) to shard the head")
    if coop_head is None:
        coop_head = schedule in ONE_PASS and S > 1 \
            and cfg.vocab_size % S == 0
    mp = int(mesh.shape.get("mp", 1)) if mesh is not None else 1
    plan = model._shard_plan
    if plan is not None and any(
            any(e is not None for e in plan.specs[n])
            for n in plan.specs if not n.startswith(_LAYER_PREFIX)):
        raise ValueError("the pp step keeps the outer params replicated "
                         "(JAX's layout): pass a model whose embedding and "
                         "head are not laid out over the mesh")
    if mp > 1 and plan is None:
        model.apply_shard_plan(_stage_tp_plan(model, mesh))
        plan = model._shard_plan
    raw = {}
    for name, p in model.named_parameters():
        if p.device != dev:
            raise ValueError(f"{name} lives on {p.device}, the step on {dev}"
                             " (load the params there first)")
        raw[name] = p.detach()
    L = cfg.num_hidden_layers
    vpp = schedule == "VPP" and S > 1
    if vpp:
        outer, stages = chunk_llama_state(raw, L, S, vpp_degree, mesh)
        lps = L // (S * vpp_degree)
    else:
        outer, stages = split_llama_state(raw, L, S, mesh)
        lps = L // S
    lead = 3 if vpp else 2
    mp_dims = {k: (plan.mp_dim(f"{_LAYER_PREFIX}0.{k}") + lead
                   if plan is not None
                   and plan.mp_dim(f"{_LAYER_PREFIX}0.{k}") is not None
                   else None) for k in stages}
    if mesh is not None and mesh.size > 1:
        # the ranks start from the first rank's values on every axis that
        # replicates a tensor (JAX's one global value)
        for axis in mesh.axis_names:
            if mesh.shape[axis] <= 1:
                continue
            same = [outer[k] for k in sorted(outer)]
            if axis != "pp":
                same += [stages[k] for k in sorted(stages)
                         if not (axis == "mp" and mp_dims[k] is not None)]
            broadcast_tree(same, mesh.axis_ref(axis), 0)
    params = {"outer": outer, "stages": stages}
    flat = _flat(params)
    opt_state = init_adamw_state(flat)
    template = model.llama.layers[0]
    ops = KERNEL_OPS if model.use_kernels else PLAIN_OPS
    crit = LlamaPretrainingCriterion(cfg)
    eps = cfg.rms_norm_eps
    tied = cfg.tie_word_embeddings
    emb_key = "llama.embed_tokens.weight"
    head_key = emb_key if tied else "lm_head.weight"
    ref = mesh.axis_ref("pp") if S > 1 else None

    def stage_fn(sp, h):
        pos = torch.arange(h.shape[1], device=h.device)
        for i in range(lps):
            h = functional_call(template, {k: v[i] for k, v in sp.items()},
                                (h, pos, ops))
        return h

    def logits_of(hp, hidden):
        h = ops.rms_norm(hidden, hp["llama.norm.weight"], eps)
        w = hp[head_key]
        return h @ w.T if tied else h @ w

    def head_fn(hp, hidden, y_mb):
        """Final norm + LM head + CE of one microbatch (the last stage's
        tail)."""
        return crit(logits_of(hp, hidden), y_mb).to(torch.float32)

    vocab_shard = cfg.vocab_size // S

    def coop_head_fn(hp, hidden, y_mb):
        """This rank's vocab / pp of the head: the softmax-CE pieces
        combined over pp (the max with no gradient, the sums of
        exponentials and the label's logit by all-reduces, whose
        backward is the identity: every rank holds the same loss)."""
        lg = logits_of(hp, hidden).to(torch.float32)      # [mb, s, Vs]
        off = ref.rank * vocab_shard
        with torch.no_grad():
            m = all_reduce(lg.amax(dim=-1), ref, op="max")
        se = all_reduce(torch.exp(lg - m[..., None]).sum(dim=-1), ref)
        log_z = m + torch.log(se)
        lb = y_mb.long()
        local = (lb >= off) & (lb < off + vocab_shard)
        idx = torch.clamp(lb - off, 0, vocab_shard - 1)
        corr = torch.gather(lg, -1, idx[..., None])[..., 0]
        corr = all_reduce(torch.where(local, corr, torch.zeros_like(corr)),
                          ref)
        return torch.mean(log_z - corr)

    head_keys = sorted({"llama.norm.weight", head_key})
    head_specs = None
    if coop_head:
        head_specs = {"llama.norm.weight": (),
                      head_key: ("pp", None) if tied else (None, "pp")}
    pipe = {"ZBH1": pipeline_zb1f1b,
            "Eager1F1B": pipeline_eager_1f1b}.get(schedule, pipeline_1f1b)

    def one_pass(p, x, y):
        emb_w = p["outer"][emb_key]
        hidden = emb_w.detach()[x]
        head_p = {k: p["outer"][k] for k in head_keys}
        loss, d_st, d_head, d_hid = pipe(
            stage_fn, coop_head_fn if coop_head else head_fn, p["stages"],
            head_p, hidden, y, mesh=mesh, axis="pp", n_micro=n_micro,
            head_specs=head_specs)
        # the embedding lookup's gradient, closed by hand: d_emb[v] = the
        # sum of d_hidden's rows whose token is v (deterministic, so every
        # rank's is bitwise the same)
        d_emb = torch.zeros(emb_w.shape, dtype=torch.float32,
                            device=emb_w.device).index_put_(
            (x.reshape(-1),), d_hid.reshape(-1, emb_w.shape[1]).to(
                torch.float32), accumulate=True)
        d_outer = {k: d_head[k] if k in d_head else torch.zeros_like(v)
                   for k, v in p["outer"].items()}
        d_outer[emb_key] = d_outer[emb_key] + d_emb.to(emb_w.dtype)
        return loss, {"outer": d_outer, "stages": d_st}

    def autodiff(p, x, y):
        """FThenB / VPP (and pp = 1): the pipeline forward, the head on
        every rank over its output, autograd. Only the last rank's head
        reaches the outer weights and only the first rank's lookup gets
        the input's gradient, so one sum over pp makes them whole."""
        o = {k: v.detach().requires_grad_(True)
             for k, v in p["outer"].items()}
        st = {k: _leaf_like(v) for k, v in p["stages"].items()}
        last = ref is None or ref.rank == S - 1
        with torch.enable_grad():
            hidden = o[emb_key][x]
            if vpp:
                hidden = pipeline_vpp_forward(stage_fn, st, hidden,
                                              mesh=mesh, axis="pp",
                                              n_micro=n_micro)
            else:
                hidden = pipeline_forward(stage_fn, st, hidden, mesh=mesh,
                                          axis="pp", n_micro=n_micro)
            hp = o if last else {k: v.detach() for k, v in o.items()}
            loss = head_fn(hp, hidden, y)
            loss.backward()
        d_outer = {k: v.grad if v.grad is not None else torch.zeros_like(v)
                   for k, v in o.items()}
        if ref is not None:
            d_outer = all_reduce_tree(d_outer, ref)
        d_st = {k: v.grad if v.grad is not None else torch.zeros_like(v)
                for k, v in st.items()}
        return loss.detach(), {"outer": d_outer, "stages": d_st}

    def reduce_sq(names, sqs):
        """Stage blocks' squares summed over pp, and over mp where the
        block is split there; a replicated leaf counts once."""
        groups = {}
        for i, n in enumerate(names):
            kind, _, k = n.partition("/")
            axes = ()
            if kind == "stages":
                axes = tuple(a for a in ("pp",) if S > 1) + (
                    ("mp",) if mp_dims[k] is not None else ())
            groups.setdefault(axes, []).append(i)
        out = list(sqs)
        for axes in sorted(groups):
            if not axes:
                continue
            idx = groups[axes]
            red = torch.stack([sqs[i] for i in idx])
            for a in axes:
                red = all_reduce(red, mesh.axis_ref(a))
            for j, i in enumerate(idx):
                out[i] = red[j]
        return out

    def step_fn(p, state, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        axes, share = (), 1.0
        if mesh is not None and mesh.size > 1:
            axes = row_axes(mesh, (x, y), _BATCH_SPEC)
            if axes:
                (x, y), share = take_rows(mesh, (x, y), axes)
        if schedule in ONE_PASS and S > 1:
            loss, grads = one_pass(p, x, y)
        else:
            loss, grads = autodiff(p, x, y)
        flat_g = _flat(grads)
        if axes:
            group = mesh.group_ref(axes)
            flat_g = all_reduce_tree({k: g * share
                                      for k, g in flat_g.items()}, group)
            loss = all_reduce(loss * share, group)
        _, state = adamw_update(_flat(p), flat_g, state, lr,
                                weight_decay=weight_decay,
                                grad_clip_norm=grad_clip_norm,
                                reduce_sq=reduce_sq if mesh is not None
                                and mesh.size > 1 else None)
        return loss, p, state

    step_fn.schedule, step_fn.n_micro = schedule, n_micro
    step_fn.vpp_degree, step_fn.coop_head = vpp_degree, coop_head
    step_fn.layers_per_stage = lps * (vpp_degree if vpp else 1)
    step_fn.stage_mp_dims = mp_dims
    return step_fn, params, opt_state


def _leaf_like(v: torch.Tensor) -> torch.Tensor:
    """A leaf that requires grad over `v`'s storage, keeping its
    `DistAttr` (a pp rank's stage block)."""
    t = v.detach().requires_grad_(True)
    if dist_attr(v) is not None:
        t._dist = dist_attr(v)
    return t


def _flat(tree) -> Dict[str, torch.Tensor]:
    """{"outer": {...}, "stages": {...}} -> {"outer/<k>": ..., ...}."""
    return {f"{kind}/{k}": v for kind in ("outer", "stages")
            for k, v in tree[kind].items()}
