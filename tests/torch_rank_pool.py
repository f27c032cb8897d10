"""A pool of spawned rank processes for the port's sharded-serving tests
(not a test module: the rank processes import it, and only torch, numpy
and the port).

`RankPool(n)` starts n processes once; `pool.run(world, fn, *args)` runs
``fn(*args)`` on ranks 0 .. world - 1 inside a fresh gloo default group
of `world` ranks (file:// rendezvous in the pool's directory; ranks past
`world` sit the task out) and returns their results in rank order. An
exception on any rank is raised here with its traceback. Module-scoped
fixtures keep one pool per test file, so a file pays the spawn once.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import traceback

import numpy as np

TASK_TIMEOUT_S = 300


def _rank_loop(rank, tasks, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    while True:
        task = tasks.get()
        if task is None:
            return
        world, path, fn, args = task
        if rank >= world:
            results.put((rank, True, None))
            continue
        try:
            dist.init_process_group("gloo", init_method=f"file://{path}",
                                    rank=rank, world_size=world)
            try:
                out = fn(*args)
            finally:
                dist.destroy_process_group()
            results.put((rank, True, out))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))


class RankPool:
    def __init__(self, n: int):
        ctx = mp.get_context("spawn")
        self.n = n
        self.dir = tempfile.mkdtemp(prefix="ptt_ranks_")
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_loop,
                                   args=(r, self._tasks[r], self._results),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()
        self._count = 0

    def run(self, world: int, fn, *args) -> list:
        if world > self.n:
            raise ValueError(f"the pool holds {self.n} ranks, not {world}")
        self._count += 1
        path = os.path.join(self.dir, f"rdv{self._count}")
        for q in self._tasks:
            q.put((world, path, fn, args))
        got = {}
        for _ in range(self.n):
            rank, ok, out = self._results.get(timeout=TASK_TIMEOUT_S)
            got[rank] = (ok, out)
        errors = [f"rank {r}:\n{out}" for r, (ok, out) in sorted(got.items())
                  if not ok]
        if errors:
            raise RuntimeError("\n".join(errors))
        return [got[r][1] for r in range(world)]

    def close(self):
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def _port_params(np_params):
    from paddle_tpu_torch.models import params_from_jax

    return params_from_jax(np_params, device="cpu")


def serve_rank(cfg_kw, np_params, engine_kw, prompts, max_new, pools=False):
    """Build an engine on this rank (the params sliced by
    `shard_serving_params` first), serve `prompts` and
    return (tokens a request, counters, kv_pool_bytes, megakernel rung,
    the rank's pools as numpy when asked, warnings)."""
    import warnings

    import torch

    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import (make_serving_tp,
                                               shard_serving_params)
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    cfg = LlamaConfig.tiny(**cfg_kw)
    p = _port_params(np_params)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tp = make_serving_tp(cfg, engine_kw.get("serving_mp", 1),
                             serving_cp=engine_kw.get("serving_cp", 1))
        if tp is not None:
            p = shard_serving_params(p, tp.bind())
        eng = ContinuousBatchingEngine(cfg, p, device="cpu",
                                       dtype=torch.float32, **engine_kw)
        reqs = [eng.add_request(pr, max_new=m)
                for pr, m in zip(prompts, max_new)]
        eng.run(max_iters=1000)
    assert all(r.done for r in reqs) and not eng.has_work
    counters = {k: getattr(eng, k) for k in (
        "prefill_calls", "device_steps", "prefill_handoffs",
        "prefix_hit_tokens", "prefix_inserts", "prefill_chunks")}
    out = dict(tokens=[list(r.tokens) for r in reqs], counters=counters,
               pool_bytes=eng.mgr.kv_pool_bytes(),
               max_pages=eng.mgr.max_pages, rung=eng.megakernel_rung,
               metrics={k: eng.metrics()[k] for k in (
                   "serving_mp", "serving_cp", "quantized_collectives",
                   "serving_backend")},
               graphs=eng.compile_stats().get("graphs"),
               n_available=eng.mgr.n_available,
               warnings=[str(w.message) for w in caught])
    if pools:
        def arr(x):
            if isinstance(x, tuple):
                return tuple(a.numpy().copy() for a in x)
            return x.numpy().copy()

        out["pools"] = [(arr(k), arr(v)) for k, v in zip(eng.kcs, eng.vcs)]
    return out


def serve_rank_cuda(engine_kw, prompts):
    """A tiny f32 engine on cuda:0 (random weights from seed 0) serving
    `prompts` on this rank: tokens, the backend, the graphs flag and the
    launch counts."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import init_serving_params
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    torch.cuda.set_device(0)
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)
    p = init_serving_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    eng = ContinuousBatchingEngine(cfg, p, device="cuda",
                                   dtype=torch.float32, **engine_kw)
    _build.reset_launch_counts()
    reqs = [eng.add_request(pr) for pr in prompts]
    eng.run(max_iters=1000)
    torch.cuda.synchronize()
    return dict(tokens=[list(r.tokens) for r in reqs],
                backend=(dist.get_backend() if eng._tp is not None
                         else None),
                graphs=eng.compile_stats().get("graphs"),
                launches=_build.launch_counts())


def generate_rank(cfg_kw, np_params, b, sb, max_new, ids, s0, tables):
    """build_paged_generate at the group's size as serving_mp."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import build_paged_generate

    cfg = LlamaConfig.tiny(**cfg_kw)
    run = build_paged_generate(cfg, b, sb, max_new, block_size=8,
                               serving_mp=dist.get_world_size())
    out = run(_port_params(np_params), torch.from_numpy(ids),
              torch.from_numpy(s0), torch.from_numpy(tables))
    return out.numpy()


def collective_rank(name, xs, kwargs):
    """Run `parallel.collectives.<name>` on this rank's `xs[rank]`."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import collectives

    x = torch.from_numpy(np.asarray(xs[dist.get_rank()]))
    out = getattr(collectives, name)(x, None, **kwargs)
    return out.numpy()


def prequant_rank(partials):
    """quantized_psum_prequant of this rank's partial, quantized here by
    `quantize_blocks`, against quantized_psum of the f32 partial."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import collectives as C

    x = torch.from_numpy(np.asarray(partials[dist.get_rank()]))
    q, s = C.quantize_blocks(x)
    a = C.quantized_psum_prequant(q, s, None, shape=x.shape,
                                  dtype=torch.float32)
    return a.numpy(), C.quantized_psum(x, None).numpy()


# ---------------------------------------------------------------------------
# data-parallel training, the collective facade and the sharded checkpoint
# ---------------------------------------------------------------------------

def _rank():
    import torch.distributed as dist

    return dist.get_rank()


def _tiny_train_model(np_params, cfg_kw=None):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(**(cfg_kw or {}))
    return LlamaForCausalLM(cfg).load_params(_port_params(np_params),
                                             trainable=True)


def dp_train_rank(np_params, x, y, steps, lr, strategy=None,
                  quantized=False, perturb=False):
    """`make_train_step(mesh=build_mesh({"dp": world}))` on tiny() f32
    over the global batch (x, y): (losses, params after the last step).
    `perturb` shifts ranks > 0's weights first (the step's broadcast from
    dp rank 0 must undo it)."""
    import torch

    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.parallel import build_mesh, make_train_step
    import torch.distributed as dist

    tm = _tiny_train_model(np_params)
    if perturb and _rank() > 0:
        with torch.no_grad():
            for p in tm.parameters():
                p.add_(0.01)
    crit = LlamaPretrainingCriterion(tm.config)
    mesh = build_mesh({"dp": dist.get_world_size()})
    step, p, s = make_train_step(tm, lambda lg, lb: crit(lg, lb), mesh,
                                 lr=lr, strategy=strategy, device="cpu",
                                 quantized_collectives=quantized)
    losses = []
    for _ in range(steps):
        loss, p, s = step(p, s, x, y)
        losses.append(float(loss))
    return losses, {k: v.detach().numpy().copy() for k, v in p.items()}


def data_parallel_rank(ws, xs, ys, lr):
    """paddle.DataParallel over an MLP Linear(8, 8) - Tanh - Linear(8, 2)
    (weights `ws`: JAX's [in, out] layouts) trained by SGD on this rank's
    rows of each global batch; returns the first layer's weight [in, out]
    and what the wrapper's checks saw."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.parallel import DataParallel

    def lin(w, b):
        m = torch.nn.Linear(*w.shape)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w).T)
            m.bias.copy_(torch.from_numpy(b))
        return m

    m = torch.nn.Sequential(lin(ws[0], ws[1]), torch.nn.Tanh(),
                            lin(ws[2], ws[3]))
    if _rank() > 0:           # the wrap broadcasts rank 0's weights
        with torch.no_grad():
            m[0].weight.add_(1.0)
    dp = DataParallel(m)
    r, n = _rank(), 2
    seen = {"state_dict": len(dp.state_dict())}
    for x, y in zip(xs, ys):
        rows = x.shape[0] // n
        xl = torch.from_numpy(x[r * rows:(r + 1) * rows])
        yl = torch.from_numpy(y[r * rows:(r + 1) * rows]).long()
        loss = F.cross_entropy(dp(xl), yl)
        loss.backward()
        with torch.no_grad():
            for p in m.parameters():
                p -= lr * p.grad
                p.grad = None
    # no_sync: a backward inside keeps this rank's own gradient
    xl = torch.from_numpy(xs[0][r * 4:(r + 1) * 4])
    with dp.no_sync():
        dp(xl).sum().backward()
    seen["no_sync_grad"] = m[0].weight.grad.numpy().copy()
    return m[0].weight.detach().numpy().T.copy(), seen


def psum_tree_rank(trees):
    """`quantized_psum_tree` of this rank's tree (a dict of numpy)."""
    import torch

    from paddle_tpu_torch.parallel.collectives import quantized_psum_tree

    t = {k: torch.from_numpy(v) for k, v in trees[_rank()].items()}
    return {k: v.numpy() for k, v in quantized_psum_tree(t).items()}


def facade_rank():
    """Paddle's collective API on torch tensors over the default group
    of 2 ranks: each call's result on this rank."""
    import torch

    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import env

    r = _rank()
    x = torch.arange(4, dtype=torch.float32) + 10 * r
    out = {"rank": env.get_rank(), "world": env.get_world_size(),
           "nranks": env.ParallelEnv().nranks}
    out["sum"] = C.all_reduce(x.clone()).numpy()
    out["max"] = C.all_reduce(x.clone(), op=C.ReduceOp.MAX).numpy()
    out["avg"] = C.all_reduce(x.clone(), op=C.ReduceOp.AVG).numpy()
    out["prod"] = C.all_reduce(x.clone() + 1, op=C.ReduceOp.PROD).numpy()
    lst = []
    C.all_gather(lst, x)
    out["gather"] = [t.numpy() for t in lst]
    objs = []
    C.all_gather_object(objs, {"r": r})
    out["objects"] = objs
    out["broadcast"] = C.broadcast(x.clone(), src=1).numpy()
    out["a2a"] = [t.numpy() for t in C.all_to_all(
        [x[:2] + 100 * j for j in range(2)])]
    out["a2a_single"] = C.all_to_all_single(x.clone()).numpy()
    out["reduce_scatter"] = C.reduce_scatter(x.clone()).numpy()
    dst = torch.zeros(2)
    C.scatter(dst, [torch.full((2,), 5.0), torch.full((2,), 7.0)], src=0)
    out["scatter"] = dst.numpy()
    g = C.new_group([0, 1], axis="dp")
    out["group"] = (g.nranks, g.rank, g.get_group_rank(1))
    buf = torch.zeros(3)
    if r == 0:
        C.send(torch.tensor([1.0, 2.0, 3.0]), dst=1)
    else:
        C.recv(buf, src=0)
    out["recv"] = buf.numpy()
    C.barrier()
    return out


def ckpt_save_rank(path, arrays, bf16_names, shard_name=None):
    """`save_state_dict` of numpy `arrays` (those named in `bf16_names`
    cast to bf16); `shard_name` is saved as this rank's `Shard` of rows
    of its array instead of a replicated tensor."""
    import torch

    from paddle_tpu_torch.parallel import save_state_dict
    from paddle_tpu_torch.parallel.checkpoint import Shard
    import torch.distributed as dist

    sd = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.asarray(v))
        if k in bf16_names:
            t = t.to(torch.bfloat16)
        if k == shard_name:
            n = t.shape[0] // dist.get_world_size()
            t = Shard(t[_rank() * n:(_rank() + 1) * n].clone(),
                      [_rank() * n] + [0] * (t.ndim - 1), list(t.shape))
        sd[k] = t
    save_state_dict(sd, path)
    dist.barrier()    # every rank's files are written before the listing
    return sorted(__import__("os").listdir(path))


class _LossRec:
    """A fit callback keeping each batch's logged loss."""

    def __init__(self):
        from paddle_tpu_torch.hapi.callbacks import Callback

        outer = self

        class Rec(Callback):
            def on_train_batch_end(self, step, logs=None):
                outer.losses.append(logs["loss"][0])

        self.losses = []
        self.cb = Rec()


def fit_dp_rank(np_params, batches, quantized, audit=False, shape=None):
    """`hapi.Model.fit` of tiny() (Adam 0.01, MSE of the logits against
    random targets: JAX's TestFitQuantizedDP model) under a dp mesh of
    the world (or `build_mesh(shape)`): (losses, quantized_dp_steps,
    params, comms_audit)."""
    import torch

    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import build_mesh, set_global_mesh
    import torch.distributed as dist

    net = _tiny_train_model(np_params)
    model = hapi.Model(net, device="cpu")
    model.prepare(optimizer=Adam(learning_rate=0.01,
                                 parameters=net.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    rec = _LossRec()
    set_global_mesh(build_mesh(shape or {"dp": dist.get_world_size()}))
    try:
        model.fit([(torch.from_numpy(a), torch.from_numpy(b))
                   for a, b in batches], epochs=1, verbose=0,
                  callbacks=[rec.cb], quantized_collectives=quantized,
                  audit_comms=audit)
    finally:
        set_global_mesh(None)
    return (rec.losses, model.quantized_dp_steps,
            {k: v.detach().numpy().copy()
             for k, v in net.named_parameters()}, model.comms_audit)


def fit_audit_rank(width, rows):
    """fit(audit_comms=True) of a Linear(width, width) (Adam, MSE) on one
    batch of `rows` rows under a dp mesh of the world: (comms_audit, the
    warnings' texts)."""
    import warnings

    import numpy as np
    import torch

    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import build_mesh, set_global_mesh
    import torch.distributed as dist

    torch.manual_seed(5)
    net = torch.nn.Linear(width, width)
    model = hapi.Model(net, device="cpu")
    model.prepare(optimizer=Adam(learning_rate=0.01,
                                 parameters=net.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    rng = np.random.default_rng(0)
    batch = [(torch.from_numpy(rng.normal(size=(rows, width))
                               .astype(np.float32)),
              torch.from_numpy(rng.normal(size=(rows, width))
                               .astype(np.float32)))]
    set_global_mesh(build_mesh({"dp": dist.get_world_size()}))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model.fit(batch, epochs=1, verbose=0, audit_comms=True)
    finally:
        set_global_mesh(None)
    return model.comms_audit, [str(w.message) for w in caught]


def audit_engine_rank(np_params, engine_kw):
    """A tiny f32 engine on a live group of the world (serving_mp /
    serving_cp in `engine_kw`), warmed with the communication audit on:
    (metrics()['comms_audit'] with the decode chunk's TPU803 findings at
    a 256-byte threshold under "tight", audit_memory(), audit_roofline())."""
    import torch

    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(LlamaConfig.tiny(),
                                   _port_params(np_params), device="cpu",
                                   dtype=torch.float32, **engine_kw)
    eng.warm([16], audit_comms=True)
    fleet = dict(eng.metrics()["comms_audit"])
    tight = eng.audit_comms(programs=("decode",),
                            rule_config={"TPU803.min_bytes": 256})
    fleet["tight"] = [d["rule"] for d in
                      tight["programs"]["decode"]["diagnostics"]]
    return fleet, eng.audit_memory(), eng.audit_roofline()


def sharded_train_rank(np_params, x, y, steps, lr, shape, strategy=None,
                       shard=False, cfg_kw=None, adam=False,
                       batch_spec=None):
    """`make_train_step` on tiny() f32 over `build_mesh(shape)` (after
    `shard_llama` when `shard`; `adam`: an Adam optimizer, else the fused
    AdamW) over the global batch (x, y): (losses, the gathered params
    after the first step and after the last, each param's spec, each
    state's spec, and with the fused AdamW the first step's gradients as
    `adamw_update` gets them, gathered, and the clip's global norm)."""
    import torch

    from paddle_tpu_torch.models import (LlamaPretrainingCriterion,
                                         gather_params, shard_llama)
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import (build_mesh, make_train_step,
                                           trainer)
    from paddle_tpu_torch.parallel.placement import dist_attr
    from paddle_tpu_torch.parallel.sharding import gather_tensor

    tm = _tiny_train_model(np_params, cfg_kw)
    mesh = build_mesh(shape)
    if shard:
        shard_llama(tm, mesh)
    crit = LlamaPretrainingCriterion(tm.config)
    opt = Adam(learning_rate=lr, parameters=tm.parameters()) if adam \
        else None
    step, p, s = make_train_step(tm, lambda lg, lb: crit(lg, lb), mesh,
                                 lr=lr, strategy=strategy, device="cpu",
                                 optimizer=opt, batch_spec=batch_spec)
    specs = {k: tuple(dist_attr(v).spec) if dist_attr(v) else None
             for k, v in p.items()}
    sspecs = dict(step.layout.sspec) if step.layout else None
    seen = {}
    real = trainer.adamw_update

    def spy(params, grads, state, lr, **kw):
        # the first step's gradients (the state blocks) and global norm
        if not seen:
            reduce_sq = kw.get("reduce_sq")

            def record(names, sqs):
                out = reduce_sq(names, sqs) if reduce_sq else sqs
                seen["norm"] = float(torch.sqrt(sum(out)))
                return out
            seen["grads"] = {
                n: gather_tensor(_with(g.clone(), step.layout.attr(n))
                                 if step.layout else g).numpy()
                for n, g in grads.items()}
            kw = dict(kw, reduce_sq=record)
        return real(params, grads, state, lr, **kw)

    trainer.adamw_update = spy
    try:
        losses, first = [], None
        for i in range(steps):
            loss, p, s = step(p, s, x, y)
            losses.append(float(loss))
            if i == 0:
                first = {k: v.numpy().copy()
                         for k, v in gather_params(p).items()}
    finally:
        trainer.adamw_update = real
    last = {k: v.numpy().copy() for k, v in gather_params(p).items()}
    return (losses, first, last, specs, sspecs, seen.get("grads"),
            seen.get("norm"))


def shard_specs_rank(np_params, shape, cfg_kw=None):
    """`shard_llama` of tiny() over `build_mesh(shape)`: each param's spec
    and its block's shape."""
    from paddle_tpu_torch.models import shard_llama
    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel.placement import dist_attr

    tm = shard_llama(_tiny_train_model(np_params, cfg_kw), build_mesh(shape))
    return {k: (tuple(dist_attr(v).spec), tuple(v.shape))
            for k, v in tm.named_parameters()}


def eager_sharded_rank(ws, xs, level, lr, path=None):
    """`group_sharded_parallel(level=)` over {"sharding": world} of JAX's
    MLP Linear(16, 32) - ReLU - Linear(32, 16) (weights `ws`, [in, out]),
    AdamW, each rank its rows of each global batch, the loss the mean of
    the squared outputs, then `save_group_sharded_model` to `path`:
    (first weight gathered, its spec, the first weight's state specs, the
    loss of each step, and (the gathered weights the first forward made,
    how many of them were still alive between it and its backward))."""
    import gc
    import weakref

    import torch

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (build_mesh,
                                           group_sharded_parallel,
                                           save_group_sharded_model,
                                           set_global_mesh)
    from paddle_tpu_torch.parallel.placement import dist_attr
    from paddle_tpu_torch.parallel.sharding import gather_tensor
    import torch.distributed as dist

    def lin(w, b):
        m = torch.nn.Linear(*w.shape)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w).T)
            m.bias.copy_(torch.from_numpy(b))
        return m

    n, r = dist.get_world_size(), _rank()
    set_global_mesh(build_mesh({"sharding": n}))
    try:
        m = torch.nn.Sequential(lin(ws[0], ws[1]), torch.nn.ReLU(),
                                lin(ws[2], ws[3]))
        o = AdamW(learning_rate=lr, parameters=m.parameters())
        m, o = group_sharded_parallel(m, o, level=level)
        # the values the layers compute with, where a hook gathered them
        made = []

        def seen(mod, inputs):
            made.extend(weakref.ref(v) for v in mod._parameters.values()
                        if not isinstance(v, torch.nn.Parameter))
        hooks = [m[i].register_forward_pre_hook(seen) for i in (0, 2)]
        losses, alive = [], None
        for x in xs:
            rows = x.shape[0] // n
            loss = (m(torch.from_numpy(x[r * rows:(r + 1) * rows]))
                    ** 2).mean()
            if alive is None:
                gc.collect()
                alive = sum(ref() is not None for ref in made)
                for h in hooks:
                    h.remove()
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(float(loss.detach()))
        if path is not None:
            save_group_sharded_model(m, path, o)
        w0 = m[0].weight
        st = o._accumulators[id(w0)]
        return (gather_tensor(w0).numpy().T.copy(),
                tuple(dist_attr(w0).spec) if dist_attr(w0) else None,
                {k: tuple(dist_attr(v).spec) if dist_attr(v) else None
                 for k, v in st.items()}, losses, (len(made), alive))
    finally:
        set_global_mesh(None)


def strategy_states_rank(ws, x, y):
    """JAX's test_sharding_strategy_shards_states on {"dp": 1, "sharding":
    world}: an MLP (weights `ws`) with Adam through
    make_train_step(strategy=stage 1, batch_spec=(("dp",),)): (the names
    of the parameters whose state is Shard(0) over sharding, the loss)."""
    import torch

    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import build_mesh, make_train_step
    import torch.distributed as dist

    def lin(w, b):
        m = torch.nn.Linear(*w.shape)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w).T)
            m.bias.copy_(torch.from_numpy(b))
        return m

    m = torch.nn.Sequential(lin(ws[0], ws[1]), torch.nn.ReLU(),
                            lin(ws[2], ws[3]))
    mesh = build_mesh({"dp": 1, "sharding": dist.get_world_size()})
    o = Adam(learning_rate=0.01, parameters=m.parameters())
    step, p, s = make_train_step(
        m, lambda out, yb: torch.nn.functional.cross_entropy(out, yb),
        mesh, optimizer=o, device="cpu",
        strategy={"sharding": {"enable": True, "stage": 1,
                               "axis": "sharding"}},
        batch_spec=(("dp",),))
    sharded = sorted(k for k, sp in step.layout.sspec.items()
                     if sp and sp[0] == "sharding")
    loss, p, s = step(p, s, torch.from_numpy(x), torch.from_numpy(y))
    return sharded, float(loss)


def audit_step_rank(np_params, shape, strategy=None, shard=False):
    """The communication audit of tiny()'s loss and gradients (traced on
    fakes: nothing exchanged) as `make_train_step` lays the model out
    over `build_mesh(shape)`: (per_axis, per_kind, the events' (kind,
    axes, shape, wire bytes))."""
    import torch

    from paddle_tpu_torch.analysis import comms
    from paddle_tpu_torch.models import (LlamaPretrainingCriterion,
                                         shard_llama)
    from paddle_tpu_torch.parallel import build_mesh, make_train_step

    tm = _tiny_train_model(np_params)
    mesh = build_mesh(shape)
    if shard:
        shard_llama(tm, mesh)
    crit = LlamaPretrainingCriterion(tm.config)
    step, p, s = make_train_step(tm, lambda lg, lb: crit(lg, lb), mesh,
                                 strategy=strategy, device="cpu")
    plan = tm._shard_plan
    rows = 4 // max(1, mesh.shape.get("sharding", 1))
    plan.row_axes = ("sharding",) if mesh.shape.get("sharding", 1) > 1 \
        else ()
    x = torch.zeros(rows, 16, dtype=torch.long)

    def grads(params, x, y):
        loss = crit(torch.func.functional_call(tm, params, (x,)), y)
        return torch.autograd.grad(loss, list(params.values()))

    rep = comms.audit_comms(grads, dict(p), x, x, grad=True)
    return (rep.per_axis(), rep.per_kind(),
            [(e.kind, e.axes, e.shape, e.wire_bytes)
             for e in rep.collectives])


def save_sharded_rank(np_params, path, shape):
    """tiny() f32 `shard_llama`'d over `build_mesh(shape)`, its blocks
    saved with `save_state_dict`: the gathered params."""
    from paddle_tpu_torch.models import gather_params, shard_llama
    from paddle_tpu_torch.parallel import build_mesh, save_state_dict

    tm = shard_llama(_tiny_train_model(np_params), build_mesh(shape))
    params = dict(tm.named_parameters())
    save_state_dict(params, path)
    return {k: v.numpy() for k, v in gather_params(params).items()}


def load_dp_rank(shapes, path):
    """`load_state_dict` into full f32 tensors on a dp mesh of the world."""
    import torch

    from paddle_tpu_torch.parallel import build_mesh, load_state_dict
    import torch.distributed as dist

    build_mesh({"dp": dist.get_world_size()})
    target = {k: torch.zeros(s) for k, s in shapes.items()}
    load_state_dict(target, path)
    return {k: v.numpy() for k, v in target.items()}


def shard_tensor_rank(x, a, b):
    """JAX's TestShardTensor on {"dp": 2, "mp": 2}: what `shard_tensor`,
    `reshard`, `unshard_dtensor`, `shard_layer` and a sharded matmul give
    on this rank."""
    import torch

    from paddle_tpu_torch.parallel import (Partial, ProcessMesh, Replicate,
                                           Shard, build_mesh,
                                           get_placements, reshard,
                                           shard_layer, shard_tensor,
                                           unshard_dtensor)
    from paddle_tpu_torch.parallel.api import global_shape

    mesh = build_mesh({"dp": 2, "mp": 2})
    out = {}
    d = shard_tensor(torch.from_numpy(x), mesh, [Shard(0)])
    out["shape"] = (global_shape(d), tuple(d.shape))
    out["placements"] = [repr(p) for p in get_placements(d)]
    out["unshard"] = unshard_dtensor(d).numpy()
    y = reshard(d, mesh, [Replicate(), Shard(1)])
    out["reshard_placements"] = [repr(p) for p in get_placements(y)]
    out["reshard"] = unshard_dtensor(y).numpy()
    # a partial sum, reduced (P -> R) and reduce-scattered (P -> S)
    pt = shard_tensor(torch.from_numpy(x), mesh, [Partial()])
    out["partial_local_zero"] = bool((pt == 0).all())
    out["p_to_r"] = unshard_dtensor(reshard(pt, mesh, [Replicate()])).numpy()
    out["p_to_s"] = unshard_dtensor(reshard(pt, mesh, [Shard(1)])).numpy()
    layer = torch.nn.Linear(8, 8)
    shard_layer(layer, ProcessMesh(mesh))
    out["layer"] = all(getattr(p, "_dist", None) is not None
                       for p in layer.parameters())
    ta = shard_tensor(torch.from_numpy(a), mesh, [Shard(0)])
    tb = shard_tensor(torch.from_numpy(b), mesh, [Replicate(), Shard(1)])
    prod = ta @ tb
    prod._dist = type(ta._dist)(mesh, ("dp", "mp"), (a.shape[0],
                                                     b.shape[1]))
    out["matmul"] = unshard_dtensor(prod).numpy()
    # reshard is differentiable: S -> R's backward takes the slice
    leaf = shard_tensor(torch.from_numpy(x), mesh, [Shard(0)])
    leaf.requires_grad_(True)
    reshard(leaf, mesh, [Replicate()]).sum().backward()
    out["grad_shape"] = tuple(leaf.grad.shape)
    return out


def tp_layers_rank(case, x, extra=None):
    """JAX's TestTPLayers on {"mp": world}: the layer's gathered weights,
    its output (and for "mlp_grad" the gathered gradients)."""
    import torch

    from paddle_tpu_torch.parallel import (build_mesh, mpu,
                                           set_global_mesh)
    from paddle_tpu_torch.parallel.sharding import gather_tensor
    import torch.distributed as dist

    set_global_mesh(build_mesh({"mp": dist.get_world_size()}))
    torch.manual_seed(3)
    try:
        t = torch.from_numpy(x)
        if case == "column":
            layer = mpu.ColumnParallelLinear(8, 16, gather_output=True,
                                             device="cpu")
            return (gather_tensor(layer.weight).numpy(),
                    gather_tensor(layer.bias).numpy(),
                    layer(t).detach().numpy())
        if case == "row":
            layer = mpu.RowParallelLinear(16, 8, input_is_parallel=False,
                                          device="cpu")
            return (gather_tensor(layer.weight).numpy(),
                    gather_tensor(layer.bias).numpy(),
                    layer(t).detach().numpy())
        if case == "vocab":
            layer = mpu.VocabParallelEmbedding(16, 8, device="cpu")
            return (gather_tensor(layer.weight).numpy(), None,
                    layer(t).detach().numpy())
        if case == "ce":
            ce = mpu.ParallelCrossEntropy()
            n = x.shape[-1] // dist.get_world_size()
            r = dist.get_rank()
            local = t[:, r * n:(r + 1) * n].clone().requires_grad_(True)
            loss = ce(local, torch.from_numpy(extra))
            loss.sum().backward()
            return None, local.grad.numpy(), loss.detach().numpy()
        col = mpu.ColumnParallelLinear(8, 16, gather_output=False,
                                       device="cpu")
        row = mpu.RowParallelLinear(16, 8, input_is_parallel=True,
                                    device="cpu")
        out = row(torch.relu(col(t)))
        (out * out).sum().backward()
        return ([gather_tensor(p).numpy() for p in (col.weight, col.bias,
                                                     row.weight, row.bias)],
                [gather_tensor(p.grad if getattr(p, "_dist", None) is None
                               else _with(p.grad, p._dist)).numpy()
                 for p in (col.weight, row.weight)],
                out.detach().numpy())
    finally:
        set_global_mesh(None)


def _with(t, attr):
    t._dist = attr
    return t


def eval_rank(np_params, x, shape):
    """`make_eval_step` of tiny() f32 `shard_llama`'d over
    `build_mesh(shape)`: the logits of the global batch."""
    from paddle_tpu_torch.models import shard_llama
    from paddle_tpu_torch.parallel import build_mesh, make_eval_step

    mesh = build_mesh(shape)
    tm = shard_llama(_tiny_train_model(np_params), mesh)
    fwd = make_eval_step(tm, mesh, device="cpu")
    return fwd(None, x).numpy()


def spmd_apply_rank(x, w):
    """JAX's TestApplication / TestApplyBackwardConstraint on {"dp": 2,
    "mp": 2}: the specs `with_spmd_constraint`, `shard_parameters` and
    `apply_backward_constraint` lay blocks out with, and the constrained
    product gathered back."""
    import torch

    from paddle_tpu_torch.parallel import (Replicate, Shard, build_mesh,
                                           shard_parameters, shard_tensor,
                                           unshard_dtensor,
                                           with_spmd_constraint)
    from paddle_tpu_torch.parallel.spmd_rules import \
        apply_backward_constraint

    mesh = build_mesh({"dp": 2, "mp": 2})
    xd = shard_tensor(torch.from_numpy(x), mesh, [Shard(0)])
    wd = shard_tensor(torch.from_numpy(w), mesh, [Replicate(), Shard(1)])
    full = torch.from_numpy(x) @ torch.from_numpy(w)
    out = with_spmd_constraint("matmul", full, xd, wd, mesh=mesh)
    got = {"matmul_spec": tuple(out._dist.spec),
           "matmul": unshard_dtensor(out).numpy()}
    model = torch.nn.Sequential(torch.nn.Linear(16, 64), torch.nn.SiLU(),
                                torch.nn.Linear(64, 16))
    shard_parameters(model, mesh, [("0.weight", ("mp", None)),
                                   ("2.weight", (None, "mp")),
                                   ("bias", (None,))])
    got["params"] = {k: tuple(p._dist.spec)
                     for k, p in model.named_parameters()}
    wt = torch.zeros(16, 32)
    xt = torch.zeros(8, 16)
    got["backward"] = apply_backward_constraint("matmul", ("dp", "mp"), xt,
                                                wt, mesh=mesh)
    got["backward_block"] = tuple(wt.shape)
    return got


def gather_linear_rank_cuda():
    """The stage-3 gather-linear on cuda:0 over two gloo ranks (every rank
    the same rows, so the weight's gradient is this rank's slice): its
    output, input gradient and block gradient against a dense ``x @ W``
    on the same card, as booleans of bitwise equality, and the bytes the
    forward left allocated beside those of a dense product over the
    gathered weight (which autograd keeps)."""
    import torch

    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel.sharding import gather_full, gather_linear
    import torch.distributed as dist

    torch.cuda.set_device(0)
    r, n = _rank(), dist.get_world_size()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 256, 512, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn(512, 1024, generator=g, device="cuda",
                    dtype=torch.bfloat16) * 0.05
    dy = torch.randn(4, 256, 1024, generator=g, device="cuda",
                     dtype=torch.bfloat16)
    ref = build_mesh({"sharding": n}).axis_ref("sharding")
    gathers = ((ref.key, n, 0, "slice"),)
    # cuBLAS takes its workspace from the caching allocator at first use
    warm = w.clone().requires_grad_(True)
    (x @ warm).backward(dy)
    del warm
    rows = 512 // n
    block = w[r * rows:(r + 1) * rows].clone().requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = gather_linear(xs, block, gathers)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    y.backward(dy)
    xd = x.clone().requires_grad_(True)
    wd = w.clone().requires_grad_(True)
    yd = xd @ wd
    yd.backward(dy)
    # a dense product over the gathered weight keeps the weight
    xg = x.clone().requires_grad_(True)
    bg = block.detach().clone().requires_grad_(True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    yg = xg @ gather_full(bg, gathers)
    torch.cuda.synchronize()
    held_dense = torch.cuda.memory_allocated() - before
    del yg
    return dict(
        out=bool(torch.equal(y, yd)), dx=bool(torch.equal(xs.grad, xd.grad)),
        dw=bool(torch.equal(block.grad, wd.grad[r * rows:(r + 1) * rows])),
        held=int(held), held_dense=int(held_dense),
        y_bytes=y.numel() * y.element_size(),
        w_bytes=w.numel() * w.element_size())


def tp_layers_rank_cuda():
    """The mpu layers built with no device argument (so on the card) over
    {"mp": world} gloo ranks sharing cuda:0: whether every parameter and
    the output are on the card, and the vocab embedding -> column -> relu
    -> row MLP's output and gathered weight gradients as max abs
    differences from dense f32 products of the gathered weights on the
    same card, beside the largest magnitude of each."""
    import torch

    from paddle_tpu_torch.parallel import build_mesh, mpu, set_global_mesh
    from paddle_tpu_torch.parallel.sharding import gather_tensor
    import torch.distributed as dist

    torch.cuda.set_device(0)
    set_global_mesh(build_mesh({"mp": dist.get_world_size()}))
    torch.manual_seed(3)
    try:
        emb = mpu.VocabParallelEmbedding(256, 64)
        col = mpu.ColumnParallelLinear(64, 128, gather_output=False)
        row = mpu.RowParallelLinear(128, 64, input_is_parallel=True)
        layers = (emb.weight, col.weight, col.bias, row.weight, row.bias)
        g = torch.Generator(device="cuda").manual_seed(0)
        ids = torch.randint(0, 256, (4, 16), generator=g, device="cuda")
        out = row(torch.relu(col(emb(ids))))
        (out * out).sum().backward()
        dense = [gather_tensor(p).clone().requires_grad_(True)
                 for p in layers]
        ref = torch.relu(dense[0][ids] @ dense[1] + dense[2]) @ dense[3] \
            + dense[4]
        (ref * ref).sum().backward()
        diffs = {"out": (float((out - ref).detach().abs().max()),
                         float(ref.detach().abs().max()))}
        for name, p, d in (("emb", emb.weight, dense[0]),
                           ("col", col.weight, dense[1]),
                           ("row", row.weight, dense[3])):
            got = gather_tensor(_with(p.grad, p._dist))
            diffs[name] = (float((got - d.grad).abs().max()),
                           float(d.grad.abs().max()))
        on_card = all(p.is_cuda for p in layers) and out.is_cuda
        return on_card, diffs
    finally:
        set_global_mesh(None)


# ---------------------------------------------------------------------------
# pipeline-parallel training
# ---------------------------------------------------------------------------

def _gather_stage(g, mesh, mp_dim):
    """A stage gradient block whole: over mp on its split dim, then over
    pp on the stage dim (JAX's global array)."""
    from paddle_tpu_torch.parallel.collectives import all_gather

    if mp_dim is not None and mesh.shape.get("mp", 1) > 1:
        g = all_gather(g.contiguous(), mesh.axis_ref("mp"), mp_dim)
    if mesh.shape.get("pp", 1) > 1:
        g = all_gather(g.contiguous(), mesh.axis_ref("pp"), 0)
    return g


def pp_train_rank(np_params, x, y, steps, lr, shape, kw=None, cfg_kw=None):
    """`make_llama_pp_train_step(**kw)` on tiny() f32 over
    `build_mesh(shape)`, `steps` steps on the global batch (x, y):
    (losses, whether the outer params were bitwise equal over pp after
    every step, the whole params after the last step (JAX's layout, keys
    "outer/<name>" and "stages/<sub>"), the step's schedule and coop
    flag, None, the first step's gradients as `adamw_update` gets them,
    whole, and the clip's global norm) -- `check_grads` reads the last
    two at 5 and 6."""
    import torch

    from paddle_tpu_torch.models import llama_pipe
    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel.collectives import all_gather

    tm = _tiny_train_model(np_params, cfg_kw)
    mesh = build_mesh(shape)
    step, p, s = llama_pipe.make_llama_pp_train_step(
        tm, mesh, lr=lr, device="cpu", **(kw or {}))
    seen = {}
    real = llama_pipe.adamw_update

    def spy(params, grads, state, lr, **k):
        if not seen:
            reduce_sq = k.get("reduce_sq")

            def record(names, sqs):
                out = reduce_sq(names, sqs) if reduce_sq else sqs
                seen["norm"] = float(torch.sqrt(sum(out)))
                return out
            seen["grads"] = {
                n: (_gather_stage(g, mesh, step.stage_mp_dims[
                    n.split("/", 1)[1]]) if n.startswith("stages/")
                    else g).detach().numpy().copy()
                for n, g in sorted(grads.items())}
            k = dict(k, reduce_sq=record)
        return real(params, grads, state, lr, **k)

    llama_pipe.adamw_update = spy
    losses, equal = [], True
    try:
        for _ in range(steps):
            loss, p, s = step(p, s, x, y)
            losses.append(float(loss))
            if mesh.shape.get("pp", 1) > 1:
                for k in sorted(p["outer"]):
                    got = all_gather(p["outer"][k][None].contiguous(),
                                     mesh.axis_ref("pp"), 0)
                    equal &= all(torch.equal(got[0], got[i])
                                 for i in range(got.shape[0]))
    finally:
        llama_pipe.adamw_update = real
    last = {f"outer/{k}": v.numpy().copy() for k, v in p["outer"].items()}
    last.update({f"stages/{k}": _gather_stage(
        v, mesh, step.stage_mp_dims[k]).numpy().copy()
        for k, v in p["stages"].items()})
    return (losses, equal, last, (step.schedule, step.n_micro,
                                  step.coop_head), None, seen.get("grads"),
            seen.get("norm"))


def toy_pipeline_rank(kind, stacked, head, x, lb, n_micro, mesh_shape):
    """One of `pipeline_spmd`'s schedules on JAX's toy stages (tanh(h @
    w), the head mean((h @ u - y)^2)) over `build_mesh(mesh_shape)`:
    "forward" (the output and the stacked weights' gradient of
    sum(out^2)), "vpp" (the same through pipeline_vpp_forward over
    chunked [S, V, d, d] weights), else 1f1b / zb / eager's (loss,
    d_stage block, d_head, d_x)."""
    import torch

    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel import pipeline_spmd as ps

    mesh = build_mesh(mesh_shape)
    x, lb = torch.from_numpy(x), torch.from_numpy(lb)
    if kind in ("forward", "vpp"):
        w = torch.from_numpy(stacked).requires_grad_(True)
        if kind == "vpp":
            out = ps.pipeline_vpp_forward(lambda W, h: torch.tanh(h @ W), w,
                                          x, mesh=mesh, n_micro=n_micro)
            out.sum().backward()
        else:
            out = ps.pipeline_forward(
                lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                {"w": w, "b": torch.from_numpy(head)}, x, mesh=mesh,
                n_micro=n_micro)
            (out ** 2).sum().backward()
        return out.detach().numpy(), w.grad.numpy()
    fn = {"1f1b": ps.pipeline_1f1b, "zb": ps.pipeline_zb1f1b,
          "eager": ps.pipeline_eager_1f1b}[kind]
    loss, d_st, d_hp, d_x = fn(
        lambda p, h: torch.tanh(h @ p["w"]),
        lambda hp, h, y: torch.mean((h @ hp["u"] - y) ** 2),
        {"w": torch.from_numpy(stacked)}, {"u": torch.from_numpy(head)},
        x, lb, mesh=mesh, n_micro=n_micro)
    return (float(loss), d_st["w"].numpy(), d_hp["u"].numpy(),
            d_x.numpy())


def pipeline_apply_rank(w, x, n_micro):
    """`parallel.pipeline_apply` of tanh(a @ w) stages on {"pp": world}:
    the output and the gradient of sum(y^2) with respect to w."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import build_mesh, pipeline_apply

    mesh = build_mesh({"pp": dist.get_world_size()})
    wt = torch.from_numpy(w).requires_grad_(True)
    y = pipeline_apply(lambda p, a: torch.tanh(a @ p["w"]), {"w": wt},
                       torch.from_numpy(x), n_microbatches=n_micro,
                       mesh=mesh)
    (y ** 2).sum().backward()
    return y.detach().numpy(), wt.grad.numpy()


def pp_audit_rank(np_params, x, y, shape, kw):
    """The communication audit of a pp rank's whole train step (traced on
    fake tensors after building the step on the live group): its
    collectives (kind, axis, shape, dtype, wire bytes), one real step's
    delivered bytes by operator, and TPU401's dead-collective findings."""
    from paddle_tpu_torch.analysis import comms
    from paddle_tpu_torch.analysis.graph import trace_graph
    from paddle_tpu_torch.analysis.rules import CollectiveRule
    from paddle_tpu_torch.models import llama_pipe
    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel import collectives as coll

    tm = _tiny_train_model(np_params)
    mesh = build_mesh(shape)
    step, p, s = llama_pipe.make_llama_pp_train_step(
        tm, mesh, lr=1e-3, device="cpu", **kw)
    graph = trace_graph(step, p, s, x, y, grad=True)
    rep = comms.audit_graph(graph)
    dead = [d.message for d in CollectiveRule().check(graph)
            if "never used" in d.message]
    coll.reset_wire_counts()
    step(p, s, x, y)
    wire = {k: dict(v) for k, v in coll.WIRE_COUNTS.items()}
    return ([(e.kind, e.axes, e.shape, e.dtype, e.wire_bytes)
             for e in rep.collectives], rep.per_axis(), wire, dead)


def pp_errors_rank():
    """The ValueErrors `pipeline_spmd` raises on {"pp": 4}: a batch not
    divisible by n_micro, a stage dim other than pp, VPP's n_micro not a
    multiple of pp (their messages, in that order)."""
    import torch

    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel import pipeline_spmd as ps

    mesh = build_mesh({"pp": 4})
    out = []
    for call in (
            lambda: ps.pipeline_forward(lambda p, h: h,
                                        {"w": torch.zeros(4, 2)},
                                        torch.zeros(6, 2), mesh=mesh,
                                        n_micro=4),
            lambda: ps.pipeline_forward(lambda p, h: h,
                                        {"w": torch.zeros(3, 2)},
                                        torch.zeros(8, 2), mesh=mesh,
                                        n_micro=4),
            lambda: ps.pipeline_vpp_forward(lambda W, h: h,
                                            torch.zeros(4, 2, 8, 8),
                                            torch.zeros(6, 8), mesh=mesh,
                                            n_micro=6)):
        try:
            call()
        except ValueError as e:
            out.append(str(e))
    return out


def coop_errors_rank():
    """`make_llama_pp_train_step(coop_head=True)`'s refusals on {"pp": 2}:
    FThenB, then a vocab (127) pp does not divide."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         init_train_params, llama_pipe)
    from paddle_tpu_torch.parallel import build_mesh

    mesh = build_mesh({"pp": 2})
    out = []
    for vocab, kw in ((128, {"schedule": "FThenB"}), (127, {})):
        cfg = LlamaConfig.tiny(vocab_size=vocab)
        tm = LlamaForCausalLM(cfg).load_params(
            init_train_params(cfg, 0, "cpu"), trainable=True)
        try:
            llama_pipe.make_llama_pp_train_step(tm, mesh, coop_head=True,
                                                device="cpu", **kw)
        except ValueError as e:
            out.append(str(e))
    return out


def ppermute_rank(device="cuda"):
    """The ``ppermute`` hop on two gloo ranks (sharing cuda:0, or on the
    CPU): each rank sends its tensor (bf16 and f32, from a generator
    seeded by its rank) to the other and receives the other's; then the
    JAX-style ring ppermute under autograd, whose backward sends the
    cotangent back. Returns whether the received tensors and the input's
    gradient are bitwise the other rank's, whether they live on the
    device, and the wire counts."""
    import torch

    from paddle_tpu_torch.parallel import collectives as coll

    if device == "cuda":
        torch.cuda.set_device(0)
    r = _rank()
    mine, theirs = {}, {}
    for who in (0, 1):
        g = torch.Generator(device=device).manual_seed(100 + who)
        d = {dt: torch.randn(2, 1024, 512, generator=g, device=device
                             ).to(dt) for dt in (torch.bfloat16,
                                                 torch.float32)}
        d["w"] = torch.randn(2, 1024, 512, generator=g, device=device)
        (mine if who == r else theirs).update(d)
    coll.reset_wire_counts()
    ok, on_dev = True, True
    for dt in (torch.bfloat16, torch.float32):
        got = coll.send_recv(mine[dt], None, dst=1 - r, src=1 - r)
        ok &= bool(torch.equal(got, theirs[dt]))
        on_dev &= got.device.type == device
    x = mine[torch.float32].clone().requires_grad_(True)
    y = coll.ppermute(x, None, perm=[(0, 1), (1, 0)])
    (y * mine["w"]).sum().backward()
    grad_ok = bool(torch.equal(x.grad, theirs["w"]))
    return dict(ok=ok, grad=grad_ok,
                on_card=on_dev and x.grad.device.type == device,
                fwd=bool(torch.equal(y.detach(), theirs[torch.float32])),
                wire=dict(coll.WIRE_COUNTS["ppermute"]))


def pp_step_rank_cuda(layers, seq, steps):
    """Llama-1B's widths (kv heads 4, bf16) at `layers` layers, random
    weights from seed 0, a global batch 4 x `seq`: on {"pp": world}
    make_llama_pp_train_step at 1F1B (the cooperative head), n_micro 4;
    at world 1 the serial step. Returns (losses, launches a step, the
    backend)."""
    import torch
    import torch.distributed as dist
    import numpy as np

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         init_train_params, llama_pipe)
    from paddle_tpu_torch.parallel import build_mesh

    torch.cuda.set_device(0)
    cfg = LlamaConfig.llama_1b(dtype="bfloat16", num_key_value_heads=4,
                               num_hidden_layers=layers,
                               max_position_embeddings=seq)
    model = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, seed=0, device="cuda"), trainable=True)
    world = dist.get_world_size()
    mesh = build_mesh({"pp": world}) if world > 1 else None
    step, p, s = llama_pipe.make_llama_pp_train_step(
        model, mesh, n_micro=4, lr=1e-4, grad_clip_norm=None)
    rng = np.random.default_rng(0)
    x, y = (torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, seq)),
                            device="cuda") for _ in range(2))
    losses, launches = [], []
    for _ in range(steps):
        _build.reset_launch_counts()
        loss, p, s = step(p, s, x, y)
        torch.cuda.synchronize()
        launches.append({k: v for k, v in _build.launch_counts().items()
                         if v})
        losses.append(float(loss))
    return losses, launches, dist.get_backend()


def mesh_pp_rank(shape):
    """This rank's pp stage, its pp group's ranks and its (previous,
    next) stage's rank on `build_mesh(shape)`."""
    from paddle_tpu_torch.parallel import build_mesh

    mesh = build_mesh(shape)
    return (mesh.axis_rank("pp"), mesh.axis_ranks("pp"),
            mesh.pp_neighbours())


# ---------------------------------------------------------------------------
# sequence and context parallel (tests/test_torch_sep.py)
# ---------------------------------------------------------------------------

def _seq_block(mesh, t):
    """This rank's block of a global [b, s, ...] tensor over `mesh`: its
    rows over dp and its slice of the sequence over sep."""
    from paddle_tpu_torch.parallel.trainer import take_rows

    rows = ("dp",) if mesh.shape.get("dp", 1) > 1 else ()
    (blk,), _ = take_rows(mesh, (t,), rows, ("sep",))
    return blk


def ring_rank(q, k, v, shape, causal, grad=False):
    """`ring_attention` of this rank's block (rows over dp, sequence
    chunk over sep) of the global q / k / v over `build_mesh(shape)`:
    its output block and, with `grad`, the gradients of sum(out * cos(q))
    w.r.t. its q, k and v blocks (summed over the ranks' losses)."""
    import torch

    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    mesh = build_mesh(shape)
    blocks = [_seq_block(mesh, torch.as_tensor(a)).clone() for a in (q, k, v)]
    for b in blocks:
        b.requires_grad_(grad)
    out = ring_attention(*blocks, mesh=mesh, causal=causal)
    if not grad:
        return out.detach().numpy()
    (out * torch.cos(blocks[0])).sum().backward()
    return out.detach().numpy(), [b.grad.numpy() for b in blocks]


def ulysses_rank(x, shape):
    """`seq_to_head` of this rank's block of the global [b, s, H, d] `x`
    under JAX's seq spec (rows over dp, sequence over sep, heads over mp)
    and `head_to_seq` back: (the head-split block, whether the round trip
    is the identity bitwise)."""
    import torch

    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel.ulysses import head_to_seq, seq_to_head

    mesh = build_mesh(shape)
    blk = _seq_block(mesh, torch.as_tensor(x))
    mp = mesh.shape.get("mp", 1)
    h = blk.shape[2] // mp
    a = mesh.axis_rank("mp") if mp > 1 else 0
    blk = blk[:, :, a * h:(a + 1) * h].contiguous()
    y = seq_to_head(blk, mesh)
    return y.numpy(), bool(torch.equal(head_to_seq(y, mesh), blk))


def all_to_all_rank(xs, ws, split_dim, concat_dim):
    """The tiled `all_to_all(x, split_dim=, concat_dim=)` of this rank's
    `xs[rank]` under autograd, and the gradient of sum(y * ws[rank]):
    (y, x.grad)."""
    import torch

    from paddle_tpu_torch.parallel.collectives import all_to_all

    r = _rank()
    x = torch.as_tensor(xs[r]).clone().requires_grad_(True)
    y = all_to_all(x, None, split_dim=split_dim, concat_dim=concat_dim)
    (y * torch.as_tensor(ws[r])).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def seq_parallel_rank(x, q, w):
    """JAX's TestSequenceParallel on {"sep": 2, "rest": 4} (the global
    mesh), each rank holding its blocks: split_seq of `x` (and the
    gradient of sum(split * w[sep rank]) through it), gather_seq back,
    sep_attention_context of q's sequence slice, and the re-annotation
    route of ulysses_alltoall on the 3-D slice; the sep getters of
    Paddle's HybridCommunicateGroup."""
    import torch

    from paddle_tpu_torch.parallel import (HybridCommunicateGroup,
                                           build_mesh, gather_seq,
                                           sep_attention_context,
                                           set_global_mesh, split_seq,
                                           ulysses_alltoall)

    mesh = build_mesh({"sep": 2, "rest": 4})
    hcg = HybridCommunicateGroup(mesh)
    set_global_mesh(mesh)
    try:
        j = mesh.axis_rank("sep")
        xt = torch.as_tensor(x).clone().requires_grad_(True)
        s = split_seq(xt)
        (s * torch.as_tensor(w[j])).sum().backward()
        g = gather_seq(s.detach())
        qs = torch.as_tensor(q)[:, j * 4:(j + 1) * 4].contiguous()
        q2, k2, v2 = sep_attention_context(qs, qs, qs)
        moved = ulysses_alltoall(s.detach(), 2, 1)
    finally:
        set_global_mesh(None)
    return dict(sep=j, hcg=(hcg.get_sep_parallel_rank(),
                            hcg.get_sep_parallel_world_size(),
                            hcg.get_sep_parallel_group().key,
                            hcg.get_sep_parallel_group_src_rank(),
                            hcg.get_dp_sep_parallel_group().key),
                split=s.detach().numpy(), grad=xt.grad.numpy(),
                gathered=g.numpy(), q2=q2.numpy(),
                kv_same=bool(torch.equal(k2, q2) and torch.equal(v2, q2)),
                moved=moved.numpy())


def segment_parallel_rank(np_params, batches, shape, cfg_kw=None):
    """`SegmentParallel` over tiny() f32 on `build_mesh(shape)`, ranks
    past the first perturbed before the wrap, one forward and backward a
    (x, y) of `batches` without zeroing the gradients in between
    (gradient accumulation): (whether the wrap made the params equal to
    the first rank's, each pass's logits of the global batch, each
    pass's loss, the accumulated gradients)."""
    import torch

    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.parallel import (HybridCommunicateGroup,
                                           SegmentParallel, build_mesh)
    from paddle_tpu_torch.parallel.collectives import all_gather

    tm = _tiny_train_model(np_params, cfg_kw)
    mesh = build_mesh(shape)
    if _rank() > 0:
        with torch.no_grad():
            for p in tm.parameters():
                p.add_(0.01)
    sp = SegmentParallel(tm, HybridCommunicateGroup(mesh))
    crit = LlamaPretrainingCriterion(tm.config)
    logits, losses = [], []
    for x, y in batches:
        lg = sp(torch.as_tensor(x))
        loss = crit(lg, torch.as_tensor(y))
        loss.backward()
        logits.append(lg.detach().numpy())
        losses.append(float(loss))
    flat = torch.cat([p.detach().reshape(-1) for p in tm.parameters()])
    got = all_gather(flat[None], mesh.group_ref("sep"), 0)
    return (all(torch.equal(got[0], g) for g in got), logits, losses,
            {k: p.grad.numpy() for k, p in tm.named_parameters()})


def segment_parallel_plain_rank(w, b, x, y, lr):
    """`SegmentParallel` and `make_train_step` on {"sep": 2} of a
    Linear(w, b) that does not declare ``handles_seq_shard``, on [rows,
    seq, features] inputs: (whether each sep rank got the whole sequence
    in every forward, the output, the gradients after a backward, the
    losses of two steps)."""
    import torch

    from paddle_tpu_torch.parallel import (SegmentParallel, build_mesh,
                                           make_train_step)

    mesh = build_mesh({"sep": 2})
    lin = torch.nn.Linear(*w.shape)
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(w.T))
        lin.bias.copy_(torch.as_tensor(b))
    seen = []
    lin.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[1]))
    xs, ys = torch.as_tensor(x), torch.as_tensor(y)

    def mse(out, lb):           # each output against the next label
        return ((out[:, :-1] - lb[:, 1:]) ** 2).mean()

    out = SegmentParallel(lin)(xs)
    mse(out, ys).backward()
    grads = {k: p.grad.numpy().copy() for k, p in lin.named_parameters()}
    lin.zero_grad()
    step, p, s = make_train_step(lin, mse, mesh, lr=lr, device="cpu")
    losses = []
    for _ in range(2):
        loss, p, s = step(p, s, xs, ys)
        losses.append(float(loss))
    return (all(n == x.shape[1] for n in seen), out.detach().numpy(),
            grads, losses)
