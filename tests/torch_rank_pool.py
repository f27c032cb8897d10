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
