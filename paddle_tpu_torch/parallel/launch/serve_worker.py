"""Decode-fleet subprocess worker (counterpart of
paddle_tpu/parallel/launch/serve_worker.py).

The cross-process twin of `serving.fleet.FleetWorker`: one engine per
PROCESS, talking to the fleet through a `resilience.store.FileStore`
mailbox instead of an in-memory one, so workers can live in separate
processes. `Fleet.add_subprocess_worker` launches it; by hand::

    python -m paddle_tpu_torch.parallel.launch.serve_worker \\
        --store /tmp/fleet --job f1 --worker-id w0 --index 0

It serves on the CUDA card unless ``--device cpu`` is given (no card:
it raises), in bf16 on the card and f32 on the CPU. Its weights are
``init_serving_params(cfg, seed=--seed)``
for the ``LlamaConfig`` classmethod ``--model`` (``tiny`` by default)
with ``--config``'s JSON fields over it; ``--warm-buckets`` captures the
engine's programs for those prompt buckets before the worker publishes
its readiness.

Store protocol (all keys under ``fleet/<job>/``; values are JSON):

- ``info/<wid>``      worker -> fleet: engine capacities, written once at
  startup (the readiness marker);
- ``hb/<wid>``        TTL heartbeat lease, renewed every
  ``--heartbeat-s`` (death = an expired lease);
- ``req/<wid>/<seq>`` fleet -> worker: one dispatch
  ``{rid, prompt, max_new, priority, deadline_s}`` (deleted on accept);
- ``prog/<wid>/<rid>`` worker -> fleet: the delivered-token stream, for
  in-flight recovery;
- ``done/<wid>/<rid>`` worker -> fleet: the terminal result
  ``{tokens, failed, error}``;
- ``requeue/<wid>/<rid>`` worker -> fleet: unstarted requests handed back
  by a drain;
- ``ctl/<wid>``       fleet -> worker: ``stop`` | ``drain``.

Chaos: the loop runs the in-process worker's ``fleet.worker`` seam;
`ChaosKilled` becomes a real ``SIGKILL`` (no cleanup, no flush).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.parallel.launch.serve_worker")
    ap.add_argument("--store", required=True,
                    help="FileStore root shared with the fleet")
    ap.add_argument("--job", default="fleet")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--index", type=int, default=None)
    ap.add_argument("--lease-epoch", type=int, default=0)
    ap.add_argument("--heartbeat-s", type=float, default=0.25)
    ap.add_argument("--poll-s", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="tiny",
                    help="LlamaConfig classmethod name (tiny, llama3_8b)")
    ap.add_argument("--config", default=None,
                    help="JSON object of LlamaConfig fields over --model")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-bucket", type=int, default=8)
    ap.add_argument("--max-prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--steps-per-sync", type=int, default=2)
    ap.add_argument("--kv-pool-bytes", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (raises "
                         "without one)")
    ap.add_argument("--warm-buckets", type=int, nargs="+", default=None,
                    help="capture the programs for these prompt buckets "
                         "before publishing readiness")
    ap.add_argument("--prefix-widths", type=int, nargs="*", default=None,
                    help="prefix widths warm() captures (default: the "
                         "whole ladder)")
    return ap.parse_args(argv)


def build_engine(args):
    """The worker's engine: its config, weights from `--seed` and
    geometry, as the command line gives them."""
    import torch

    from ...device import resolve_device
    from ...models import LlamaConfig, init_serving_params
    from ...serving.engine import ContinuousBatchingEngine

    over = json.loads(args.config) if args.config else {}
    cfg = getattr(LlamaConfig, args.model)(**over)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = init_serving_params(cfg, seed=args.seed, device=device,
                                 dtype=dtype)
    return ContinuousBatchingEngine(
        cfg, params, slots=args.slots, prompt_bucket=args.prompt_bucket,
        max_prompt_len=args.max_prompt_len, max_new_tokens=args.max_new,
        block_size=args.block_size, steps_per_sync=args.steps_per_sync,
        kv_pool_bytes=args.kv_pool_bytes, dtype=dtype, device=device)


def main(argv=None) -> int:
    args = _parse(argv)
    from ...resilience import chaos
    from ...resilience.store import FileStore

    rank = chaos.gang_rank()
    wid = args.worker_id or f"w{rank if rank is not None else 0}"
    index = args.index if args.index is not None \
        else (rank if rank is not None else 0)
    store = FileStore(args.store)
    pre = f"fleet/{args.job}"
    hb_key = f"{pre}/hb/{wid}"
    ttl = 4.0 * args.heartbeat_s

    def heartbeat(step):
        store.put(hb_key, json.dumps(
            {"t": time.time(), "epoch": args.lease_epoch,
             "step": step}), ttl=ttl)

    heartbeat(0)  # the lease exists before the (slow) engine build

    eng = build_engine(args)
    if args.warm_buckets:
        eng.warm(buckets=args.warm_buckets,
                 prefix_widths=args.prefix_widths)
    heartbeat(0)
    store.put(f"{pre}/info/{wid}", json.dumps(
        {"slots": eng.slots, "max_prompt_len": eng.max_prompt_len,
         "max_new": eng.max_new, "pid": os.getpid()}))

    active = {}      # engine req_id -> rid
    last_len = {}    # rid -> tokens reported
    fin_seen = 0
    state = {"steps": 0}
    draining = False

    # the lease is renewed from a sidecar thread: a blocking engine.step()
    # must not expire it, but a SIGKILLed process takes the thread with it
    # and the lease lapses
    hb_stop = threading.Event()

    def _hb_loop():
        while not hb_stop.is_set():
            heartbeat(state["steps"])
            hb_stop.wait(args.heartbeat_s)

    threading.Thread(target=_hb_loop, daemon=True).start()

    def accept():
        for key in sorted(store.prefix(f"{pre}/req/{wid}/")):
            raw = store.get(key)
            store.delete(key)
            if raw is None:
                continue
            d = json.loads(raw)
            if draining:
                store.put(f"{pre}/requeue/{wid}/{d['rid']}",
                          json.dumps({"rid": d["rid"]}))
                continue
            try:
                ereq = eng.add_request(
                    d["prompt"], d["max_new"],
                    priority=d.get("priority") or "normal",
                    deadline_s=d.get("deadline_s"))
            except Exception as e:
                store.put(f"{pre}/done/{wid}/{d['rid']}", json.dumps(
                    {"tokens": [], "failed": True, "error": str(e)}))
                continue
            active[ereq.req_id] = d["rid"]
            last_len[d["rid"]] = 0

    def report():
        nonlocal fin_seen
        while fin_seen < len(eng.finished):
            ereq = eng.finished[fin_seen]
            fin_seen += 1
            rid = active.pop(ereq.req_id, None)
            if rid is None:
                continue
            last_len.pop(rid, None)
            store.delete(f"{pre}/prog/{wid}/{rid}")
            store.put(f"{pre}/done/{wid}/{rid}", json.dumps(
                {"tokens": list(ereq.tokens), "failed": ereq.failed,
                 "error": ereq.error}))
        for row in (eng.export_progress() if active else ()):
            rid = active.get(row["req_id"])
            if rid is not None and \
                    len(row["tokens"]) > last_len.get(rid, 0):
                last_len[rid] = len(row["tokens"])
                store.put(f"{pre}/prog/{wid}/{rid}",
                          json.dumps({"tokens": row["tokens"]}))

    try:
        while True:
            chaos.maybe_kill_worker(index, state["steps"])
            ctl = store.get(f"{pre}/ctl/{wid}")
            if ctl == "stop":
                break
            if ctl == "drain":
                draining = True
                eng.pause_admission(True)
            accept()
            if eng.n_active > 0 or eng._prefilling is not None \
                    or eng._handoff or (eng.waiting and not draining):
                eng.step()
                report()
            elif draining:
                for ereq in eng.take_waiting():
                    rid = active.pop(ereq.req_id, None)
                    if rid is not None:
                        store.put(f"{pre}/requeue/{wid}/{rid}",
                                  json.dumps({"rid": rid}))
                break
            else:
                time.sleep(args.poll_s)
            state["steps"] += 1
    except chaos.ChaosKilled:
        # a hard worker death: no flush, no lease deregistration, which is
        # what a preempted host looks like from the outside
        import signal

        os.kill(os.getpid(), signal.SIGKILL)
    hb_stop.set()
    store.delete(hb_key)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
