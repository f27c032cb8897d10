"""Continuous-batching serving engine over the paged KV cache
(counterpart of paddle_tpu/serving/engine.py, on one device).

New prompts enter while other sequences decode, finished rows retire
mid-stream and their pages recycle into the pool. The device sees fixed
shapes between host scheduling points:

- per-layer K/V pools [max_pages, Hkv, block_size, D], updated IN PLACE
  by the prefill page scatter and the decode-step token write. With
  ``kv_cache_dtype="int8"`` each pool is an (int8 pool, f32 scale
  [max_pages, Hkv]) pair: the scatter quantizes whole pages by their
  absmax, the decode commit grows a page's scale and rescales its stored
  rows, and the int8 attention kernels apply the scales in f32;
- a block table [slots, table_width] int32 mapping each slot's logical
  blocks to pool pages (free slots point at a reserved scratch page,
  table columns past a request's pages repeat its last page);
- per-slot lengths, tokens, budgets and live flags.

Two schedulers, as in the JAX engine:

- **split** (``unified_step=False``, the default): FIFO admission,
  batched. The head run of waiting requests sharing a (suffix bucket,
  cached-vs-cold) key prefills in one call, padded to a power-of-two batch
  with rows aimed at the scratch page. Cold rows take the flash-attention
  prefill; rows whose prompt head hit the prefix cache map the cached
  pages into their tables and prefill only the suffix, through the
  prefix-prefill kernel. Decode then runs `steps_per_sync` tokens for
  every slot per chunk, the host reads the chunk back, retires EOS /
  finished rows and admits from the queue.
- **unified** (``unified_step=True``): the FIFO head streams its prompt
  through `token_budget`-token windows (chunked prefill, over the ragged
  paged attention kernel), each window dispatched together with every
  live slot's decode chunk; pure-decode steps run the plain decode chunk.

With ``prefix_cache`` (default on) every freshly computed full prompt
block is registered in the manager's refcounted prefix cache once its
request's prefill commits, and later requests map it in.

A per-row budget (prompt + max_new) freezes rows on the device, so a
chunk never writes past a request's reserved pages. Options of the JAX
engine that this port does not serve yet raise NotImplementedError naming
their ROADMAP.md item.

**Observability** (``tracer=`` / ``metrics=``, default the globals that
FLAGS_trace / FLAGS_metrics arm): the JAX engine's spans, instants,
counters and histograms at its sites, with its names and fields (the
request lifecycle req.enqueue -> req.admit -> prefill.dispatch ->
req.handoff -> decode.dispatch / spec.verify -> decode.sync_wait ->
req.retire, prefix.evict, and the watchdog's retirements and requeues;
TTFT, TPOT, queue wait, chunk and sync-wait histograms). Every site sits
on the host, between dispatches, outside every program body: a span
recorded inside a graph capture raises TraceUnderJitError.

**Watchdog** (``run(watchdog_timeout=, requeue_hung=)``): each scheduling
step runs on a worker thread under a wall-clock deadline. A step that
blows it is abandoned: the live loop bumps the step epoch under the
commit lock and retires (or requeues once) ONE victim slot, and the
abandoned thread, which checks its owner token under the same lock
before every host-set write, replay and commit, unwinds without touching
the card again.

The engine's programs (the decode chunk; on the unified path the
prefill window; on the split path one prefill program per (bucket,
batch, prefix width) key) are the port's counterpart of the JAX
engine's jitted programs: on the card each is captured once as a CUDA
graph, in `warm()` or at its first use, and replayed for every dispatch,
over static input tensors fed from pinned host buffers.
`warm(buckets=, prefix_widths=)` captures the prefill programs the
given prompt buckets need, as the JAX engine's warm() compiles them.
With ``double_buffer`` the next chunk is dispatched before the previous
one is read back: its tokens and lengths ride the previous chunk's device
outputs wherever the host changed no slot, and the readback skips rows
whose slot changed owner in between (the JAX engine's pipeline).

**Speculative decoding** (``speculative="ngram" | "draft"``, default from
FLAGS_speculative; serving/speculative.py): each decode step drafts up to
`spec_k` tokens per live slot (host-side n-gram lookup, or a draft model
on its own pools) and the "verify" program scores every slot's pending
token and drafts as ONE ragged window of spec_k + 1 rows, scattering the
window's K/V column by column into the slot's pages. Greedy acceptance
commits the longest matching draft prefix plus the target's corrected
token, so the output is what sequential greedy decode gives. The verify
program (and a draft model's program) is a CUDA graph on the card; on the
unified path, steps with a prompt prefilling stay mixed steps.

**Prefill/decode disaggregation** (``disaggregated=True``): admission
(the prefill worker) prefills up to `slots` requests ahead into a handoff
queue without waiting for a free decode slot, and the decode worker maps
handed-off requests into slots as they free. The pools are shared, so
the handoff is block-table bookkeeping; a request whose first token is
EOS, or whose max_new is 1, retires at the handoff.

**Fleet hooks** (serving/fleet.py): `pause_admission` stops admission
from `waiting` while in-flight work finishes, `take_waiting` hands the
unadmitted queue back, `export_progress` snapshots every owned request's
tokens, and `drain` combines them for an elastic scale-in.
"""
from __future__ import annotations

import gc
import threading
import time
from collections import namedtuple
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
# the drafters and tests take _Program and _HostSets from here
from ..framework.cuda_graph import GraphSite, _HostSets, _Program
from ..framework.flags import flag
from ..kernels import _build
from ..kernels.flash_attention import KERNEL_HEAD_DIMS
from ..models.llama import (STACKED_LAYER_NAMES, STACKED_PREFIX,
                            PagedKVManager, _make_chunk_prefill,
                            _make_decode_step_megakernel, _make_head_logits,
                            _make_prefill, _make_prefill_with_prefix,
                            _make_verify_window, _sample_next,
                            hash_prefix_blocks,
                            make_paged_decode_step, make_paged_kv_helpers,
                            make_paged_kv_q8_helpers, plan_megakernel_rung,
                            resolve_decode_megakernel,
                            resolve_kv_cache_dtype, resolve_serving_cp,
                            resolve_serving_mp, resolve_unified_step,
                            stack_decode_layer_params, warn_refusals)
from ..observability import metrics as obs_metrics
from ..observability import trace as obs_trace
from ..resilience import chaos
from .speculative import (AdaptiveSpecPolicy, NGramDrafter,
                          resolve_spec_adaptive, resolve_spec_k,
                          resolve_speculative)

_ROADMAP = "ROADMAP.md, 'Engine options the port refuses'"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({_ROADMAP})")


@dataclass
class ServeRequest:
    """One generation request tracked through the engine."""
    req_id: int
    prompt: list
    max_new: int
    arrival_time: float = 0.0
    # filled by the engine
    tokens: list = field(default_factory=list)
    prefill_time: Optional[float] = None   # when the first token was ready
    finish_time: Optional[float] = None
    failed: bool = False                   # retired by the watchdog
    error: Optional[str] = None
    requeued: bool = False                 # already got its one retry
    #                                        (run(requeue_hung=True))
    # host-side scheduling state (None until admitted)
    slot: Optional[int] = None
    pages: Optional[list] = None
    bucket: Optional[int] = None           # suffix bucket it prefilled at
    n_prefix: int = 0                      # cached prefix blocks mapped in
    cached_tokens: int = 0                 # prompt tokens served from cache
    # chained block hashes, computed once at add_request (planning runs
    # for every waiting request on every scheduling step)
    block_hashes: Optional[list] = None
    # SLO metadata: set by the caller, carried through handoff untouched,
    # surfaced in the req.enqueue / req.retire instants; the engine never
    # reorders or sheds on them
    priority: str = "normal"
    deadline_s: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.finish_time is not None


class _AbandonedStep(RuntimeError):
    """Raised inside a watchdog-abandoned step thread at its next owner
    check: the live loop moved on, this thread must not commit."""


class _Slot:
    __slots__ = ("req", "length", "emitted", "done")

    def __init__(self):
        self.req = None        # ServeRequest or None (free)
        self.length = 0        # tokens cached (prompt + emitted - 1 pending)
        self.emitted = 0       # new tokens produced so far
        self.done = False      # EOS seen inside a chunk


# admission plan for one waiting request: suffix bucket, cached prefix
# blocks, cached pages currently refcount-0 (they leave the available pool
# on acquire), private pages to reserve, true suffix length
_Plan = namedtuple("_Plan", "sb_suf n_cached n_lru need suffix_len")

class ContinuousBatchingEngine:
    """Continuous batching over `PagedKVManager`, on one device.

    Usage::

        eng = ContinuousBatchingEngine(cfg, params, slots=8,
                                       max_new_tokens=64)
        eng.add_request([1, 5, 9, ...])
        eng.run()
        for req in eng.finished: print(req.tokens)

    `params` is the decode-params dict (``init_serving_params`` or
    ``params_from_jax``) on `device` (None = cuda); `dtype` is the type
    of the activations and of bf16 pools. Weight-only quantized params
    (``decode_params`` / ``init_quant_serving_params``: projections and
    lm_head as (int8 or packed int4, f32 scale) pairs) serve on every
    path unchanged, since every path reaches a projection only through
    ``_mm``. A request is admitted
    when a slot is free and the pool holds its full reservation (cached
    prefix blocks map in for free; the private pages cover the bucketed
    suffix plus max_new), so no preemption is ever needed.

    `unified_step` (default from FLAGS_unified_step; 'auto' is the split
    path) serves prefill through `token_budget`-token windows (a multiple
    of `block_size`; default the prompt bucket) next to the decode chunk.

    `kv_cache_dtype` ('bf16' | 'int8'; default from FLAGS_kv_cache_dtype)
    is the pools' element type: int8 pools halve the bytes every decode
    and prefix step streams, so a byte budget holds about twice the
    pages. `kv_pool_bytes` sizes the pool by a byte budget instead of
    `max_pages` (not both): at the same budget an int8 pool holds ~2x
    `n_cacheable_pages`.

    `decode_megakernel` ('off' | 'attn' | 'full' | 'scan'; default from
    FLAGS_decode_megakernel) fuses the decode step into one kernel per
    layer (attn: the attention block; full: the whole layer) or one per
    step (scan: every layer, over stacked weights and one layer-major
    pool). The rung is planned at build (`megakernel_rung`); a rung the
    operands refuse (packed int4 weights, mixed weights, the card's
    limits) steps down the ladder with one warning each.

    `double_buffer` makes `run()` dispatch chunk N+1 before chunk N is
    read back (`run(double_buffer=)` overrides it per call); admissions
    and retirements then take effect one chunk later.

    `speculative` ('off' | 'ngram' | 'draft'; default from
    FLAGS_speculative), `spec_k` (FLAGS_spec_k), `drafter` (a `Drafter`;
    'ngram' defaults to `NGramDrafter()`, 'draft' needs a
    `DraftModelDrafter`) and `spec_adaptive` (FLAGS_spec_adaptive) turn
    each decode step into a verify window of spec_k + 1 rows a slot
    (greedy only). `disaggregated` lets admission prefill up to `slots`
    requests ahead into a handoff queue that decode slots take from.

    On the card `warm()` captures the decode chunk (and the unified
    step's prefill window, the verify window and a draft model's program)
    as CUDA graphs that every dispatch replays (`compile_stats()`); the
    first dispatch warms an engine that was not warmed. `warm(buckets=,
    prefix_widths=)` also captures the split path's prefill programs for
    those prompt buckets (default: max_prompt_len); a key traffic reaches
    unwarmed is captured at its first admission.

    `config` (a `TunedConfig` from the static autotuner,
    `analysis/tuner.py`, its dict, or the path of a persisted
    ``.paddle_tpu_tune.json`` or its directory) defaults every build-time
    knob the tuner swept; explicit kwargs win knob by knob (None counts
    as unset), and the flags fill what neither set. None follows
    FLAGS_tuned_config (a stale or unreadable flag artifact warns and is
    ignored; a stale explicit one raises); False forces it off.
    The artifact's `quantized_collectives` knob is read and left unused:
    on one device there is no collective to quantize, so the engine takes
    no such kwarg and reports False (ROADMAP.md section 1 item 5).
    `metrics()['tuned_config']` reports the artifact and
    ``['warm_compile_stats']`` the kernel build cache's traffic over the
    last `warm()`.

    `tracer` / `metrics` (observability): an `observability.Tracer`
    records the request lifecycle as Perfetto-exportable spans and
    instants, a `MetricsRegistry` the TTFT / TPOT / queue-wait /
    chunk-time / sync-wait histograms, counters and the structured
    event log. None (default) takes the globals FLAGS_trace /
    FLAGS_metrics arm (off unless the operator opted in: every site is
    then one `is None` check); False forces OFF even when the globals
    are armed; an object is used as given."""

    # class-level default: the watchdog's no-live-slot path reads this on
    # engines built without the unified-path state
    _prefilling = None

    # a readback that waits longer than this counts as a blocked sync (the
    # host sat idle on the device): the stat double buffering shrinks
    stall_threshold_s = 1e-3

    def __init__(self, cfg, dec_params, *, slots: int = 8,
                 prompt_bucket: int = 64, max_prompt_len: int = 512,
                 max_new_tokens: int = 64,
                 block_size: Optional[int] = None,
                 max_pages: Optional[int] = None,
                 kv_pool_bytes: Optional[int] = None,
                 steps_per_sync: int = 8,
                 prefill_batch: int = 4,
                 eos_token_id: Optional[int] = None, do_sample: bool = False,
                 top_k: int = 0, temperature: float = 1.0,
                 top_p: float = 1.0, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 prefix_cache: bool = True, double_buffer: bool = False,
                 kv_cache_dtype: Optional[str] = None,
                 decode_megakernel=None,
                 serving_mp: Optional[int] = None,
                 serving_cp: Optional[int] = None,
                 disaggregated: bool = False, unified_step=None,
                 token_budget: Optional[int] = None,
                 speculative: Optional[str] = None,
                 spec_k: Optional[int] = None, drafter=None,
                 spec_adaptive: Optional[bool] = None,
                 config=None, tracer=None, metrics=None, device=None):
        # a tuned-config artifact fills the knobs the caller left unset,
        # before any flag resolves them
        self.tuned_config = self._resolve_tuned_config(config, cfg)
        if self.tuned_config is not None:
            merged = self.tuned_config.apply(dict(
                kv_cache_dtype=kv_cache_dtype,
                decode_megakernel=decode_megakernel,
                unified_step=unified_step, serving_mp=serving_mp,
                serving_cp=serving_cp,
                token_budget=token_budget, block_size=block_size,
                speculative=speculative, spec_k=spec_k))
            kv_cache_dtype = merged["kv_cache_dtype"]
            decode_megakernel = merged["decode_megakernel"]
            unified_step = merged["unified_step"]
            serving_mp = merged["serving_mp"]
            serving_cp = merged.get("serving_cp", serving_cp)
            token_budget = merged["token_budget"]
            block_size = merged["block_size"]
            speculative = merged.get("speculative", speculative)
            spec_k = merged.get("spec_k", spec_k)
            spec_adaptive = merged.get("spec_adaptive", spec_adaptive)
        self.warm_compile_stats = None   # set by warm()
        self.kv_dtype = resolve_kv_cache_dtype(kv_cache_dtype)
        self.use_megakernel = resolve_decode_megakernel(decode_megakernel)
        if resolve_serving_mp(serving_mp) > 1:
            raise _unported("serving_mp > 1")
        if resolve_serving_cp(serving_cp) > 1:
            raise _unported("serving_cp > 1")
        # speculative decoding, resolved at build time like every serving
        # flag: "off" builds exactly the engine without it (no verify
        # program, no drafter)
        self.speculative = resolve_speculative(speculative)
        self.spec_k = resolve_spec_k(spec_k or None) \
            if self.speculative != "off" else 0
        # the depth the drafter is asked for may adapt; the verify window
        # keeps spec_k + 1 rows
        self.spec_adaptive = resolve_spec_adaptive(spec_adaptive) \
            if self.spec_k else False
        self._spec_policy = AdaptiveSpecPolicy(self.spec_k) \
            if self.spec_adaptive else None
        self._drafter = None
        if self.speculative != "off":
            if do_sample:
                raise ValueError(
                    "speculative decoding is greedy-only: acceptance "
                    "compares drafts against the target's argmax; build "
                    "with do_sample=False or speculative='off'")
            if self.speculative == "draft":
                if drafter is None:
                    raise ValueError(
                        "speculative='draft' needs a DraftModelDrafter "
                        "(its config + params) via drafter=")
                self._drafter = drafter
            else:
                self._drafter = drafter if drafter is not None \
                    else NGramDrafter()
        # prefill/decode disaggregation: prefilled requests not yet in a
        # slot wait here with their pages committed
        self.disaggregated = bool(disaggregated)
        self._handoff: list[ServeRequest] = []
        self.prefill_handoffs = 0   # requests that crossed the handoff
        if block_size is None:
            block_size = 64
        block_size = int(block_size)
        if prompt_bucket % block_size:
            raise ValueError(
                f"prompt_bucket {prompt_bucket} must be a whole number of "
                f"KV pages (multiple of block_size {block_size}) so "
                f"prefill scatters whole pages")
        self.unified = resolve_unified_step(unified_step)
        if token_budget is None:
            token_budget = prompt_bucket
        if token_budget % block_size or token_budget < block_size:
            raise ValueError(
                f"token_budget {token_budget} must be a whole number "
                f"of KV pages (multiple of block_size {block_size}) so "
                "chunk boundaries stay page-aligned and the window "
                "scatter writes whole pages")
        self.token_budget = int(token_budget)
        self.device = resolve_device(device)
        emb = dec_params["llama.embed_tokens.weight"]
        if emb.device != self.device:
            raise ValueError(f"params live on {emb.device}, the engine "
                             f"runs on {self.device}")
        if self.device.type == "cuda" \
                and cfg.head_dim not in KERNEL_HEAD_DIMS:
            raise ValueError(f"head_dim {cfg.head_dim} has no flash "
                             f"kernel (needs one of {KERNEL_HEAD_DIMS})")
        self.cfg = cfg
        self.p = dec_params
        self.slots = slots
        self.prompt_bucket = prompt_bucket
        self.max_prompt_len = -(-max_prompt_len // prompt_bucket) \
            * prompt_bucket
        self.max_new = max_new_tokens
        self.block_size = block_size
        self.steps = steps_per_sync
        self.prefill_batch = max(1, prefill_batch)
        self.eos = eos_token_id
        self.do_sample = do_sample
        self.top_k = int(top_k)
        self.temperature = temperature
        self.top_p = top_p
        self.prefix_cache = bool(prefix_cache)
        self.double_buffer = bool(double_buffer)
        # pool capacity: every slot full-length at the engine budget, plus
        # the scratch page. Per-request reservations are never larger:
        # _plan trims a cached prefix until cached blocks + the bucketed
        # suffix's pages fit the cold-path worst case, so the cold-path
        # width bounds every block table and admission cannot livelock
        cap = self._capacity_pages(self.max_prompt_len)
        self.table_width = cap
        # widest cached prefix any request can map (>= 1 suffix token
        # always prefills, so the last block is never part of a prefix)
        self._prefix_width = max(1, (self.max_prompt_len - 1) // block_size)
        nkv, dh = cfg.num_key_value_heads, cfg.head_dim
        if kv_pool_bytes is not None:
            if max_pages is not None:
                raise ValueError(
                    "pass max_pages OR kv_pool_bytes, not both")
            max_pages = PagedKVManager.pages_for_bytes(
                kv_pool_bytes, block_size, n_layers=cfg.num_hidden_layers,
                num_kv_heads=nkv, head_dim=dh, kv_cache_dtype=self.kv_dtype)
            if max_pages < cap + 2:
                raise ValueError(
                    f"kv_pool_bytes {kv_pool_bytes} holds only {max_pages} "
                    f"pages at kv_cache_dtype={self.kv_dtype}; need at "
                    f"least {cap + 2} (one full request + scratch + one "
                    "cacheable page)")
        if max_pages is None:
            max_pages = slots * cap + 1
        self.mgr = PagedKVManager(max_pages, block_size)
        self.mgr.set_pool_geometry(n_layers=cfg.num_hidden_layers,
                                   num_kv_heads=nkv, head_dim=dh,
                                   kv_cache_dtype=self.kv_dtype)
        self.scratch_page = self.mgr.alloc_pages(1)[0]  # free rows' sink
        # the megakernel rung, planned once here over spec views of this
        # engine's decode operands (one warning per refused rung). The
        # scan rung lays the engine out anew: the per-layer weights stack
        # along a leading layer axis and the n_layers pools become ONE
        # layer-major pool (layer i owns rows [i*max_pages,
        # (i+1)*max_pages)); tables keep per-layer page ids and every
        # reader and writer adds the layer's offset
        self.megakernel_rung = self._plan_megakernel(max_pages)
        scan = self.megakernel_rung == "scan"
        n_layers = cfg.num_hidden_layers
        self._page_stride = max_pages if scan else 0
        shape = (max_pages * n_layers if scan else max_pages, nkv,
                 block_size, dh)

        def pool():
            if self.kv_dtype == "int8":
                return (torch.zeros(shape, dtype=torch.int8,
                                    device=self.device),
                        torch.zeros(shape[:2], dtype=torch.float32,
                                    device=self.device))
            return torch.zeros(shape, dtype=dtype, device=self.device)

        n_pools = 1 if scan else n_layers
        self.kcs = [pool() for _ in range(n_pools)]
        self.vcs = [pool() for _ in range(n_pools)]
        if scan:
            self.p = stack_decode_layer_params(self.p, n_layers)
        self._slots = [_Slot() for _ in range(slots)]
        self._tables = np.full((slots, cap), self.scratch_page, np.int32)
        self._tokens = np.zeros((slots,), np.int64)
        self._budgets = np.zeros((slots,), np.int32)  # prompt + max_new
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.waiting: list[ServeRequest] = []
        self.finished: list[ServeRequest] = []
        self._next_id = 0
        # the split path's prefill programs, one per JAX program key
        # (_prefill_key), and their host sets; captured by warm() or at
        # their first admission. Three graph sites, each one pool and one
        # capture stream kept for the engine's life: the step programs'
        # (decode, unified, verify), the prefill programs' and a draft
        # model's. A prefill replay's first tokens are read back before
        # any other prefill replays, so the prefills share their pool; a
        # decode chunk's outputs stay live across prefill replays (the
        # double-buffer chain feeds them to the next chunk), so a prefill
        # graph must never take a block of their pool
        self._prefill_cache = {}
        self._prefill_host = {}
        # each prefill program's body over (params, pools, *inputs), for
        # the static audits (`_program_inventory`)
        self._prefill_bodies = {}
        self._kv_pool_budget = kv_pool_bytes
        self._memory_audit = None
        self._roofline_audit = None
        self._site = GraphSite(self.device)
        self._prefill_site = GraphSite(self.device)
        self._draft_site = GraphSite(self.device)
        # the eager bodies: the decode chunk, the unified step's prefill
        # window (unified path only) and the verify window (speculation
        # only)
        self._decode = self._build_decode_chunk()
        self._unified = self._build_unified_step() if self.unified else None
        self._verify = self._build_verify_chunk() if self.spec_k else None
        self._programs = self._make_programs()
        self._host = None        # {program: _HostSets}, made by warm()
        # the request streaming prefill windows through the unified step:
        # {"req": ServeRequest, "done": prompt tokens committed}
        self._prefilling = None
        # double-buffer pipeline state: the uncommitted in-flight chunk,
        # the device-side tokens / lengths chunk N+1 chains from, and the
        # per-slot mask saying "host state changed since the last dispatch:
        # take the host's value"
        self._inflight = None
        self._chain_tok = None
        self._chain_lens = None
        self._override = np.ones((slots,), bool)
        self._override_dev = torch.ones((slots,), dtype=torch.bool,
                                        device=self.device)
        self.device_steps = 0    # decode-chunk, mixed-step and verify
        #                          dispatches
        self.prefill_calls = 0   # batched-admission device calls
        self.spec_steps = 0      # speculative verify dispatches
        self.spec_drafted = 0    # draft tokens offered for verification
        self.spec_accepted = 0   # draft tokens the target agreed with
        self.prefill_chunks = 0  # unified prefill windows dispatched
        self.chunk_tokens = 0    # prompt tokens prefilled via windows
        self.prompt_tokens = 0       # prompt tokens admitted in total
        self.prefix_hit_tokens = 0   # prompt tokens served from the cache
        self.prefix_inserts = 0      # blocks registered into the cache
        self.decode_s = 0.0      # host wall time of decode chunks and
        #                          verify steps, synced
        self.prefill_s = 0.0     # host wall time of prefill calls, synced
        self.sync_wait_s = 0.0   # host time blocked on decode readbacks
        self.blocked_syncs = 0   # readbacks that waited > stall threshold
        self.hung_retired = 0    # slots retired by the watchdog
        self.hung_requeued = 0   # hung slots requeued (requeue_hung=)
        self._requeue_hung = False  # armed per run()
        self._admission_paused = False  # pause_admission() / drain()
        self._watchdog = None    # armed by run(watchdog_timeout=...)
        self._step_epoch = 0     # bumped on timeout; abandoned steps abort
        # observability: None defers to the flag-armed globals, False
        # forces OFF regardless of flags, an instance wins outright. The
        # sites hold the attribute and branch once per event
        self._tracer = obs_trace.get_tracer() if tracer is None \
            else (tracer or None)
        self._metrics = obs_metrics.get_metrics() if metrics is None \
            else (metrics or None)
        self._evictions_seen = 0  # mgr.prefix_evictions already reported
        # makes owner check + host-set writes + replay + host-state commit
        # atomic against the timeout path's epoch bump + victim retire: a
        # step finishing right at the deadline either fully commits before
        # the bump or fully aborts after it, and an abandoned thread never
        # writes a host set or replays a program the live loop now owns
        self._commit_lock = threading.Lock()
        # last: a draft model sizes its pools off the manager, the block
        # size and spec_k
        if self._drafter is not None:
            self._drafter.attach(self)

    # ---- host-side accounting -------------------------------------------

    def _capacity_pages(self, sb: int) -> int:
        return self._capacity_pages_for(sb, self.max_new)

    def _capacity_pages_for(self, sb: int, max_new: int) -> int:
        return -(-(sb + max_new) // self.block_size)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self._slots if s.req is not None)

    @property
    def n_cacheable_pages(self) -> int:
        """Pages that can hold K/V content (all but the scratch page), the
        ceiling on resident prefix-cache blocks. Capacity math counts
        pages whatever the pool dtype; what int8 changes is how many
        pages a byte budget buys (~2x at the same `kv_pool_bytes`)."""
        return self.mgr.max_pages - 1

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self._handoff) \
            or self._prefilling is not None or self.n_active > 0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix
        cache instead of being prefilled."""
        if not self.prompt_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prompt_tokens

    def _plan_megakernel(self, max_pages: int) -> str:
        """The served megakernel rung, planned once per engine build over
        meta-tensor views of this engine's decode operands: the slots-wide
        batch, the full-width tables, the would-be stacked weights and the
        layer-major pool. Warns once per refused rung (the JAX engine's
        `_plan_megakernel`); the CUDA kernel's limits apply when the
        engine runs on the card."""
        if self.use_megakernel == "off":
            return "off"
        cfg = self.cfg
        L = cfg.num_hidden_layers

        def spec(w, lead=()):
            if isinstance(w, tuple):
                return tuple(spec(a, lead) for a in w)
            return torch.empty(lead + tuple(w.shape), dtype=w.dtype,
                               device="meta")

        pview = {name: spec(w) for name, w in self.p.items()}
        for name in STACKED_LAYER_NAMES:
            pview[STACKED_PREFIX + name] = spec(
                self.p[f"llama.layers.0.{name}"], (L,))
        rows = max_pages * L
        shape = (rows, cfg.num_key_value_heads, self.block_size,
                 cfg.head_dim)
        emb = self.p["llama.embed_tokens.weight"]
        if self.kv_dtype == "int8":
            pool = (torch.empty(shape, dtype=torch.int8, device="meta"),
                    torch.empty(shape[:2], dtype=torch.float32,
                                device="meta"))
        else:
            pool = torch.empty(shape, dtype=emb.dtype, device="meta")
        tables = torch.empty((self.slots, self.table_width),
                             dtype=torch.int32, device="meta")
        rung, refusals = plan_megakernel_rung(
            self.use_megakernel, cfg, self.slots, pview, [pool], [pool],
            tables, on_card=self.device.type == "cuda")
        warn_refusals(refusals, rung, "on this engine build")
        return rung

    def compile_stats(self) -> dict:
        """Captures of each engine program (a CUDA graph each on the card):
        the steady-state guard, as the JAX engine's jit cache sizes. After
        warm(), serving traffic must not grow any entry."""
        stats = {name: prog.captures
                 for name, prog in self._programs.items()}
        if self._drafter is not None:
            stats.update(self._drafter.compile_stats())
        for key, prog in self._prefill_cache.items():
            stats["prefill:" + ":".join(str(k) for k in key)] = \
                prog.captures
        return stats

    def metrics(self) -> dict:
        """Scheduling counters, prefix-cache effectiveness, sync-wait
        telemetry, pool occupancy, compile stats and each kernel's launch
        count (since the last ``kernels.reset_launch_counts()``). Pure host
        bookkeeping: safe to call mid-serve from another thread."""
        mgr = self.mgr
        # pages not reclaimable right now (live, pinned or the scratch page)
        in_use = mgr.max_pages - mgr.n_available
        return {
            "requests_finished": len(self.finished),
            "requests_waiting": len(self.waiting),
            "requests_active": self.n_active,
            "prefill_calls": self.prefill_calls,
            "device_steps": self.device_steps,
            "prefill_handoffs": self.prefill_handoffs,
            "unified_step": self.unified,
            "token_budget": self.token_budget,
            "prefill_chunks": self.prefill_chunks,
            "chunk_tokens": self.chunk_tokens,
            "hung_retired": self.hung_retired,
            "hung_requeued": self.hung_requeued,
            # acceptance_rate: the share of OFFERED draft tokens the
            # target's argmax agreed with (a window's corrected token is
            # not counted)
            "speculative": self.speculative,
            "spec_k": self.spec_k,
            "spec_adaptive": self.spec_adaptive,
            "spec_k_effective": (
                self._spec_policy.spec_k_effective
                if self._spec_policy is not None else self.spec_k),
            "spec_steps": self.spec_steps,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "acceptance_rate": (self.spec_accepted / self.spec_drafted
                                if self.spec_drafted else 0.0),
            "prefix_hit_rate": self.prefix_hit_rate,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": self.prompt_tokens,
            "prefix_inserts": self.prefix_inserts,
            "prefix_evictions": mgr.prefix_evictions,
            "n_available": mgr.n_available,
            "n_cached": mgr.n_cached,
            "pages_in_use": in_use,
            "pool_occupancy": in_use / max(mgr.max_pages, 1),
            "kv_cache_dtype": self.kv_dtype,
            "decode_megakernel": self.use_megakernel,
            "megakernel_rung": self.megakernel_rung,
            # one device until ROADMAP.md section 1 item 5 (kv-head and
            # page-axis sharding, int8 collectives)
            "serving_mp": 1,
            "serving_cp": 1,
            "quantized_collectives": False,
            "kv_pool_bytes": mgr.kv_pool_bytes(),
            "n_cacheable_pages": self.n_cacheable_pages,
            "decode_s": self.decode_s,
            "prefill_s": self.prefill_s,
            "sync_wait_s": self.sync_wait_s,
            "blocked_syncs": self.blocked_syncs,
            "compile_stats": self.compile_stats(),
            "kernel_launches": _build.launch_counts(),
            "memory_audit": self._memory_audit,
            "roofline_audit": self._roofline_audit,
            # the artifact this engine was built from (None: the flags'
            # defaults) and the kernel build cache's traffic over the last
            # warm(): a fresh process warming over a populated build
            # directory reports cache_misses == 0
            "tuned_config": (self.tuned_config.to_dict()
                             if self.tuned_config is not None else None),
            "warm_compile_stats": self.warm_compile_stats,
        }

    @staticmethod
    def _resolve_tuned_config(config, cfg):
        """`config=` -> a valid TunedConfig or None: a TunedConfig, its
        dict or a path; None follows FLAGS_tuned_config
        (PADDLE_TPU_TUNED_CONFIG), False forces it off. A stale explicit
        artifact raises; a stale or unreadable flag artifact warns and is
        ignored (a fleet-wide setting must not stop engines of another
        model)."""
        import warnings

        if config is False:
            return None
        from ..analysis.tuner import TunedConfig

        explicit = config is not None
        if config is None:
            path = str(flag("tuned_config") or "")
            if not path:
                return None
            try:
                tuned = TunedConfig.load(path)
            except Exception as e:
                warnings.warn(
                    f"FLAGS_tuned_config {path!r} unreadable ({e}); "
                    "building with the flags' defaults", stacklevel=3)
                return None
        elif isinstance(config, TunedConfig):
            tuned = config
        elif isinstance(config, dict):
            tuned = TunedConfig.from_dict(config)
        else:
            tuned = TunedConfig.load(str(config))
        stale = tuned.stale_reason(cfg=cfg)
        if stale is not None:
            if explicit:
                raise ValueError(
                    f"stale TunedConfig (config=): {stale}; re-run the "
                    "autotuner (python -m paddle_tpu_torch.analysis "
                    "--tune) for this model")
            warnings.warn(
                f"FLAGS_tuned_config artifact is stale ({stale}); "
                "building with the flags' defaults", stacklevel=3)
            return None
        return tuned

    def add_request(self, prompt, max_new: Optional[int] = None,
                    arrival_time: Optional[float] = None,
                    priority: Optional[str] = None,
                    deadline_s: Optional[float] = None) -> ServeRequest:
        """Validate + enqueue; every reject happens here, before the
        request owns a slot or pages. `priority` / `deadline_s` are
        metadata the req.enqueue / req.retire instants carry."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not 1 <= len(prompt) <= self.max_prompt_len:
            raise ValueError(f"prompt length {len(prompt)} outside "
                             f"[1, {self.max_prompt_len}]")
        if max_new is not None and int(max_new) != max_new:
            raise TypeError(f"max_new must be an int, got {max_new!r}")
        req = ServeRequest(self._next_id, prompt,
                           int(max_new) if max_new is not None
                           else self.max_new,
                           arrival_time if arrival_time is not None
                           else time.perf_counter())
        if req.max_new <= 0:
            raise ValueError(f"max_new must be >= 1, got {req.max_new}")
        if req.max_new > self.max_new:
            raise ValueError(f"max_new {req.max_new} > engine budget "
                             f"{self.max_new}")
        sb = -(-len(prompt) // self.prompt_bucket) * self.prompt_bucket
        need = self._capacity_pages_for(sb, req.max_new)
        if need > self.mgr.max_pages - 1:
            raise ValueError(
                f"request needs {need} pages (bucketed prompt {sb} + "
                f"max_new {req.max_new}) but the pool holds only "
                f"{self.mgr.max_pages - 1}")
        if self.prefix_cache:
            req.block_hashes = hash_prefix_blocks(prompt, self.block_size)
        if priority is not None:
            req.priority = str(priority)
        if deadline_s is not None:
            req.deadline_s = float(deadline_s)
        self._next_id += 1
        self.waiting.append(req)
        tr, mt = self._tracer, self._metrics
        if tr is not None:
            tr.instant("req.enqueue", req_id=req.req_id,
                       prompt_len=len(prompt), max_new=req.max_new,
                       priority=req.priority, deadline_s=req.deadline_s)
        if mt is not None:
            mt.counter("requests_enqueued").inc()
        return req

    # ---- fleet hooks: drain and progress export -------------------------

    def pause_admission(self, paused: bool = True) -> None:
        """Stop (or resume) pulling from `waiting`. In-flight slots, the
        streaming unified prefill and parked handoffs run to completion;
        only NEW admissions stop. The building block of an elastic drain:
        a worker being scaled in finishes what it owns while its queued
        requests move elsewhere."""
        self._admission_paused = bool(paused)

    def take_waiting(self) -> list:
        """Remove and return every request not yet admitted. They own no
        slot and no pages (admission is where reservations happen), so
        they re-enqueue on any engine as if freshly added."""
        taken, self.waiting = self.waiting, []
        return taken

    def export_progress(self) -> list:
        """A progress row for every request the engine still owns (state
        ``waiting`` / ``prefilling`` / ``handoff`` / ``active``): what a
        fleet streams so that a worker death keeps the tokens already
        delivered. Host bookkeeping only (safe from another thread); the
        lists are copies."""
        out = []

        def row(req, state):
            out.append({
                "req_id": req.req_id, "state": state,
                "prompt": list(req.prompt), "tokens": list(req.tokens),
                "max_new": req.max_new,
                "remaining": max(req.max_new - len(req.tokens), 0),
                "priority": req.priority, "deadline_s": req.deadline_s,
            })

        for req in self.waiting:
            row(req, "waiting")
        if self._prefilling is not None:
            row(self._prefilling["req"], "prefilling")
        for req in self._handoff:
            row(req, "handoff")
        for slot in self._slots:
            if slot.req is not None:
                row(slot.req, "active")
        return out

    def drain(self, max_iters: int = 100000) -> list:
        """Graceful drain: pause admission, run the in-flight work (live
        slots, the streaming prefill, parked handoffs) to completion and
        return the untouched `waiting` requests for re-admission
        elsewhere. Admission stays paused: `pause_admission(False)` serves
        again."""
        self.pause_admission(True)
        while (self.n_active > 0 or self._prefilling is not None
               or self._handoff) and max_iters:
            self.step()
            max_iters -= 1
        if self.n_active > 0 or self._prefilling is not None \
                or self._handoff:
            raise RuntimeError("engine did not drain within max_iters")
        return self.take_waiting()

    # ---- device programs ------------------------------------------------

    def _first_token(self, h, last, p, head_logits):
        """Sample each row's first token from h[row, last[row]]."""
        rows = torch.arange(h.shape[0], device=h.device)
        logits = head_logits(h[rows, last][:, None], p)[:, -1]
        return _sample_next(logits.to(torch.float32), self._gen,
                            self.do_sample, self.temperature, self.top_k,
                            self.top_p)

    def _build_prefill(self, sb: int, bsz: int):
        """Prefill `bsz` cold requests in one call: scatter each row's
        pages, pick each row's first token at its own true length."""
        cfg = self.cfg
        base = _make_prefill(cfg, bsz, sb)
        head_logits = _make_head_logits(cfg)
        scatter = self._page_scatter(bsz, sb // self.block_size)

        def run(p, kcs, vcs, ids, s0_vec, pages):
            h, kvs = base(p, ids)
            scatter(kcs, vcs, kvs, pages)
            # the first token reads row s0-1 (clamped like a JAX gather)
            last = torch.clamp(s0_vec - 1, 0, sb - 1)
            return self._first_token(h, last, p, head_logits)

        return run

    def _build_prefix_prefill(self, sb: int, bsz: int, w_pre: int):
        """Like _build_prefill, for rows whose prompt head hit the prefix
        cache: only the `sb`-bucketed suffix is computed, reading the
        cached prefix through per-row prefix tables [bsz, w_pre] (the
        prefix-prefill kernel)."""
        cfg = self.cfg
        base = _make_prefill_with_prefix(cfg, bsz, sb, w_pre,
                                         self.block_size)
        head_logits = _make_head_logits(cfg)
        scatter = self._page_scatter(bsz, sb // self.block_size)

        def run(p, kcs, vcs, ids, s0_vec, pages, ptables, plens):
            h, kvs = base(p, kcs, vcs, ids, ptables, plens,
                          s0_vec.to(torch.int32))
            scatter(kcs, vcs, kvs, pages)
            last = torch.clamp(s0_vec - 1, 0, sb - 1)
            return self._first_token(h, last, p, head_logits)

        return run

    def _page_scatter(self, bsz: int, n_pre: int):
        """scatter(kcs, vcs, kvs, pages): every layer's prefill K/V
        [bsz, n_pre*block_size, nkv, dh] -> whole pages, in place (on the
        scan rung's layer-major pool, layer i at pages + i * max_pages).
        Pad positions land in pages above the decode watermark (or in
        the scratch page, which no row attends); decode overwrites them
        before any row attends them. On int8 pools this is the
        quantize-on-scatter: each page's absmax (pad positions included,
        as in the JAX engine) becomes its scale, and the int8 page and its
        scale row are stored together."""
        cfg = self.cfg
        args = (bsz, n_pre, cfg.num_key_value_heads, cfg.head_dim,
                self.block_size, None)
        if self.kv_dtype == "int8":
            to_pages_q8, _ = make_paged_kv_q8_helpers(*args)

            def one(kct, vct, k, v, pages):
                for (pool, sc), kv in ((kct, k), (vct, v)):
                    qkv, skv = to_pages_q8(kv)
                    pool[pages] = qkv
                    sc[pages] = skv
        else:
            to_pages, _ = make_paged_kv_helpers(*args)

            def one(kc, vc, k, v, pages):
                kc[pages] = to_pages(k).to(kc.dtype)
                vc[pages] = to_pages(v).to(vc.dtype)

        stride = self._page_stride

        def scatter(kcs, vcs, kvs, pages):
            for i, (k, v) in enumerate(kvs):
                j = 0 if stride else i
                one(kcs[j], vcs[j], k, v, pages + i * stride)

        return scatter

    def _decode_step_maker(self):
        """make_step(tables) -> the decode step of the planned megakernel
        rung, or the multi-kernel paged step at 'off'; shared by the
        decode chunk and the unified step's decode lane. The layer-major
        pool of 'scan' has no multi-kernel twin."""
        cfg, b, bs = self.cfg, self.slots, self.block_size
        rung = self.megakernel_rung

        def make_step(tables):
            if rung != "off":
                return _make_decode_step_megakernel(cfg, b, tables, rung)
            return make_paged_decode_step(cfg, b, bs, tables,
                                          kv_cache_dtype=self.kv_dtype)

        return make_step

    def _build_decode_chunk(self):
        """`steps` decode tokens for every slot in one chunk. Free rows
        point at the scratch page and freeze their length, so they
        compute (fixed shape) but touch nothing live; `budgets` freezes
        each row at prompt + max_new."""
        b, steps = self.slots, self.steps
        eos = self.eos
        make_step = self._decode_step_maker()

        def run(p, kcs, vcs, toks, lens, budgets, tables, live):
            decode_step = make_step(tables)
            done = torch.zeros((b,), dtype=torch.bool, device=toks.device)
            tok, out = toks, []
            for _ in range(steps):
                logits, kcs, vcs = decode_step(p, kcs, vcs, tok[:, None],
                                               lens)
                nxt = _sample_next(logits.to(torch.float32), self._gen,
                                   self.do_sample, self.temperature,
                                   self.top_k, self.top_p)
                frozen = done | ~live | (lens >= budgets)
                if eos is not None:
                    nxt = torch.where(frozen, torch.full_like(nxt, eos), nxt)
                    done = done | (nxt == eos)
                else:
                    nxt = torch.where(frozen, torch.zeros_like(nxt), nxt)
                lens = torch.where(frozen, lens, lens + 1)
                tok = nxt
                out.append(nxt)
            return torch.stack(out, dim=1), lens, done

        return run

    def _build_unified_step(self):
        """The prefill-window lane of the mixed step: ONE ragged prefill
        window of `token_budget` tokens for the request currently
        prefilling, its page scatter and its first token. A mixed step
        runs every live slot's decode chunk (the split engine's, unchanged)
        and then this window; the lanes touch disjoint pages (the window's
        pages belong to a request no decode slot maps), so they run one
        after the other on the same pools."""
        cfg, bs = self.cfg, self.block_size
        tn = self.token_budget
        chunk_body = _make_chunk_prefill(cfg, tn)
        head_logits = _make_head_logits(cfg)
        scatter = self._page_scatter(1, tn // bs)

        def run(p, kcs, vcs, chunk_ids, chunk_table, chunk_cached, chunk_len,
                chunk_pages):
            h, kvs = chunk_body(p, kcs, vcs, chunk_ids, chunk_table,
                                chunk_cached, chunk_len)
            scatter(kcs, vcs, kvs, chunk_pages)
            # first-token logits at the window's true last position --
            # meaningful only when this window completes the prompt
            last = torch.clamp(chunk_len.to(torch.int64) - 1, 0, tn - 1)
            return (self._first_token(h, last, p, head_logits),)

        return run

    def _verify_scatter(self, w: int):
        """scatter(kc, vc, k, v, tables, cached_lens, new_lens): the
        token-granular K/V commit of one layer's verify window [b, w, nkv,
        dh], in place. Column j of every slot writes at position
        cached_len + j of the slot's own pages; pad columns (j >= new_len)
        and dead slots go to the scratch page. Columns commit in order:
        adjacent window positions share a page, and on int8 pools each
        column's absmax rescale must see the previous column's."""
        b, bs, W = self.slots, self.block_size, self.table_width
        nkv, dh = self.cfg.num_key_value_heads, self.cfg.head_dim
        quant = self.kv_dtype == "int8"
        scratch = self.scratch_page

        def scatter(kc, vc, k, v, tables, cached_lens, new_lens):
            rows = torch.arange(b, device=k.device)
            cached = cached_lens.to(torch.int64)
            for j in range(w):
                pos = cached + j
                col = torch.clamp(pos // bs, max=W - 1)
                page = torch.where(j < new_lens,
                                   tables[rows, col].to(torch.int64),
                                   scratch)
                if quant:
                    # the q8 commit owns the absmax rescale; a width-1
                    # table of the redirected page makes its page lookup
                    # land on exactly that page
                    _, w8 = make_paged_kv_q8_helpers(b, 0, nkv, dh, bs,
                                                     page[:, None])
                    w8(kc, vc, k[:, j:j + 1], v[:, j:j + 1], pos)
                else:
                    slot = pos % bs
                    kc[page, :, slot, :] = k[:, j].to(kc.dtype)
                    vc[page, :, slot, :] = v[:, j].to(vc.dtype)

        return scatter

    def _build_verify_chunk(self):
        """The speculative verify window: ONE ragged window of spec_k + 1
        rows a slot, row j holding [pending, d1..dk][j] at position
        cached_len + j (`_make_verify_window`); every layer's window K/V
        scatters into the slot's pages; returns the argmax of every row's
        logits [b, spec_k + 1] (row j: the token after window token j).
        Rejected rows' K/V past the committed length is never attended
        and a later commit overwrites it."""
        b, w = self.slots, self.spec_k + 1
        body = _make_verify_window(self.cfg, b, w)
        head_logits = _make_head_logits(self.cfg)
        scatter = self._verify_scatter(w)
        stride = self._page_stride

        def run(p, kcs, vcs, ids, tables, cached_lens, new_lens):
            h, kvs = body(p, kcs, vcs, ids, tables, cached_lens, new_lens)
            for i, (k, v) in enumerate(kvs):
                # the scan rung's layer-major pool: the table moves by the
                # layer's offset, the scratch redirect stays at the
                # layer-0 scratch row (a sink nothing attends)
                j = 0 if stride else i
                tbl = tables + i * stride if stride else tables
                scatter(kcs[j], vcs[j], k, v, tbl, cached_lens, new_lens)
            logits = head_logits(h, p)                    # [b, w, vocab]
            return (torch.argmax(logits.to(torch.float32), dim=-1),)

        return run

    def _prefill_key(self, kind: str, *shape) -> tuple:
        """The JAX engine's prefill program key, field for field: the
        kind and shape (bucket, batch[, prefix width]), then the pool
        dtype, the requested megakernel mode, spec_k, cp, quantized
        collectives and mp (1, 0 and 1 on one device)."""
        return (kind, *shape, self.kv_dtype, self.use_megakernel,
                self.spec_k, 1, 0, 1)

    def _get_prefill(self, sb: int, bsz: int) -> _Program:
        """The cold prefill program of (bucket, batch): ids [bsz, sb],
        prompt lengths [bsz], pages [bsz, sb / block_size] -> first
        tokens [bsz]; made and captured at its first use."""
        key = self._prefill_key("cold", sb, bsz)
        if key not in self._prefill_cache:
            self._add_prefill(key, self._build_prefill(sb, bsz),
                              self._prefill_inputs(sb, bsz))
        return self._prefill_cache[key]

    def _get_prefix_prefill(self, sb: int, bsz: int, w_pre: int) -> _Program:
        """The cached-prefix prefill program of (suffix bucket, batch,
        prefix width): the cold program's inputs plus the prefix tables
        [bsz, w_pre] and prefix lengths [bsz]."""
        key = self._prefill_key("prefix", sb, bsz, w_pre)
        if key not in self._prefill_cache:
            self._add_prefill(key, self._build_prefix_prefill(sb, bsz, w_pre),
                              self._prefill_inputs(sb, bsz, w_pre))
        return self._prefill_cache[key]

    def _prefill_inputs(self, sb: int, bsz: int, w_pre: int = 0) -> list:
        """A prefill program's static inputs, holding scratch rows (the
        JAX warm()'s): zero ids of length 1 aimed at the scratch page,
        prefix tables on the scratch page with length 0. Capturing over
        them touches only the scratch page, whatever is in flight."""
        dev, page = self.device, self.scratch_page
        ins = [torch.zeros((bsz, sb), dtype=torch.int64, device=dev),
               torch.ones((bsz,), dtype=torch.int64, device=dev),
               torch.full((bsz, sb // self.block_size), page,
                          dtype=torch.int64, device=dev)]
        if w_pre:
            ins += [torch.full((bsz, w_pre), page, dtype=torch.int32,
                               device=dev),
                    torch.zeros((bsz,), dtype=torch.int32, device=dev)]
        return ins

    def _add_prefill(self, key: tuple, body, inputs) -> None:
        """Make, capture and cache the prefill program `key` (through the
        prefill programs' graph site) with its host sets."""
        prog = _Program("prefill:" + ":".join(str(k) for k in key),
                        lambda *ins: (body(self.p, self.kcs, self.vcs,
                                           *ins),),
                        inputs, self._gen if self.do_sample else None,
                        site=self._prefill_site)
        self._prefill_site.capture(prog)
        self._prefill_cache[key] = prog
        self._prefill_bodies[prog.name] = body
        self._prefill_host[prog.name] = _HostSets(prog.inputs, prog.outputs)

    def _prefix_width_ladder(self) -> list:
        """The prefix-table widths (in pages) prefix prefills run at:
        powers of two of the pages-per-prompt-bucket quantum, capped at
        `_prefix_width`. A batch's width is padded up to the next rung, so
        a shallow-hit batch does not walk the deepest possible table."""
        ppb = max(1, self.prompt_bucket // self.block_size)
        widths, w = [], ppb
        while w < self._prefix_width:
            widths.append(w)
            w *= 2
        widths.append(self._prefix_width)
        return widths

    def _prefix_width_for(self, n_blocks: int) -> int:
        for w in self._prefix_width_ladder():
            if w >= n_blocks:
                return w
        return self._prefix_width

    def _make_programs(self) -> dict:
        """The engine's programs over static inputs of its fixed shapes,
        holding scratch rows until the first dispatch (every table names
        the scratch page, no slot is live, the window is empty): "decode"
        (toks, lens, budgets, tables, live -> out, lens, done); on the
        unified path, "unified" (window ids, table, cached, length, pages
        -> first token); with speculation, "verify" (ids, tables, cached
        lens, new lens -> argmax [b, spec_k + 1]; its scratch rows have
        new_len 1)."""
        b, w, dev = self.slots, self.table_width, self.device
        gen = self._gen if self.do_sample else None

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def scratch(*shape, dtype=torch.int32):
            return torch.full(shape, self.scratch_page, dtype=dtype,
                              device=dev)

        progs = {"decode": _Program(
            "decode",
            lambda *ins: self._decode(self.p, self.kcs, self.vcs, *ins),
            (zeros(b, dtype=torch.int64), zeros(b), zeros(b),
             scratch(b, w), zeros(b, dtype=torch.bool)), gen,
            site=self._site)}
        if self.unified:
            tn = self.token_budget
            progs["unified"] = _Program(
                "unified",
                lambda *ins: self._unified(self.p, self.kcs, self.vcs, *ins),
                (zeros(1, tn, dtype=torch.int64), scratch(1, w), zeros(1),
                 zeros(1), scratch(1, tn // self.block_size,
                                   dtype=torch.int64)), gen,
                site=self._site)
        if self.spec_k:
            progs["verify"] = _Program(
                "verify",
                lambda *ins: self._verify(self.p, self.kcs, self.vcs, *ins),
                (zeros(b, self.spec_k + 1, dtype=torch.int64),
                 scratch(b, w), zeros(b),
                 torch.ones((b,), dtype=torch.int32, device=dev)),
                site=self._site)
        return progs

    @property
    def graphed(self) -> bool:
        """Whether the programs replay CUDA graphs (always False on the
        CPU). Set to False before warm(), every program, prefill ones
        included, runs its eager body on the card instead: the yardstick
        the graphs are held to, never a choice the engine makes."""
        return self._site.graphed

    @graphed.setter
    def graphed(self, on: bool) -> None:
        on = bool(on) and self.device.type == "cuda"
        for site in (self._site, self._prefill_site, self._draft_site):
            site.graphed = on

    def _max_prefill_bsz(self) -> int:
        """_admit never batches beyond min(prefill_batch, slots): the
        largest power-of-two batch a prefill program is made for."""
        bsz = 1
        while bsz < min(self.prefill_batch, self.slots):
            bsz *= 2
        return bsz

    def warm(self, buckets=None, prefix_widths=None, audit_memory=None,
             audit_comms=None, audit_roofline=None):
        """Build the kernels (on the card) and capture every program the
        engine can need for the given prompt buckets (the JAX engine's
        warm()): each power-of-two prefill batch up to
        `_max_prefill_bsz()`, cold and, with the prefix cache, at each
        prefix width of `prefix_widths` (default: the whole ladder), plus
        the decode chunk, the unified window, the verify window and a
        draft model's program. `buckets` defaults to [max_prompt_len]; it
        must cover the SUFFIX buckets cache hits prefill at. On the
        unified path there is no prefill ladder and `buckets` is ignored.
        Each program runs once eagerly on scratch rows, then is recorded
        as a CUDA graph (the step programs in one memory pool, the
        prefill programs in another) that every later dispatch replays;
        on the CPU the programs stay eager. Once
        warm for the traffic's buckets, serving never captures again.

        `audit_memory` / `audit_roofline` then run the static audits over
        every program (`audit_memory`, `audit_roofline`: one trace of
        each program on fake tensors serves both) onto
        ``metrics()['memory_audit']`` / ``['roofline_audit']``. Default
        (None) follows FLAGS_audit_memory / FLAGS_audit_roofline
        (PADDLE_TPU_AUDIT_*), both implied by PADDLE_TPU_LINT=1.
        `audit_comms` resolving on raises: the port has no collective
        yet (ROADMAP.md section 1 item 5).

        The kernel build cache's traffic over this warm() lands on
        `warm_compile_stats` (``metrics()['warm_compile_stats']``,
        `serving/compile_cache.py`): libraries requested, found built and
        built by nvcc. Only a process's first kernel load builds, so a
        fresh process warming over a populated build directory reports
        `cache_misses == 0`, and a later engine of the process requests
        nothing. CUDA graph captures are counted by `compile_stats()`."""
        from ..analysis import resolve_audit_comms
        from ..analysis.memory import resolve_audit_memory
        from ..analysis.roofline import resolve_audit_roofline
        from . import compile_cache as _compile_cache

        snap = _compile_cache.snapshot()
        resolve_audit_comms(audit_comms)
        do_mem = resolve_audit_memory(audit_memory)
        do_roof = resolve_audit_roofline(audit_roofline)
        buckets = [self.max_prompt_len] if buckets is None else list(buckets)
        if self.unified:
            buckets = []
        ladder = self._prefix_width_ladder()
        if prefix_widths is None:
            prefix_widths = ladder
        elif not self.unified:
            bad = [w for w in prefix_widths if w not in ladder]
            if bad:
                raise ValueError(
                    f"prefix widths {bad} are not on the ladder {ladder}; "
                    "_admit only ever uses ladder rungs, so warming others "
                    "is dead")
        cap = self._max_prefill_bsz()
        # under the commit lock, like every capture at a first dispatch:
        # a watchdog-abandoned step can never dispatch beside a capture
        with self._commit_lock:
            for sb in buckets:
                if sb % self.prompt_bucket:
                    raise ValueError(f"bucket {sb} is not a multiple of "
                                     f"prompt_bucket {self.prompt_bucket}")
                bsz = 1
                while True:
                    self._get_prefill(sb, bsz)
                    if self.prefix_cache:
                        for w in prefix_widths:
                            self._get_prefix_prefill(sb, bsz, w)
                    if bsz >= cap:
                        break
                    bsz *= 2
            self._warm_programs()
        self.warm_compile_stats = _compile_cache.stats_since(snap)
        if do_mem or do_roof:
            shared = self._traced_inventory() if do_mem and do_roof else None
            if do_mem:
                self.audit_memory(graphs=shared)
            if do_roof:
                self.audit_roofline(graphs=shared)
            # the traces' graphs and fakes are reference cycles: collect
            # them here, not in the collector's passes while serving
            del shared
            gc.collect()

    # ---- static audits (analysis/) ------------------------------------

    def _program_inventory(self):
        """(name, body, inputs) of every program this engine can
        dispatch: the decode chunk, the unified window and the verify
        window where the engine has them, and every prefill program made
        so far; `body(params, pools_k, pools_v, *inputs)` is the
        program's function, `inputs` its static input tensors."""
        fns = {"decode": self._decode, "unified": self._unified,
               "verify": self._verify}
        progs = [(name, fns[name], prog.inputs)
                 for name, prog in self._programs.items()]
        for key, prog in sorted(self._prefill_cache.items(),
                                key=lambda kv: str(kv[0])):
            progs.append((prog.name, self._prefill_bodies[prog.name],
                          prog.inputs))
        return progs

    def _traced_inventory(self, programs=None):
        """(name, Graph) of every (optionally filtered) program: one
        ``torch.fx`` trace each on fake tensors made from the engine's
        parameters, pools and static inputs (no device memory, no
        launch, no tensor changes). Unknown filter names raise: a typo'd
        filter must not give a vacuously clean report."""
        from ..analysis.graph import trace_graph

        inventory = self._program_inventory()
        if programs is not None:
            want = set(programs)
            missing = want - {it[0] for it in inventory}
            if missing:
                raise ValueError(
                    f"programs {sorted(missing)} not in the inventory "
                    f"{[it[0] for it in inventory]}")
            inventory = [it for it in inventory if it[0] in want]
        return [(name, trace_graph(fn, self.p, self.kcs, self.vcs, *ins,
                                   name=name))
                for name, fn, ins in inventory]

    def audit_memory(self, hbm_budget_bytes=None, programs=None,
                     graphs=None) -> dict:
        """Static memory audit: the liveness pass (`analysis/memory.py`)
        over every program, one report for the engine (each program's
        peak, its in-place coverage and the TPU701/702/703 findings). The
        programs share the pools and params and run one at a time, so
        the engine's peak is the largest program's.

        `hbm_budget_bytes` arms TPU702; None derives it from
        `kv_pool_bytes=` when given (pools + params + 25% headroom,
        floored at 1 MiB) and else from the device
        (`analysis.device_specs.auto_hbm_budget`); 0 disarms it.
        `programs` filters by name ("decode", "prefill:cold:..."):
        unknown names raise, and a filtered run returns a `partial`
        report without touching ``metrics()``. `graphs` are (name,
        Graph) pairs of `_traced_inventory` to share one trace."""
        from ..analysis import memory as _mem
        from ..analysis.device_specs import auto_hbm_budget
        from ..analysis.pipeline import analyze as _analyze

        if hbm_budget_bytes is None and self._kv_pool_budget is not None:
            base = self._kv_pool_budget + _mem.pytree_local_bytes(self.p)
            hbm_budget_bytes = base + max(base // 4, 1 << 20)
        elif hbm_budget_bytes is None:
            hbm_budget_bytes = auto_hbm_budget(
                None if self.device.type == "cuda" else "h100-sxm")
        rule_config = {"TPU702.hbm_budget_bytes": int(hbm_budget_bytes)}
        if graphs is None:
            graphs = self._traced_inventory(programs)
        min_miss = _mem.DonationMissRule.MIN_BYTES
        out, diags = {}, 0
        for name, g in graphs:
            rep = _mem.audit_graph(g)
            lint = _analyze(None, graph=g,
                            rules=["TPU701", "TPU702", "TPU703"],
                            rule_config=rule_config)
            misses = [m for m in rep.donation["misses"]
                      if m["bytes"] >= min_miss]
            donated = rep.donation["donated_bytes"]
            missed = sum(m["bytes"] for m in misses)
            diags += len(lint)
            out[name] = {
                "peak_hbm_bytes": rep.peak_bytes,
                "n_eqns": rep.n_eqns,
                "mp": rep.mp,
                "donated_bytes": donated,
                "missed_bytes": missed,
                "donation_misses": len(misses),
                "donation_coverage": donated / (donated + missed)
                if donated + missed else 1.0,
                "diagnostics": lint.to_dict()["diagnostics"],
            }
        fleet_peak = max((p["peak_hbm_bytes"] for p in out.values()),
                         default=0)
        report = {
            "programs": out,
            "programs_audited": len(out),
            "fleet_peak_hbm_bytes": fleet_peak,
            "per_chip": True,
            "mp": 1,
            "cp": 1,
            "kv_pool_bytes": self.mgr.kv_pool_bytes(),
            "hbm_budget_bytes": hbm_budget_bytes,
            "donation_clean": all(p["donation_misses"] == 0
                                  for p in out.values()),
            "n_diagnostics": diags,
            "partial": programs is not None,
        }
        if report["partial"]:
            return report
        self._memory_audit = report
        tr, mt = self._tracer, self._metrics
        if tr is not None:
            tr.instant("memory.audit", fleet_peak_hbm_bytes=fleet_peak,
                       programs=len(out), mp=1,
                       donation_clean=report["donation_clean"])
        if mt is not None:
            mt.event("memory.audit", fleet_peak_hbm_bytes=fleet_peak,
                     programs=len(out), mp=1,
                     donation_clean=report["donation_clean"],
                     n_diagnostics=diags)
            mt.gauge("predicted_peak_hbm_bytes",
                     "static auditor per-chip peak over cached "
                     "programs").set(fleet_peak)
        return report

    def audit_comms(self, *args, **kwargs):
        """Not ported: the port has no collective yet (ROADMAP.md section
        1 item 5)."""
        from ..analysis import audit_comms

        return audit_comms(*args, **kwargs)

    def audit_roofline(self, device=None, programs=None, rule_config=None,
                       graphs=None) -> dict:
        """Static roofline audit: the FLOPs / bytes pass
        (`analysis/roofline.py`) over every program against one device
        row (`device`: a row name or DeviceSpec; None: the card's row,
        else the H100's): each program's predicted time (max of compute
        and HBM time, plus launches x the row's launch cost), bound class,
        predicted MFU, its hand-written kernel launches and the
        TPU901/902/903 findings. The decode chunk's `predicted_step_ms`
        and `predicted_mfu` are the headline gauges;
        `predicted_ms_per_token` divides the chunk by the tokens it makes
        (steps_per_sync x slots). `programs` and `graphs` as in
        `audit_memory`."""
        from ..analysis import roofline as _roof
        from ..analysis.pipeline import analyze as _analyze
        from ..analysis.rules import RULES, rule_config_for

        spec = _roof.get_spec(device)
        rc = dict(rule_config or {})

        def _rules():
            out = []
            for rid in ("TPU901", "TPU902", "TPU903"):
                knobs = rule_config_for(rid, rc)
                knobs.setdefault("device", spec)
                out.append(RULES[rid](**knobs))
            return out

        if graphs is None:
            graphs = self._traced_inventory(programs)
        out, diags = {}, 0
        for name, g in graphs:
            rep = _roof.audit_graph(g, spec)
            lint = _analyze(None, graph=g, rules=_rules())
            diags += len(lint)
            d = rep.to_dict(max_events=4)
            out[name] = {k: d[k] for k in (
                "predicted_step_ms", "predicted_mfu", "bound", "flops",
                "hbm_bytes", "wire_bytes", "kernel_launches", "kernels",
                "compute_ms", "bandwidth_ms", "wire_ms",
                "launch_overhead_ms", "padding_waste_fraction", "mp",
                "bottlenecks")}
            out[name]["diagnostics"] = lint.to_dict()["diagnostics"]
        step_ms = mfu = per_token_ms = None
        if "decode" in out:
            step_ms = out["decode"]["predicted_step_ms"]
            mfu = out["decode"]["predicted_mfu"]
            per_token_ms = step_ms / max(self.steps * self.slots, 1)
        report = {
            "programs": out,
            "programs_audited": len(out),
            "device": spec.name,
            "per_chip": True,
            "mp": 1,
            "cp": 1,
            "predicted_step_ms": step_ms,
            "predicted_mfu": mfu,
            "predicted_ms_per_token": per_token_ms,
            "roofline_clean": diags == 0,
            "n_diagnostics": diags,
            "partial": programs is not None,
        }
        if report["partial"]:
            return report
        self._roofline_audit = report
        tr, mt = self._tracer, self._metrics
        if tr is not None:
            tr.instant("roofline.audit", device=spec.name,
                       predicted_step_ms=step_ms, predicted_mfu=mfu,
                       programs=len(out), mp=1,
                       roofline_clean=report["roofline_clean"])
        if mt is not None:
            mt.event("roofline.audit", device=spec.name,
                     predicted_step_ms=step_ms, predicted_mfu=mfu,
                     programs=len(out), mp=1,
                     roofline_clean=report["roofline_clean"],
                     n_diagnostics=diags)
            if step_ms is not None:
                mt.gauge("predicted_step_ms",
                         "static roofline auditor predicted decode "
                         "chunk latency").set(step_ms)
                mt.gauge("predicted_mfu",
                         "static roofline auditor predicted decode "
                         "chunk MFU").set(mfu)
        return report

    def _warm_programs(self):
        """Capture the decode chunk and, where the engine has them, the
        unified window, the verify window and a draft model's program,
        and make their host sets (once; the first dispatch calls it)."""
        if self._host is not None:
            return
        for prog in self._programs.values():
            self._site.capture(prog)
        if self._drafter is not None:
            self._drafter.warm()
        # the chain mask rides the decode program's host sets
        extra = {"decode": (self._override_dev,)}
        self._host = {name: _HostSets(prog.inputs + extra.get(name, ()),
                                      prog.outputs)
                      for name, prog in self._programs.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage_in(self, name: str, arrays):
        """Write `arrays` into program `name`'s next host set and queue
        their copies into its device targets. Returns the set."""
        self._warm_programs()
        return self._host[name].stage_in(arrays)

    def _stage_out(self, name: str, hs):
        """Queue the copies of program `name`'s outputs into host set `hs`
        and record its event."""
        _HostSets.stage_out(hs, self._programs[name].outputs)

    def _read(self, hs) -> list:
        """Wait for host set `hs`'s copies and return its outputs as numpy
        arrays. A decode or verify caller times the wait and folds it into
        sync_wait_s / blocked_syncs under the commit lock."""
        if hs.event is not None:
            hs.event.synchronize()
        return [t.numpy() for t in hs.outputs]

    def _count_wait(self, wait: float) -> None:
        self.sync_wait_s += wait
        if wait > self.stall_threshold_s:
            self.blocked_syncs += 1

    def _device_range(self, name: str):
        """A torch.profiler range around a dispatch while tracing is on
        and a profiler is live (the host span is recorded apart)."""
        return obs_trace.device_range(name, self._tracer is not None)

    def _check_owner(self, token: Optional[int]):
        """A watchdog-abandoned step thread must stop mutating shared
        state (host sets, programs, pools, slots) the moment the live
        loop reclaims it (see run()). Called under the commit lock."""
        if token is not None and token != self._step_epoch:
            raise _AbandonedStep(
                "step abandoned by the watchdog; discarding its work")

    # ---- split scheduling -----------------------------------------------

    def _plan(self, req: ServeRequest) -> _Plan:
        """Admission plan: cached-prefix split + page reservation for one
        waiting request (a pure lookup; takes no references)."""
        bs = self.block_size
        L = len(req.prompt)
        cold_sb = -(-L // self.prompt_bucket) * self.prompt_bucket
        cold_total = self._capacity_pages_for(cold_sb, req.max_new)
        n_cached = 0
        if self.prefix_cache:
            # at least one suffix token always prefills (the first-token
            # logits must be computed even on a full hit)
            max_blocks = (L - 1) // bs
            if max_blocks > 0:
                n_cached, _ = self.mgr.prefix_lookup(
                    req.prompt, max_blocks, hashes=req.block_hashes)
        while True:
            suffix_len = L - n_cached * bs
            sb_suf = -(-suffix_len // self.prompt_bucket) \
                * self.prompt_bucket
            need = self._capacity_pages_for(sb_suf, req.max_new)
            # a block- but not bucket-aligned prefix widens the suffix
            # bucket: trim it until the hit path's pages never exceed the
            # cold path's (what the pool and table_width are sized to)
            if n_cached == 0 or n_cached + need <= cold_total:
                break
            n_cached -= 1
        n_lru = 0
        if n_cached:
            n_lru = self.mgr.prefix_lookup(req.prompt, n_cached,
                                           hashes=req.block_hashes)[1]
        return _Plan(sb_suf, n_cached, n_lru, need, suffix_len)

    def _admit(self, token: Optional[int] = None):
        """FIFO admission, batched: the head run of waiting requests
        sharing a (suffix bucket, cached-vs-cold) key -- bounded by free
        slots (disaggregated: by handoff headroom), available pages and
        prefill_batch -- prefills in ONE call, padded to a power of two
        with rows aimed at the scratch page. After the call, every freshly
        computed full prompt block enters the prefix cache."""
        if self._admission_paused:
            return
        bs = self.block_size
        while self.waiting:
            self._check_owner(token)
            if self.disaggregated:
                # the prefill worker: at most `slots` prefilled requests
                # parked at the handoff, never bounded by decode slots
                room = self.slots - len(self._handoff)
                if room <= 0:
                    return
                limit = min(room, self.prefill_batch)
            else:
                free_slots = [i for i, s in enumerate(self._slots)
                              if s.req is None]
                if not free_slots:
                    return
                limit = min(len(free_slots), self.prefill_batch)
            head = self._plan(self.waiting[0])
            key = (head.sb_suf, head.n_cached > 0)
            batch, plans = [], []
            # available = free + evictable; acquiring a refcount-0 cached
            # page also consumes availability (n_lru)
            avail = self.mgr.n_available
            for req in self.waiting:
                if len(batch) >= limit:
                    break
                plan = head if not batch else self._plan(req)
                if (plan.sb_suf, plan.n_cached > 0) != key:
                    break
                if plan.need + plan.n_lru > avail:
                    break  # FIFO: a short request must not starve the head
                avail -= plan.need + plan.n_lru
                batch.append(req)
                plans.append(plan)
            if not batch:
                return  # head is blocked on pages
            sb_suf, has_prefix = key
            n_pre = sb_suf // bs
            bsz = 1
            while bsz < len(batch):
                bsz *= 2
            ids = np.zeros((bsz, sb_suf), np.int64)
            s0s = np.ones((bsz,), np.int64)
            pages = np.full((bsz, n_pre), self.scratch_page, np.int64)
            # prefix-table width: the ladder rung covering the deepest hit
            # in this batch
            w_call = self._prefix_width_for(
                max(plan.n_cached for plan in plans)) if has_prefix else 1
            ptbl = np.full((bsz, w_call), self.scratch_page, np.int32)
            plens = np.zeros((bsz,), np.int32)
            tr, mt = self._tracer, self._metrics
            t_disp0 = time.perf_counter()
            with self._commit_lock:
                self._check_owner(token)
                # pin every row's cached prefix BEFORE any alloc:
                # alloc_pages evicts refcount-0 cached pages, and a pinned
                # page never is
                acquired = [self.mgr.acquire_prefix(
                                req.prompt, plan.n_cached,
                                hashes=req.block_hashes)
                            if plan.n_cached else []
                            for req, plan in zip(batch, plans)]
                for row, (req, plan) in enumerate(zip(batch, plans)):
                    cached = acquired[row]
                    priv = self.mgr.alloc_pages(plan.need)
                    req.bucket = sb_suf
                    if not self.disaggregated:
                        req.slot = free_slots[row]
                    req.pages = cached + priv
                    req.n_prefix = len(cached)
                    req.cached_tokens = len(cached) * bs
                    suffix = req.prompt[req.cached_tokens:]
                    ids[row, :len(suffix)] = suffix
                    s0s[row] = len(suffix)
                    pages[row] = priv[:n_pre]
                    if cached:
                        ptbl[row, :len(cached)] = cached
                        plens[row] = req.cached_tokens
                self.prefill_calls += 1
                # the batch's program (captured here if no warm() covered
                # its key, as JAX compiles at first use), fed through its
                # host sets
                if has_prefix:
                    prog = self._get_prefix_prefill(sb_suf, bsz, w_call)
                    arrays = (ids, s0s, pages, ptbl, plens)
                else:
                    prog = self._get_prefill(sb_suf, bsz)
                    arrays = (ids, s0s, pages)
                t_stage = time.perf_counter()
                with self._device_range("prefill.dispatch"):
                    hs = self._prefill_host[prog.name].stage_in(arrays)
                    _HostSets.stage_out(hs, prog())
            # the readback waits OUTSIDE the lock: a hung device wait must
            # never hold the lock the timeout path needs
            (firsts,) = self._read(hs)
            if tr is not None:
                # dispatch + readback as ONE span: the prefill program's
                # host-visible cost for this admission batch
                tr.complete("prefill.dispatch", int(t_disp0 * 1e9),
                            time.perf_counter_ns(), bucket=sb_suf,
                            batch=len(batch), cached_prefix=has_prefix,
                            req_ids=[r.req_id for r in batch])
            if mt is not None:
                mt.histogram(
                    "prefill_chunk_s",
                    "prefill dispatch + first-token readback").observe(
                        time.perf_counter() - t_disp0)
            # abandoned mid-prefill: commit NOTHING. The batch is still in
            # `waiting` (popped only below), so the live loop re-admits it
            # with fresh pages; this thread's pages (and prefix
            # references) leak, which beats racing the live thread for
            # the free list
            with self._commit_lock:
                self._check_owner(token)
                # prefill_s: staging to readback (a first-use capture
                # excluded). The readback wait is not a sync wait:
                # sync_wait_s / blocked_syncs count decode and verify
                # readbacks only, as in the JAX engine
                self.prefill_s += time.perf_counter() - t_stage
                del self.waiting[:len(batch)]
                now = time.perf_counter()
                for row, req in enumerate(batch):
                    req.tokens.append(int(firsts[row]))
                    req.prefill_time = now
                    self._account_prefill(req, sb_suf, t_disp0)
                    if self.disaggregated:
                        self._hand_off(req)
                    else:
                        self._bind_slot(req.slot, req)
            self._report_evictions()

    def _report_evictions(self):
        """LRU prefix evictions since the last report (alloc_pages evicts
        under pool pressure; surfacing the delta here keeps the manager
        free of observability)."""
        ev_delta = self.mgr.prefix_evictions - self._evictions_seen
        if ev_delta:
            self._evictions_seen = self.mgr.prefix_evictions
            if self._tracer is not None:
                self._tracer.instant("prefix.evict", n=ev_delta)
            if self._metrics is not None:
                self._metrics.counter("prefix_evictions").inc(ev_delta)

    def _account_prefill(self, req: ServeRequest, bucket: int,
                         t_disp0: float):
        """A request's prefill committed (its first token at
        `req.prefill_time`): count its prompt and cache hits, emit
        req.admit and the TTFT / queue-wait observations (queue wait runs
        to `t_disp0`, the dispatch or, on the unified path, the admission),
        and register its freshly computed full prompt blocks (their K/V
        depends on the prefix alone; decode writes start at len(prompt),
        never inside them). First writer wins on a hash race. Called under
        the commit lock."""
        self.prompt_tokens += len(req.prompt)
        self.prefix_hit_tokens += req.cached_tokens
        tr, mt = self._tracer, self._metrics
        if tr is not None:
            tr.instant("req.admit", req_id=req.req_id,
                       cached_tokens=req.cached_tokens, suffix_bucket=bucket)
        if mt is not None:
            # TTFT = arrival -> first token committed; queue wait =
            # arrival -> prefill dispatch
            mt.histogram("ttft_s", "arrival to first token").observe(
                req.prefill_time - req.arrival_time)
            mt.histogram("queue_wait_s",
                         "arrival to prefill dispatch").observe(
                             max(t_disp0 - req.arrival_time, 0.0))
            mt.counter("requests_admitted").inc()
            mt.counter("prompt_tokens").inc(len(req.prompt))
            mt.counter("prefix_hit_tokens").inc(req.cached_tokens)
        if self.prefix_cache:
            full = len(req.prompt) // self.block_size
            if full > req.n_prefix:
                self.prefix_inserts += self.mgr.insert_prefix(
                    req.prompt, req.pages[req.n_prefix:full],
                    start_block=req.n_prefix, hashes=req.block_hashes)

    def _bind_slot(self, slot_id: int, req: ServeRequest):
        """Install a prefilled request into a decode slot: map its pages
        into the block table (columns past its pages repeat its last
        page) and seed the chunk inputs from its first token."""
        first = req.tokens[0]
        slot = self._slots[slot_id]
        req.slot = slot_id
        slot.req = req
        slot.length = len(req.prompt)
        slot.emitted = 1
        slot.done = self.eos is not None and first == self.eos
        self._tables[slot_id] = req.pages + [req.pages[-1]] * \
            (self.table_width - len(req.pages))
        self._tokens[slot_id] = first
        self._budgets[slot_id] = len(req.prompt) + req.max_new
        self._override[slot_id] = True
        if slot.done or req.max_new == 1:
            self._retire(slot_id)

    def _hand_off(self, req: ServeRequest):
        """The prefill worker's end of a disaggregated admission: the
        request's pages are already resident, so it parks in the handoff
        queue for a decode slot. A request its prefill fully served (EOS
        first, or max_new == 1) retires here without ever taking a slot."""
        self.prefill_handoffs += 1
        if self._tracer is not None:
            self._tracer.instant("req.handoff", req_id=req.req_id)
        if self._metrics is not None:
            self._metrics.counter("prefill_handoffs").inc()
        if (self.eos is not None and req.tokens[0] == self.eos) \
                or req.max_new == 1:
            self._finish_prefilled(req)
        else:
            self._handoff.append(req)

    def _finish_prefilled(self, req: ServeRequest):
        req.finish_time = time.perf_counter()
        self.finished.append(req)
        if self._tracer is not None:
            # the same lifecycle terminator as _retire: span-coverage
            # checks must see every request retire, slotless or not
            self._tracer.instant("req.retire", req_id=req.req_id, slot=None,
                                 tokens=len(req.tokens), failed=False)
        if self._metrics is not None:
            self._metrics.counter("requests_finished").inc()
        self.mgr.free(req.pages)
        req.pages = None

    def _install_handoffs(self, token: Optional[int] = None):
        """The decode worker's half: map handed-off requests (FIFO) into
        free decode slots. Host bookkeeping only: the table row and the
        chunk seeds."""
        if not self._handoff:
            return
        with self._commit_lock:
            self._check_owner(token)
            for slot_id, slot in enumerate(self._slots):
                if not self._handoff:
                    break
                if slot.req is None:
                    self._bind_slot(slot_id, self._handoff.pop(0))

    def _retire(self, slot_id: int, failed: bool = False,
                error: Optional[str] = None):
        slot = self._slots[slot_id]
        req = slot.req
        req.finish_time = time.perf_counter()
        req.failed = failed
        req.error = error
        self.finished.append(req)
        tr, mt = self._tracer, self._metrics
        if tr is not None:
            tr.instant("req.retire", req_id=req.req_id, slot=slot_id,
                       tokens=len(req.tokens), failed=failed,
                       priority=req.priority, deadline_s=req.deadline_s,
                       deadline_miss=(
                           req.deadline_s is not None
                           and req.finish_time - req.arrival_time
                           > req.deadline_s))
        if mt is not None:
            mt.counter("requests_failed" if failed
                       else "requests_finished").inc()
            if not failed and req.prefill_time is not None \
                    and len(req.tokens) > 1:
                # time per OUTPUT token, the first (prefill) token excluded
                mt.histogram(
                    "tpot_s", "decode seconds per output token").observe(
                        (req.finish_time - req.prefill_time)
                        / (len(req.tokens) - 1))
        # refcount-aware: private pages recycle now; shared prefix pages
        # only once no live slot maps them (then LRU, evicted on pressure)
        self.mgr.free(req.pages)
        req.pages = None
        slot.req, slot.length, slot.emitted, slot.done = None, 0, 0, False
        # the row must stop pointing at freed pages before they recycle
        self._tables[slot_id] = self.scratch_page
        self._tokens[slot_id] = 0
        self._budgets[slot_id] = 0
        self._override[slot_id] = True
        if self._drafter is not None:
            self._drafter.release(slot_id)

    def _live(self) -> np.ndarray:
        return np.asarray([s.req is not None for s in self._slots])

    def _launch_decode(self, live, chain: bool):
        """Enqueue one decode chunk from host state without waiting: copy
        the slots' tokens, lengths, budgets, tables and live flags into the
        decode program's static inputs, replay it, and queue its outputs'
        copies out. With `chain`, the tokens and lengths of every slot the
        host left unchanged since the last dispatch are taken from that
        chunk's device outputs instead (a where on the device, in stream
        order before this replay overwrites them); without it the chain is
        invalidated. Returns the host set the outputs land in."""
        prog = self._programs["decode"]
        lens = np.asarray([s.length for s in self._slots], np.int32)
        chained = chain and self._chain_tok is not None \
            and not self._override.all()
        hs = self._stage_in("decode", (self._tokens, lens, self._budgets,
                                       self._tables, live, self._override))
        if chained:
            toks_in, lens_in = prog.inputs[:2]
            ov = self._override_dev
            torch.where(ov, toks_in, self._chain_tok, out=toks_in)
            torch.where(ov, lens_in, self._chain_lens, out=lens_in)
        out, new_lens, _ = prog()
        if chain:
            self._chain_tok, self._chain_lens = out[:, -1], new_lens
            self._override[:] = False
        else:
            # host state is authoritative after a synchronous step; a
            # later pipelined dispatch must not chain a stale chunk
            self._chain_tok = self._chain_lens = None
            self._override[:] = True
        self._stage_out("decode", hs)
        return hs

    def _dispatch_chunk(self, token: Optional[int] = None,
                        chain: bool = False):
        """Enqueue one decode chunk; returns its record (None if no slot
        is live). The dispatch start time rides the record: _commit_chunk
        turns (dispatch start -> readback done) into decode_chunk_s."""
        live = self._live()
        if not live.any():
            return None
        if self._watchdog is not None:
            self._watchdog.phase = "decode"
        # the chaos hang seam sits BEFORE the dispatch and BEFORE the
        # lock: an abandoned step unwinds (ChaosHang) or aborts at the
        # owner check without ever touching the card from a dead thread
        chaos.maybe_hang("decode")
        tr, mt = self._tracer, self._metrics
        t_disp0 = time.perf_counter()
        with self._commit_lock:
            self._check_owner(token)
            with self._device_range("decode.dispatch"):
                hs = self._launch_decode(live, chain)
            self.device_steps += 1
            if tr is not None:
                tr.complete("decode.dispatch", int(t_disp0 * 1e9),
                            time.perf_counter_ns(), chunk=self.device_steps,
                            live=int(live.sum()))
            if mt is not None:
                mt.gauge("live_slots", "slots decoding").set(int(live.sum()))
                mt.gauge("kv_pages_available",
                         "free + evictable pool pages").set(
                             self.mgr.n_available)
            return {"host": hs, "reqs": [s.req for s in self._slots],
                    "t_disp0": t_disp0}

    def _commit_chunk(self, rec, token: Optional[int] = None) -> int:
        """Read a chunk back and commit it: extend token lists, advance
        lengths, retire EOS / finished rows. Rows whose slot changed hands
        since the chunk was dispatched (double buffering: retired, then
        re-admitted) are skipped: their device work was speculative, and
        its writes land in pages that are overwritten before any new owner
        reads them. A mixed step's record waits on its window (`host`, the
        step's last work) and commits its decode lane (`lane`, None when
        no slot was live). Returns tokens produced."""
        tr, mt = self._tracer, self._metrics
        t0 = time.perf_counter()
        outs = self._read(rec["host"])           # the host sync
        t1 = time.perf_counter()
        wait = t1 - t0
        stalled = wait > self.stall_threshold_s
        if tr is not None:
            # the sync wait was timed anyway: record it retroactively (a
            # `stalled` span is the stall double buffering exists to hide)
            tr.complete("decode.sync_wait", int(t0 * 1e9), int(t1 * 1e9),
                        stalled=stalled)
        if mt is not None:
            mt.histogram("sync_wait_s",
                         "host blocked on decode readback").observe(wait)
            mt.histogram("decode_chunk_s",
                         "decode-chunk dispatch to readback").observe(
                             t1 - rec["t_disp0"])
            if stalled:
                mt.counter("blocked_syncs").inc()
        lane = rec.get("lane", rec["host"])
        with self._commit_lock:
            self._check_owner(token)  # abandoned mid-wait: discard
            self.decode_s += t1 - rec["t_disp0"]
            self._count_wait(wait)
            produced = 0
            if lane is not None:
                # a mixed step's decode lane finished before its window
                out, new_lens, done = outs if lane is rec["host"] \
                    else self._read(lane)
                for slot_id, slot in enumerate(self._slots):
                    req = rec["reqs"][slot_id]
                    if req is None or slot.req is not req or req.done:
                        continue
                    take = min(self.steps, req.max_new - slot.emitted)
                    toks = out[slot_id, :take].tolist()
                    if self.eos is not None and self.eos in toks:
                        toks = toks[:toks.index(self.eos) + 1]
                    req.tokens.extend(toks)
                    produced += len(toks)
                    slot.emitted += len(toks)
                    slot.length = int(new_lens[slot_id])
                    slot.done = bool(done[slot_id])
                    self._tokens[slot_id] = toks[-1] if toks else 0
                    if slot.done or slot.emitted >= req.max_new:
                        self._retire(slot_id)
            if mt is not None:
                mt.counter("output_tokens").inc(produced)
            return produced

    # ---- unified scheduling ---------------------------------------------

    def _plan_unified(self, req: ServeRequest) -> _Plan:
        """Token-budget admission plan: the EXACT page reservation,
        ceil((prompt - cached + max_new) / block) private pages next to
        the cached prefix blocks. No bucket rounding, so no prefix trim:
        cached + private = ceil((prompt + max_new) / block), within the
        cold-path bound the pool and table_width are sized to."""
        bs = self.block_size
        L = len(req.prompt)
        n_cached = n_lru = 0
        if self.prefix_cache:
            max_blocks = (L - 1) // bs  # >= 1 window token always prefills
            if max_blocks > 0:
                n_cached, n_lru = self.mgr.prefix_lookup(
                    req.prompt, max_blocks, hashes=req.block_hashes)
        suffix = L - n_cached * bs
        need = -(-(suffix + req.max_new) // bs)
        return _Plan(None, n_cached, n_lru, need, suffix)

    def _admit_unified(self, token: Optional[int] = None):
        """Start prefilling the FIFO head when the chunk lane is free, its
        pages fit, and a decode slot will exist at completion. Its whole
        reservation (cached prefix pinned + private pages) commits here;
        the prompt then streams through `token_budget` windows."""
        if self._admission_paused:
            return
        if self._prefilling is not None or not self.waiting:
            return
        req = self.waiting[0]
        plan = self._plan_unified(req)
        if self.disaggregated:
            # handoff headroom, not decode occupancy
            if len(self._handoff) >= self.slots:
                return
        elif not any(s.req is None for s in self._slots):
            # one free slot now guarantees one at completion: only
            # completion binds slots in unified mode, retirements only add
            # free ones
            return
        if plan.need + plan.n_lru > self.mgr.n_available:
            return
        with self._commit_lock:
            self._check_owner(token)
            cached = self.mgr.acquire_prefix(
                req.prompt, plan.n_cached,
                hashes=req.block_hashes) if plan.n_cached else []
            priv = self.mgr.alloc_pages(plan.need)
            self.waiting.pop(0)
            req.pages = cached + priv
            req.n_prefix = len(cached)
            req.cached_tokens = len(cached) * self.block_size
            req.bucket = self.token_budget
            # "dispatched" flips once a window of this request has ridden
            # a dispatch: only then does the watchdog blame it (a timeout
            # draining a pure-decode chunk dispatched before this
            # admission is the decode program's fault)
            self._prefilling = {"req": req, "done": req.cached_tokens,
                                "t0": time.perf_counter(),
                                "dispatched": False}
        self._report_evictions()

    def _dispatch_commit_unified(self, token: Optional[int] = None) -> int:
        """One mixed step: every live slot's decode chunk plus the next
        prefill window of the prefilling request; commit both lanes."""
        st = self._prefilling
        req = st["req"]
        L = len(req.prompt)
        done = st["done"]
        tn, bs = self.token_budget, self.block_size
        n_win = tn // bs
        this_chunk = min(L - done, tn)
        wp0 = done // bs
        # window pages past the request's reservation go to the scratch
        # page (repeated ids in one scatter are fine: nothing attends it)
        win_pages = req.pages[wp0:wp0 + n_win]
        win_pages += [self.scratch_page] * (n_win - len(win_pages))
        ids = np.zeros((1, tn), np.int64)
        ids[0, :this_chunk] = req.prompt[done:done + this_chunk]
        tbl = np.full((1, self.table_width), self.scratch_page, np.int32)
        tbl[0, :len(req.pages)] = req.pages
        if self._watchdog is not None:
            self._watchdog.phase = "decode"
        chaos.maybe_hang("decode")
        tr, mt = self._tracer, self._metrics
        t_disp0 = time.perf_counter()
        with self._commit_lock:
            self._check_owner(token)
            st["dispatched"] = True
            live = self._live()
            with self._device_range("decode.dispatch"):
                # the decode lane only when a slot is live (a lane of
                # frozen rows would commit nothing), then the window; a
                # mixed step is authoritative host state, so no pipelined
                # chunk chains across it
                dec = self._launch_decode(live, chain=False) \
                    if live.any() else None
                self._chain_tok = self._chain_lens = None
                self._override[:] = True
                win = self._stage_in("unified", (ids, tbl, [done],
                                                 [this_chunk], [win_pages]))
                self._programs["unified"]()
                self._stage_out("unified", win)
            self.device_steps += 1
            self.prefill_chunks += 1
            if tr is not None:
                tr.complete("decode.dispatch", int(t_disp0 * 1e9),
                            time.perf_counter_ns(), chunk=self.device_steps,
                            live=int(live.sum()), prefill_window=True,
                            req_id=req.req_id)
            if mt is not None:
                mt.gauge("live_slots", "slots decoding").set(int(live.sum()))
                mt.gauge("kv_pages_available",
                         "free + evictable pool pages").set(
                             self.mgr.n_available)
            # the window is the step's last work: one wait covers both
            # lanes
            rec = {"host": win, "lane": dec,
                   "reqs": [s.req for s in self._slots], "t_disp0": t_disp0}
        produced = self._commit_chunk(rec, token)
        first = int(win.outputs[0].numpy()[0])
        if tr is not None:
            # the window is this request's prefill work for the step: the
            # same prefill.dispatch lifecycle event the split path emits
            tr.complete("prefill.dispatch", int(t_disp0 * 1e9),
                        time.perf_counter_ns(), bucket=self.token_budget,
                        batch=1, cached_prefix=req.n_prefix > 0,
                        chunk_tokens=this_chunk, req_ids=[req.req_id])
        if mt is not None:
            mt.histogram("prefill_chunk_s",
                         "prefill dispatch + first-token readback").observe(
                             time.perf_counter() - t_disp0)
        with self._commit_lock:
            self._check_owner(token)
            st["done"] = done + this_chunk
            self.chunk_tokens += this_chunk
            if st["done"] >= L:
                self._prefilling = None
                self._finish_unified_prefill(req, first, st["t0"])
        return produced

    def _finish_unified_prefill(self, req: ServeRequest, first: int,
                                t_admit: float):
        """The final window of a prompt committed: account the admission
        (queue wait up to `t_admit`), register its fresh full blocks in the
        prefix cache, and bind it to a decode slot (disaggregated: hand it
        off). Called under the commit lock."""
        req.tokens.append(first)
        req.prefill_time = time.perf_counter()
        self._account_prefill(req, self.token_budget, t_admit)
        if self.disaggregated:
            self._hand_off(req)
            return
        free = [i for i, s in enumerate(self._slots) if s.req is None]
        if not free:
            raise RuntimeError(
                "no free decode slot at unified prefill completion -- "
                "_admit_unified guarantees one")
        self._bind_slot(free[0], req)

    def _step_unified(self, token: Optional[int], pipeline: bool) -> int:
        """One unified-path iteration. Pure-decode phases dispatch the
        plain decode chunk, synchronous or double-buffered exactly like the
        split engine (the same program), or with speculation a verify
        step. While a request is prefilling the step is a mixed dispatch;
        a pipelined chunk in flight commits first (its device-side chain
        cannot span a step that rewrites host state)."""
        wd = self._watchdog
        if wd is not None:
            wd.phase = "admit"
        self._admit_unified(token)
        if self.disaggregated:
            self._install_handoffs(token)
        if self._prefilling is not None:
            with self._commit_lock:
                self._check_owner(token)
                prev, self._inflight = self._inflight, None
            n = 0
            if prev is not None:
                if wd is not None:
                    wd.phase = "commit"
                n = self._commit_chunk(prev, token)
                if wd is not None:
                    wd.phase = "admit"
            return n + self._dispatch_commit_unified(token)
        if self.spec_k:
            # drafting against a half-prefilled prompt has nothing to
            # verify: only pure-decode steps speculate
            return self._drain_inflight(token) + self._step_spec(token)
        rec = self._dispatch_chunk(token, chain=pipeline)
        if pipeline:
            with self._commit_lock:
                self._check_owner(token)
                prev, self._inflight = self._inflight, rec
            if prev is not None:
                if wd is not None:
                    wd.phase = "commit"
                return self._commit_chunk(prev, token)
            return 0
        if rec is None:
            return 0
        return self._commit_chunk(rec, token)

    def _drain_inflight(self, token: Optional[int] = None) -> int:
        """Commit (and clear) the pipelined chunk in flight, if any."""
        with self._commit_lock:
            self._check_owner(token)
            prev, self._inflight = self._inflight, None
        if prev is None:
            return 0
        if self._watchdog is not None:
            self._watchdog.phase = "commit"
        return self._commit_chunk(prev, token)

    # ---- speculative decoding -------------------------------------------

    def _step_spec(self, token: Optional[int] = None) -> int:
        """One speculative iteration: draft up to spec_k tokens per live
        slot, verify every slot's pending token and drafts as ONE window
        of spec_k + 1 rows, then commit the longest matching draft prefix
        plus the target's corrected token, clipped to max_new and then to
        EOS. A slot with no drafts rides the window at new_len 1: one
        verified token, a plain decode step's math. Synchronous (the
        committed lengths are a host decision), so the double-buffer
        chain is invalidated."""
        live = self._live()
        if not live.any():
            return 0
        wd = self._watchdog
        if wd is not None:
            wd.phase = "decode"
        # the chaos hang seam BEFORE the dispatch and BEFORE the lock,
        # exactly like _dispatch_chunk
        chaos.maybe_hang("decode")
        tr, mt = self._tracer, self._metrics
        b, k = self.slots, self.spec_k
        # the adaptive depth caps what the drafter is ASKED for; the
        # window stays k + 1 rows and unproposed depth is pad
        k_eff = self._spec_policy.spec_k_effective \
            if self._spec_policy is not None else k
        t_disp0 = time.perf_counter()
        with self._commit_lock:
            self._check_owner(token)
            self._warm_programs()
            ids = np.zeros((b, k + 1), np.int64)
            new_lens = np.ones((b,), np.int32)
            lens = np.asarray([s.length for s in self._slots], np.int32)
            drafts = [None] * b
            reqs = [s.req for s in self._slots]
            for slot_id, slot in enumerate(self._slots):
                req = slot.req
                if req is None:
                    continue    # dead rows ride along on the scratch page
                ids[slot_id, 0] = self._tokens[slot_id]
                # never draft past the row budget (window position L + j
                # writes K/V there) nor past max_new; the corrected token
                # needs its own headroom
                want = min(k_eff,
                           int(self._budgets[slot_id]) - slot.length - 1,
                           req.max_new - slot.emitted - 1)
                d = []
                if want > 0 and self._drafter is not None:
                    d = list(self._drafter.draft(
                        slot_id, req.req_id, req.prompt + req.tokens, want,
                        table_row=self._tables[slot_id],
                        budget=int(self._budgets[slot_id])))[:want]
                drafts[slot_id] = d
                ids[slot_id, 1:1 + len(d)] = d
                new_lens[slot_id] = 1 + len(d)
            with self._device_range("spec.verify"):
                hs = self._stage_in("verify", (ids, self._tables, lens,
                                               new_lens))
                self._programs["verify"]()
                self._stage_out("verify", hs)
            self.device_steps += 1
            self.spec_steps += 1
            # acceptance rewrites host tokens and lengths per slot: a
            # later pipelined dispatch must not chain stale device state
            self._chain_tok = self._chain_lens = None
            self._override[:] = True
            if tr is not None:
                tr.complete("spec.verify", int(t_disp0 * 1e9),
                            time.perf_counter_ns(), chunk=self.device_steps,
                            live=int(live.sum()),
                            drafted=int(sum(len(d) for d in drafts if d)))
            if mt is not None:
                mt.gauge("live_slots", "slots decoding").set(int(live.sum()))
        # the readback waits outside the lock, with _commit_chunk's
        # sync-wait telemetry
        t0 = time.perf_counter()
        (preds,) = self._read(hs)
        t1 = time.perf_counter()
        wait = t1 - t0
        stalled = wait > self.stall_threshold_s
        if tr is not None:
            tr.complete("decode.sync_wait", int(t0 * 1e9), int(t1 * 1e9),
                        stalled=stalled)
        if mt is not None:
            mt.histogram("sync_wait_s",
                         "host blocked on decode readback").observe(wait)
            mt.histogram("decode_chunk_s",
                         "decode-chunk dispatch to readback").observe(
                             t1 - t_disp0)
            if stalled:
                mt.counter("blocked_syncs").inc()
        if wd is not None:
            wd.phase = "commit"
        with self._commit_lock:
            self._check_owner(token)  # abandoned mid-wait: discard
            self.decode_s += t1 - t_disp0
            self._count_wait(wait)
            produced = 0
            for slot_id, slot in enumerate(self._slots):
                req = reqs[slot_id]
                if req is None or slot.req is not req or req.done:
                    continue
                d, row = drafts[slot_id], preds[slot_id]
                n_acc = 0
                while n_acc < len(d) and d[n_acc] == int(row[n_acc]):
                    n_acc += 1
                toks = d[:n_acc] + [int(row[n_acc])]
                toks = toks[:max(req.max_new - slot.emitted, 0)]
                if self.eos is not None and self.eos in toks:
                    toks = toks[:toks.index(self.eos) + 1]
                self.spec_drafted += len(d)
                self.spec_accepted += min(n_acc, len(toks))
                if d and self._spec_policy is not None:
                    self._spec_policy.observe(len(d), n_acc)
                if d and mt is not None:
                    mt.histogram(
                        "spec_acceptance",
                        "accepted draft fraction per window").observe(
                            n_acc / len(d))
                req.tokens.extend(toks)
                produced += len(toks)
                slot.emitted += len(toks)
                # the window wrote positions L .. L + new_len - 1;
                # everything before the new pending token (toks[-1]) is
                # committed cache
                slot.length += len(toks)
                self._tokens[slot_id] = toks[-1] if toks else 0
                if self._drafter is not None:
                    self._drafter.note_commit(slot_id, slot.length)
                if (self.eos is not None and toks
                        and toks[-1] == self.eos) \
                        or slot.emitted >= req.max_new:
                    self._retire(slot_id)
            if mt is not None:
                mt.counter("output_tokens").inc(produced)
            return produced

    # ---- the loop -------------------------------------------------------

    def step(self) -> int:
        """One synchronous scheduling iteration: admit -> decode chunk
        (with a prefill window on the unified path) -> read back ->
        retire. Returns the number of tokens produced."""
        wd = self._watchdog
        # the ownership token: if the watchdog abandons this step, run()
        # bumps _step_epoch and every later owner check in THIS thread
        # raises _AbandonedStep instead of racing the live loop
        token = self._step_epoch if wd is not None else None
        if self.unified:
            return self._step_unified(token, pipeline=False)
        if wd is not None:
            wd.phase = "admit"
        self._admit(token)
        if self.disaggregated:
            self._install_handoffs(token)
        if self.spec_k:
            return self._drain_inflight(token) + self._step_spec(token)
        rec = self._dispatch_chunk(token)
        if rec is None:
            return 0
        return self._commit_chunk(rec, token)

    def _pipeline_step(self) -> int:
        """One double-buffered iteration: admit, dispatch chunk N+1, THEN
        block on chunk N, so the host's commit work (readback, retirement,
        the next admission's planning) overlaps chunk N+1's device time.
        Admissions and retirements take effect one chunk later than in
        synchronous mode; budgets and the slot-ownership snapshot keep the
        speculative chunk harmless."""
        wd = self._watchdog
        token = self._step_epoch if wd is not None else None
        if self.unified:
            return self._step_unified(token, pipeline=True)
        if wd is not None:
            wd.phase = "admit"
        self._admit(token)
        if self.disaggregated:
            self._install_handoffs(token)
        if self.spec_k:
            # speculative steps are synchronous (acceptance is a host
            # decision): drain the chunk in flight, then verify
            return self._drain_inflight(token) + self._step_spec(token)
        rec = self._dispatch_chunk(token, chain=True)
        with self._commit_lock:
            self._check_owner(token)
            prev, self._inflight = self._inflight, rec
        if prev is not None:
            if wd is not None:
                wd.phase = "commit"
            return self._commit_chunk(prev, token)
        return 0

    def run(self, max_iters: int = 100000,
            watchdog_timeout: Optional[float] = None,
            double_buffer: Optional[bool] = None,
            requeue_hung: bool = False):
        """Drain the queues; returns the finished requests.
        `double_buffer` (default: the engine's) pipelines the chunks; a
        drained pipeline may end with one uncommitted chunk whose rows all
        retired, which is dropped.

        `watchdog_timeout` (seconds; default FLAGS_step_timeout_s /
        PADDLE_TPU_STEP_TIMEOUT_S, 0 = off) bounds every scheduling step
        with a wall-clock deadline: each step runs on a worker thread (on
        this engine's device and the caller's current stream), and a step
        that blows the deadline retires ONE victim slot (the lowest live
        one, marked `failed`; on the unified path the prefilling request
        first, once its window has been dispatched). Its pages go back
        through the refcounted pool, so a cached prefix page another live
        slot maps stays pinned. The engine keeps serving the others. A
        timeout with no live slot to blame re-raises. In double-buffered
        mode a timeout also DROPS the uncommitted chunk in flight: the
        surviving rows regenerate its tokens from the last committed host
        state (its host set is reused only after its copies complete).
        Call `warm()` before arming a tight deadline: a first-use capture
        inside a watchdogged step eats the budget, and the timeout path
        waits for it (captures run under the commit lock).

        `requeue_hung`: instead of failing the victim, give it ONE retry:
        the request re-enters `waiting` at the head with its slot freed and
        its pages released through the pool; generation restarts from the
        prompt. The second timeout of the same request fails it. Counted
        by `metrics()['hung_requeued']`."""
        if watchdog_timeout is None:
            watchdog_timeout = float(flag("step_timeout_s"))
        self._requeue_hung = bool(requeue_hung)
        db = self.double_buffer if double_buffer is None else double_buffer
        step_fn = self._pipeline_step if db else self.step
        wd = None
        if watchdog_timeout and watchdog_timeout > 0:
            from ..resilience.watchdog import StepTimeout, Watchdog

            wd = Watchdog(watchdog_timeout, name="engine.step")
            step_fn = self._on_this_thread_state(step_fn)
        self._watchdog = wd
        try:
            while self.has_work and max_iters:
                if wd is None:
                    step_fn()
                else:
                    try:
                        wd.call(step_fn)
                    except StepTimeout as e:
                        # reclaim ownership FIRST: the abandoned thread
                        # aborts at its next owner check instead of
                        # committing stale results or writing host sets
                        # and replaying programs the live loop now owns;
                        # the lock serializes this against a commit right
                        # at the deadline (it lands fully before the bump,
                        # or aborts fully after it)
                        with self._commit_lock:
                            self._step_epoch += 1
                            self._inflight = None
                            self._chain_tok = self._chain_lens = None
                            self._override[:] = True
                            retired = self._retire_hung_slot(e)
                        if not retired:
                            raise
                max_iters -= 1
        finally:
            self._watchdog = None
            with self._commit_lock:
                self._inflight = None
                self._chain_tok = self._chain_lens = None
                self._override[:] = True
        if self.has_work:
            raise RuntimeError("engine did not drain within max_iters")
        return self.finished

    def _on_this_thread_state(self, fn):
        """`fn` wrapped to run on a watchdog worker thread with the
        calling thread's torch state: grad mode and, on the card, this
        engine's device and the current stream (replays, host-set copies
        and their events must share the stream the programs and
        `_HostSets` were made for; a new thread starts on device 0's
        default stream)."""
        grad = torch.is_grad_enabled()
        stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None

        def on_state():
            with torch.set_grad_enabled(grad):
                if stream is None:
                    return fn()
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(stream):
                    return fn()

        return on_state

    def _retire_hung_slot(self, exc) -> bool:
        """Degrade gracefully after a StepTimeout: fail the victim slot
        (the lowest-id live slot: deterministic, and FIFO admission makes
        it the longest-running row), recycle its pages, keep the rest.
        With `requeue_hung` armed, a first-time victim is REQUEUED instead
        (see `run`). Returns False when no slot is live (nothing to
        blame). Always called under the commit lock AFTER the epoch bump,
        so the abandoned step thread can never commit tokens into (or
        dispatch against the pages of) the request reset here."""
        # unified path: a timeout once the prefilling request's window
        # has ridden a dispatch blames THAT request first (the same
        # window re-dispatches every step: blaming decode would fail up
        # to `slots` innocent rows against a hanging window)
        if self._prefilling is not None \
                and self._prefilling.get("dispatched"):
            self._fail_prefilling(exc)
            return True
        live = [i for i, s in enumerate(self._slots) if s.req is not None]
        if not live:
            if self._prefilling is not None:
                # nothing else to blame: the undispatched-window edge
                # collapses back onto the prefilling request
                self._fail_prefilling(exc)
                return True
            return False
        victim = live[0]
        if self._requeue_hung and not self._slots[victim].req.requeued:
            self._requeue_slot(victim)
            return True
        self.hung_retired += 1
        self._emit_hung_retire(victim, exc)
        self._retire(victim, failed=True, error=str(exc))
        return True

    def _emit_hung_retire(self, slot, exc):
        """The watchdog.retire_hung_slot emission shared by the slot and
        the prefilling victim (slot None)."""
        tr, mt = self._tracer, self._metrics
        if tr is not None:
            tr.instant("watchdog.retire_hung_slot", slot=slot,
                       phase=getattr(exc, "phase", None),
                       elapsed_s=getattr(exc, "elapsed_s", None))
        if mt is not None:
            mt.counter("hung_slots_retired").inc()
            mt.event("watchdog.retire_hung_slot", slot=slot,
                     phase=getattr(exc, "phase", None),
                     timeout_s=getattr(exc, "timeout_s", None))

    def _emit_hung_requeue(self, slot, req):
        """The watchdog.requeue_hung_slot emission shared by both requeue
        paths."""
        tr, mt = self._tracer, self._metrics
        if tr is not None:
            tr.instant("watchdog.requeue_hung_slot", slot=slot,
                       req_id=req.req_id)
        if mt is not None:
            mt.counter("hung_slots_requeued").inc()
            mt.event("watchdog.requeue_hung_slot", slot=slot,
                     req_id=req.req_id)

    def _fail_prefilling(self, exc):
        """Watchdog victim = the request mid-chunked-prefill (unified path):
        release its reservation through the refcount-aware pool (shared
        prefix pages another slot maps stay pinned) and fail it, or, under
        `requeue_hung`, give it its one retry from the head of `waiting`
        (prefill restarts at the prompt). Called under the commit lock
        after the epoch bump, like `_retire_hung_slot`."""
        st, self._prefilling = self._prefilling, None
        req = st["req"]
        self.mgr.free(req.pages)
        req.pages = None
        req.n_prefix = 0
        req.cached_tokens = 0
        req.bucket = None
        if self._requeue_hung and not req.requeued:
            req.requeued = True
            self.hung_requeued += 1
            self.waiting.insert(0, req)
            self._emit_hung_requeue(None, req)
            return
        self.hung_retired += 1
        req.finish_time = time.perf_counter()
        # every finished request carries a prefill_time: a mid-prefill
        # failure pins it to finish_time
        if req.prefill_time is None:
            req.prefill_time = req.finish_time
        req.failed = True
        req.error = str(exc)
        self.finished.append(req)
        self._emit_hung_retire(None, exc)
        if self._tracer is not None:
            self._tracer.instant("req.retire", req_id=req.req_id, slot=None,
                                 tokens=len(req.tokens), failed=True)
        if self._metrics is not None:
            self._metrics.counter("requests_failed").inc()

    def _requeue_slot(self, slot_id: int):
        """Put a hung slot's request back at the head of `waiting` for
        exactly one retry: release its pages through the refcount-aware
        pool (a shared prefix page a live peer maps stays pinned; pages
        are never recycled in place), reset the request to its
        pre-admission state (tokens regenerate from the prompt; the block
        hashes survive), and free the slot row."""
        slot = self._slots[slot_id]
        req = slot.req
        req.requeued = True
        self.hung_requeued += 1
        self.mgr.free(req.pages)
        req.pages = None
        req.slot = None
        req.bucket = None
        req.tokens = []
        req.prefill_time = None
        req.n_prefix = 0
        req.cached_tokens = 0
        slot.req, slot.length, slot.emitted, slot.done = None, 0, 0, False
        # the row must stop pointing at released pages before they are
        # handed to another request
        self._tables[slot_id] = self.scratch_page
        self._tokens[slot_id] = 0
        self._budgets[slot_id] = 0
        self._override[slot_id] = True
        if self._drafter is not None:
            self._drafter.release(slot_id)
        self.waiting.insert(0, req)
        self._emit_hung_requeue(slot_id, req)
