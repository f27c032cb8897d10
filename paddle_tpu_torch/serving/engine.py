"""Continuous-batching serving engine over the paged KV cache
(counterpart of paddle_tpu/serving/engine.py, split scheduler only).

New prompts enter while other sequences decode, finished rows retire
mid-stream and their pages recycle into the pool. The device sees fixed
shapes between host scheduling points:

- per-layer K/V pools [max_pages, Hkv, block_size, D], updated IN PLACE
  by the prefill page scatter and the decode-step token write;
- a block table [slots, table_width] int32 mapping each slot's logical
  blocks to pool pages (free slots point at a reserved scratch page,
  table columns past a request's pages repeat its last page);
- per-slot lengths, tokens, budgets and live flags.

Admission is FIFO and batched: the head run of waiting requests sharing
a prompt bucket prefills in one call, padded to a power-of-two batch
with rows aimed at the scratch page (the cold path: flash-attention
prefill, then a page scatter). Decode runs `steps_per_sync` tokens for
every slot per chunk (a Python loop of decode steps, each one paged
decode attention per layer), then the host reads the chunk back, retires
EOS / finished rows and admits from the queue. A per-row budget
(prompt + max_new) freezes rows on the device, so a chunk never writes
past a request's reserved pages.

Options of the JAX engine that this port does not serve yet raise
NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import time
from collections import namedtuple
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import _build
from ..kernels.flash_attention import KERNEL_HEAD_DIMS
from ..models.llama import (PagedKVManager, _make_head_logits,
                            _make_prefill, _sample_next,
                            make_paged_decode_step, make_paged_kv_helpers,
                            resolve_decode_megakernel,
                            resolve_kv_cache_dtype, resolve_serving_cp,
                            resolve_serving_mp, resolve_unified_step)

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
    # host-side scheduling state (None until admitted)
    slot: Optional[int] = None
    pages: Optional[list] = None
    bucket: Optional[int] = None           # prompt bucket it prefilled at

    @property
    def done(self) -> bool:
        return self.finish_time is not None


class _Slot:
    __slots__ = ("req", "length", "emitted", "done")

    def __init__(self):
        self.req = None        # ServeRequest or None (free)
        self.length = 0        # tokens cached (prompt + emitted - 1 pending)
        self.emitted = 0       # new tokens produced so far
        self.done = False      # EOS seen inside a chunk


# admission plan for one waiting request: prompt bucket, pages to reserve
_Plan = namedtuple("_Plan", "sb need")


class ContinuousBatchingEngine:
    """Continuous batching over `PagedKVManager`, on one device.

    Usage::

        eng = ContinuousBatchingEngine(cfg, params, slots=8,
                                       max_new_tokens=64)
        eng.add_request([1, 5, 9, ...])
        eng.run()
        for req in eng.finished: print(req.tokens)

    `params` is the decode-params dict (``init_serving_params`` or
    ``params_from_jax``) on `device` (None = cuda). A request is admitted
    when a slot is free and the pool holds its full reservation
    (ceil((bucketed prompt + max_new) / block_size) pages), so no
    preemption is ever needed."""

    def __init__(self, cfg, dec_params, *, slots: int = 8,
                 prompt_bucket: int = 64, max_prompt_len: int = 512,
                 max_new_tokens: int = 64,
                 block_size: Optional[int] = None,
                 max_pages: Optional[int] = None, steps_per_sync: int = 8,
                 prefill_batch: int = 4,
                 eos_token_id: Optional[int] = None, do_sample: bool = False,
                 top_k: int = 0, temperature: float = 1.0,
                 top_p: float = 1.0, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 prefix_cache: bool = False, double_buffer: bool = False,
                 kv_cache_dtype: Optional[str] = None,
                 decode_megakernel=None,
                 serving_mp: Optional[int] = None,
                 serving_cp: Optional[int] = None,
                 disaggregated: bool = False, unified_step=None,
                 speculative: Optional[str] = None,
                 config=None, tracer=None, metrics=None, device=None):
        if prefix_cache:
            raise _unported("prefix_cache=True (it needs the prefix_prefill "
                            "kernel)")
        if double_buffer:
            raise _unported("double_buffer=True")
        if disaggregated:
            raise _unported("disaggregated=True")
        if config not in (None, False):
            raise _unported("config= (tuned-config artifacts)")
        if tracer not in (None, False) or metrics not in (None, False):
            raise _unported("tracer= / metrics= (observability)")
        self.kv_dtype = resolve_kv_cache_dtype(kv_cache_dtype)
        if self.kv_dtype != "bf16":
            raise _unported("kv_cache_dtype='int8'")
        if resolve_decode_megakernel(decode_megakernel) != "off":
            raise _unported("decode_megakernel other than 'off'")
        if resolve_unified_step(unified_step):
            raise _unported("unified_step=True")
        if resolve_serving_mp(serving_mp) > 1:
            raise _unported("serving_mp > 1")
        if resolve_serving_cp(serving_cp) > 1:
            raise _unported("serving_cp > 1")
        if speculative not in (None, "off"):
            raise _unported("speculative decoding")
        if any(isinstance(w, tuple) for w in dec_params.values()):
            raise _unported("weight-only quantized params")
        if block_size is None:
            block_size = 64
        block_size = int(block_size)
        if prompt_bucket % block_size:
            raise ValueError(
                f"prompt_bucket {prompt_bucket} must be a whole number of "
                f"KV pages (multiple of block_size {block_size}) so "
                f"prefill scatters whole pages")
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
        # pool capacity: every slot full-length at the engine budget, plus
        # the scratch page; the cold-path width bounds every block table
        cap = self._capacity_pages(self.max_prompt_len)
        self.table_width = cap
        nkv, dh = cfg.num_key_value_heads, cfg.head_dim
        if max_pages is None:
            max_pages = slots * cap + 1
        self.mgr = PagedKVManager(max_pages, block_size)
        self.mgr.set_pool_geometry(n_layers=cfg.num_hidden_layers,
                                   num_kv_heads=nkv, head_dim=dh,
                                   kv_cache_dtype=self.kv_dtype)
        self.scratch_page = self.mgr.alloc_pages(1)[0]  # free rows' sink
        shape = (max_pages, nkv, block_size, dh)
        self.kcs = [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(cfg.num_hidden_layers)]
        self.vcs = [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(cfg.num_hidden_layers)]
        self._slots = [_Slot() for _ in range(slots)]
        self._tables = np.full((slots, cap), self.scratch_page, np.int32)
        self._tokens = np.zeros((slots,), np.int64)
        self._budgets = np.zeros((slots,), np.int32)  # prompt + max_new
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.waiting: list[ServeRequest] = []
        self.finished: list[ServeRequest] = []
        self._next_id = 0
        self._prefill_cache = {}
        self._decode = self._build_decode_chunk()
        self.device_steps = 0    # decode-chunk dispatches
        self.prefill_calls = 0   # batched-admission device calls
        self.decode_s = 0.0      # host wall time of decode chunks, synced
        self.prefill_s = 0.0     # host wall time of prefill calls, synced

    # ---- host-side accounting -------------------------------------------

    def _capacity_pages(self, sb: int) -> int:
        return self._capacity_pages_for(sb, self.max_new)

    def _capacity_pages_for(self, sb: int, max_new: int) -> int:
        return -(-(sb + max_new) // self.block_size)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self._slots if s.req is not None)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or self.n_active > 0

    def metrics(self) -> dict:
        """Scheduling counters and each kernel's launch count (since the
        last ``kernels.reset_launch_counts()``)."""
        return {
            "requests_finished": len(self.finished),
            "requests_waiting": len(self.waiting),
            "requests_active": self.n_active,
            "prefill_calls": self.prefill_calls,
            "device_steps": self.device_steps,
            "decode_s": self.decode_s,
            "prefill_s": self.prefill_s,
            "kernel_launches": _build.launch_counts(),
        }

    def add_request(self, prompt, max_new: Optional[int] = None,
                    arrival_time: Optional[float] = None) -> ServeRequest:
        """Validate + enqueue; every reject happens here, before the
        request owns a slot or pages."""
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
        self._next_id += 1
        self.waiting.append(req)
        return req

    # ---- device programs ------------------------------------------------

    def _build_prefill(self, sb: int, bsz: int):
        """Prefill `bsz` requests in one call: scatter each row's pages,
        pick each row's first token at its own true length."""
        cfg = self.cfg
        base = _make_prefill(cfg, bsz, sb)
        head_logits = _make_head_logits(cfg)
        scatter = self._page_scatter(bsz, sb // self.block_size)

        def run(p, kcs, vcs, ids, s0_vec, pages):
            h, kvs = base(p, ids)
            for i, (k, v) in enumerate(kvs):
                scatter(kcs[i], vcs[i], k, v, pages)
            # the first token reads row s0-1 (clamped like a JAX gather)
            last = torch.clamp(s0_vec - 1, 0, sb - 1)
            h_last = h[torch.arange(bsz, device=h.device), last][:, None]
            logits = head_logits(h_last, p)[:, -1]
            return _sample_next(logits.to(torch.float32), self._gen,
                                self.do_sample, self.temperature,
                                self.top_k, self.top_p)

        return run

    def _page_scatter(self, bsz: int, n_pre: int):
        """Prefill K/V [bsz, sb, nkv, dh] -> whole pages, in place. Pad
        positions [s0, sb) land in pages above the decode watermark;
        decode overwrites them before any row attends them."""
        cfg = self.cfg
        to_pages, _ = make_paged_kv_helpers(
            bsz, n_pre, cfg.num_key_value_heads, cfg.head_dim,
            self.block_size, None)

        def scatter(kc, vc, k, v, pages):
            kc[pages] = to_pages(k).to(kc.dtype)
            vc[pages] = to_pages(v).to(vc.dtype)

        return scatter

    def _decode_step_maker(self):
        """make_step(tables) -> the per-layer paged decode step."""
        cfg, b, bs = self.cfg, self.slots, self.block_size

        def make_step(tables):
            return make_paged_decode_step(cfg, b, bs, tables)

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

    def _get_prefill(self, sb: int, bsz: int):
        key = (sb, bsz)
        if key not in self._prefill_cache:
            self._prefill_cache[key] = self._build_prefill(sb, bsz)
        return self._prefill_cache[key]

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def warm(self):
        """Build the kernels (on a CUDA device) and run one decode chunk
        on scratch rows, so the first request pays no build."""
        if self.device.type == "cuda":
            for name in _build.SIGNATURES:
                _build.library(name)
        b = self.slots
        zeros = np.zeros((b,), np.int32)
        self._decode(self.p, self.kcs, self.vcs,
                     self._to_dev(np.zeros((b,), np.int64)),
                     self._to_dev(zeros), self._to_dev(zeros),
                     self._to_dev(np.full((b, self.table_width),
                                          self.scratch_page, np.int32)),
                     self._to_dev(np.zeros((b,), bool)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- scheduling -----------------------------------------------------

    def _plan(self, req: ServeRequest) -> _Plan:
        sb = -(-len(req.prompt) // self.prompt_bucket) * self.prompt_bucket
        return _Plan(sb, self._capacity_pages_for(sb, req.max_new))

    def _admit(self):
        """FIFO admission, batched: the head run of waiting requests
        sharing a prompt bucket -- bounded by free slots, available pages
        and prefill_batch -- prefills in ONE call, padded to a power of
        two with rows aimed at the scratch page."""
        bs = self.block_size
        while self.waiting:
            free_slots = [i for i, s in enumerate(self._slots)
                          if s.req is None]
            if not free_slots:
                return
            limit = min(len(free_slots), self.prefill_batch)
            head = self._plan(self.waiting[0])
            batch, plans = [], []
            avail = self.mgr.n_available
            for req in self.waiting:
                if len(batch) >= limit:
                    break
                plan = head if not batch else self._plan(req)
                if plan.sb != head.sb:
                    break
                if plan.need > avail:
                    break  # FIFO: a short request must not starve the head
                avail -= plan.need
                batch.append(req)
                plans.append(plan)
            if not batch:
                return  # head is blocked on pages
            sb = head.sb
            n_pre = sb // bs
            bsz = 1
            while bsz < len(batch):
                bsz *= 2
            ids = np.zeros((bsz, sb), np.int64)
            s0s = np.ones((bsz,), np.int64)
            pages = np.full((bsz, n_pre), self.scratch_page, np.int64)
            for row, (req, plan) in enumerate(zip(batch, plans)):
                req.pages = self.mgr.alloc_pages(plan.need)
                req.bucket = sb
                req.slot = free_slots[row]
                ids[row, :len(req.prompt)] = req.prompt
                s0s[row] = len(req.prompt)
                pages[row] = req.pages[:n_pre]
            self.prefill_calls += 1
            t0 = time.perf_counter()
            firsts = self._get_prefill(sb, bsz)(
                self.p, self.kcs, self.vcs, self._to_dev(ids),
                self._to_dev(s0s), self._to_dev(pages)).cpu().numpy()
            self.prefill_s += time.perf_counter() - t0
            del self.waiting[:len(batch)]
            now = time.perf_counter()
            for row, req in enumerate(batch):
                req.tokens.append(int(firsts[row]))
                req.prefill_time = now
                self._bind_slot(req.slot, req)

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
        if slot.done or req.max_new == 1:
            self._retire(slot_id)

    def _retire(self, slot_id: int):
        slot = self._slots[slot_id]
        req = slot.req
        req.finish_time = time.perf_counter()
        self.finished.append(req)
        self.mgr.free(req.pages)
        req.pages = None
        slot.req, slot.length, slot.emitted, slot.done = None, 0, 0, False
        # the row must stop pointing at freed pages before they recycle
        self._tables[slot_id] = self.scratch_page
        self._tokens[slot_id] = 0
        self._budgets[slot_id] = 0

    def _dispatch_chunk(self):
        """Enqueue one decode chunk; returns its record (None if no slot
        is live)."""
        live = np.asarray([s.req is not None for s in self._slots])
        if not live.any():
            return None
        lens = np.asarray([s.length for s in self._slots], np.int32)
        t0 = time.perf_counter()
        out, new_lens, done = self._decode(
            self.p, self.kcs, self.vcs, self._to_dev(self._tokens),
            self._to_dev(lens), self._to_dev(self._budgets),
            self._to_dev(self._tables), self._to_dev(live))
        self.device_steps += 1
        return {"out": out, "lens": new_lens, "done": done,
                "reqs": [s.req for s in self._slots], "t0": t0}

    def _commit_chunk(self, rec) -> int:
        """Read a chunk back and commit it: extend token lists, advance
        lengths, retire EOS / finished rows. Returns tokens produced."""
        out = rec["out"].cpu().numpy()            # the blocking host sync
        new_lens = rec["lens"].cpu().numpy()
        done = rec["done"].cpu().numpy()
        self.decode_s += time.perf_counter() - rec["t0"]
        produced = 0
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
        return produced

    def step(self) -> int:
        """One scheduling iteration: admit -> decode chunk -> read back
        -> retire. Returns the number of tokens produced."""
        self._admit()
        rec = self._dispatch_chunk()
        if rec is None:
            return 0
        return self._commit_chunk(rec)

    def run(self, max_iters: int = 100000,
            watchdog_timeout: Optional[float] = None):
        """Drain the queues; returns the finished requests."""
        if watchdog_timeout:
            raise _unported("watchdog_timeout > 0")
        while self.has_work and max_iters:
            self.step()
            max_iters -= 1
        if self.has_work:
            raise RuntimeError("engine did not drain within max_iters")
        return self.finished
