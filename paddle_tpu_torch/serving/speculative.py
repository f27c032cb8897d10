"""Speculative decoding for the port's serving engine (counterpart of
paddle_tpu/serving/speculative.py).

A drafter guesses the next `k` tokens of a slot; the target scores the
slot's pending token and its drafts as ONE ragged window of k + 1 rows
through ``ragged_paged_attention`` (the engine's "verify" program, a CUDA
graph on the card), and greedy acceptance keeps the longest draft prefix
that matches the target's own argmax plus the target's one corrected
token. Rejection is bookkeeping only: lengths rewind, every mask ignores
positions past the committed length, and later commits overwrite them.

Two drafters:

- `NGramDrafter` (policy "ngram"): host-side prompt lookup. The tail
  n-gram of the request's prompt + generated history is matched against
  its most recent earlier occurrence, and the tokens that followed it are
  the drafts; a miss drafts nothing (the window is then one decode row).
- `DraftModelDrafter` (policy "draft"): a small Llama free-runs the paged
  decode step over its OWN pools, which share the engine's page geometry
  and block tables. One fixed-shape program of m decode steps (a CUDA
  graph on the card) serves prompt catch-up and the free run alike: step
  j feeds the forced token while j < n_feed and its own argmax after.

`resolve_speculative`, `resolve_spec_k` and `resolve_spec_adaptive` read
FLAGS_speculative / FLAGS_spec_k / FLAGS_spec_adaptive (or their
PADDLE_TPU_* aliases) when an engine is built; "off" builds the engine
exactly as without the flag.

``python -m paddle_tpu_torch.serving.speculative`` serves a repetitive
trace with the n-gram drafter next to a spec-off engine and exits 0 only
when every request's tokens match and drafts were accepted.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

SPECULATIVE_POLICIES = ("off", "ngram", "draft")


def resolve_speculative(speculative: Optional[str] = None) -> str:
    """'off' | 'ngram' | 'draft', from the argument or FLAGS_speculative /
    PADDLE_TPU_SPECULATIVE, read when an engine is built."""
    if speculative is None:
        from ..framework.flags import flag as _flag

        speculative = str(_flag("speculative"))
    speculative = speculative.strip().lower() or "off"
    if speculative not in SPECULATIVE_POLICIES:
        raise ValueError(
            f"speculative must be one of {SPECULATIVE_POLICIES}, got "
            f"{speculative!r}")
    return speculative


def resolve_spec_k(spec_k: Optional[int] = None) -> int:
    """Draft depth (the verify window is spec_k + 1 rows), from the
    argument or FLAGS_spec_k / PADDLE_TPU_SPEC_K."""
    if spec_k is None:
        from ..framework.flags import flag as _flag

        spec_k = int(_flag("spec_k"))
    spec_k = int(spec_k)
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    return spec_k


def resolve_spec_adaptive(spec_adaptive: Optional[bool] = None) -> bool:
    """Whether the engine adapts its draft depth to the acceptance it
    sees (`AdaptiveSpecPolicy`), from the argument or FLAGS_spec_adaptive
    / PADDLE_TPU_SPEC_ADAPTIVE. Host policy only: the verify window keeps
    spec_k + 1 rows."""
    if spec_adaptive is None:
        from ..framework.flags import flag as _flag

        spec_adaptive = _flag("spec_adaptive")
    if isinstance(spec_adaptive, str):
        spec_adaptive = spec_adaptive.strip().lower() in (
            "1", "true", "yes", "on")
    return bool(spec_adaptive)


class AdaptiveSpecPolicy:
    """Acceptance-adaptive draft depth, on the host.

    Tracks an EWMA of each window's accepted / offered fraction. Below
    `shrink_below` the effective depth walks down one token per window
    (floor 1); after `patience` consecutive windows above `grow_above` it
    grows back one token toward `spec_k`. Only the engine's per-slot
    `want` cap reads `spec_k_effective`."""

    def __init__(self, spec_k: int, *, alpha: float = 0.2,
                 shrink_below: float = 0.4, grow_above: float = 0.8,
                 patience: int = 3):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.spec_k = int(spec_k)
        self.alpha = float(alpha)
        self.shrink_below = float(shrink_below)
        self.grow_above = float(grow_above)
        self.patience = int(patience)
        self._k_eff = int(spec_k)
        self._ewma: Optional[float] = None
        self._high_streak = 0

    @property
    def spec_k_effective(self) -> int:
        return self._k_eff

    @property
    def acceptance_ewma(self) -> Optional[float]:
        return self._ewma

    def observe(self, offered: int, accepted: int) -> None:
        """One slot-window outcome: `offered` drafts went into the verify
        window, `accepted` matched the target."""
        if offered <= 0:
            return
        frac = min(max(accepted / offered, 0.0), 1.0)
        self._ewma = frac if self._ewma is None else (
            self.alpha * frac + (1.0 - self.alpha) * self._ewma)
        if self._ewma < self.shrink_below:
            self._high_streak = 0
            if self._k_eff > 1:
                self._k_eff -= 1
        elif self._ewma > self.grow_above:
            self._high_streak += 1
            if (self._high_streak >= self.patience
                    and self._k_eff < self.spec_k):
                self._k_eff += 1
                self._high_streak = 0
        else:
            self._high_streak = 0


class Drafter:
    """What the engine's speculative step drives. `draft` is required;
    `attach` / `warm` let a device drafter build and capture its programs
    against the engine's page geometry, `note_commit` says how many
    tokens the target committed (a draft cache never stays above that),
    `release` frees a slot's state when its request retires."""

    def attach(self, engine):
        pass

    def warm(self):
        pass

    def draft(self, slot_id: int, req_id: int, history: list, k: int,
              table_row=None, budget: Optional[int] = None) -> list:
        """Up to `k` proposed continuations of `history` (the prompt and
        every emitted token, the pending token last); fewer or none is
        always legal."""
        raise NotImplementedError

    def note_commit(self, slot_id: int, committed_len: int):
        pass

    def release(self, slot_id: int):
        pass

    def compile_stats(self) -> dict:
        """Captures of the drafter's programs, merged into the engine's
        `compile_stats()`."""
        return {}


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: the continuation of the most recent
    earlier occurrence of the history's tail n-gram, widest n first
    (`max_ngram` down to `min_ngram`); no match drafts nothing. Host-only
    and stateless."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}..{max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def draft(self, slot_id, req_id, history, k, table_row=None,
              budget=None):
        if k <= 0 or len(history) < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, len(history) - 1),
                       self.min_ngram - 1, -1):
            pat = history[-n:]
            # the most recent occurrence strictly before the tail itself,
            # so a continuation token always exists
            for s in range(len(history) - n - 1, -1, -1):
                if history[s:s + n] == pat:
                    return list(history[s + n:s + n + k])
        return []


class DraftModelDrafter(Drafter):
    """Draft-model drafting over the drafter's own paged pools.

    `cfg` / `dec_params` are the draft Llama (a decode-params dict on the
    engine's device). Its pools ([max_pages, Hkv, block, D] per layer, in
    `dtype`, bf16 by default) mirror the engine's page geometry and the
    program reads the engine's block tables, so page ids mean the same on
    both sides. One program of m = max(spec_k + 1, 16) paged decode steps
    serves bind-time prompt catch-up, post-commit catch-up and the free
    run: step j's input is ``where(j < n_feed, feed[:, j], argmax of step
    j - 1)``, chosen on the device; rows past their `n_tot` steps, dead
    rows and rows at their budget keep their length. On the card the
    program is one CUDA graph (`compile_stats()` "draft"), dispatched once
    per slot per speculative step."""

    def __init__(self, cfg, dec_params, *,
                 dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.p = dec_params
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self._eng = None
        self._prog = None
        self._host = None

    # ---- engine-geometry plumbing --------------------------------------

    def attach(self, engine):
        from .engine import _Program

        cfg = self.cfg
        dev = engine.device
        emb = self.p["llama.embed_tokens.weight"]
        if emb.device != dev:
            raise ValueError(f"draft params live on {emb.device}, the "
                             f"engine runs on {dev}")
        self._eng = engine
        b, bs = engine.slots, engine.block_size
        self._b, self._bs = b, bs
        shape = (engine.mgr.max_pages, cfg.num_key_value_heads, bs,
                 cfg.head_dim)
        self.kcs = [torch.zeros(shape, dtype=self.dtype, device=dev)
                    for _ in range(cfg.num_hidden_layers)]
        self.vcs = [torch.zeros(shape, dtype=self.dtype, device=dev)
                    for _ in range(cfg.num_hidden_layers)]
        # k free-run steps plus at least the pending token of catch-up;
        # wider, so a bind's prompt catch-up takes fewer dispatches
        self.m = max(engine.spec_k + 1, 16)
        run = self._build_run(b, self.m)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # scratch rows until the first dispatch: nothing live, every
        # table naming the engine's scratch page
        self._prog = _Program(
            "draft", lambda *ins: run(self.p, self.kcs, self.vcs, *ins),
            (zeros(b, self.m, dtype=torch.int64), zeros(b), zeros(b),
             zeros(b), zeros(b),
             torch.full((b, engine.table_width), engine.scratch_page,
                        dtype=torch.int32, device=dev),
             zeros(b, dtype=torch.bool)), site=engine._draft_site)
        self._host = None
        self._len = np.zeros((b,), np.int64)
        self._bound = [None] * b

    def _build_run(self, b, m):
        from ..models.llama import make_paged_decode_step

        cfg, bs = self.cfg, self._bs

        def run(p, kcs, vcs, feed, n_feed, n_tot, lens, budgets, tables,
                live):
            step = make_paged_decode_step(cfg, b, bs, tables)
            tok, outs = feed[:, 0], []
            for j in range(m):
                inp = torch.where(j < n_feed, feed[:, j], tok)
                logits, _, _ = step(p, kcs, vcs, inp[:, None], lens)
                tok = torch.argmax(logits.to(torch.float32), dim=-1)
                frozen = ~live | (j >= n_tot) | (lens >= budgets)
                lens = torch.where(frozen, lens, lens + 1)
                outs.append(tok)
            return torch.stack(outs, dim=1), lens

        return run

    def warm(self):
        """Capture the draft program (a CUDA graph on the card; on the CPU
        its body runs once over the scratch rows)."""
        if self._host is not None:
            return
        from .engine import _HostSets

        dev = self._eng.device
        self._prog.site.capture(self._prog)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._host = _HostSets(self._prog.inputs, self._prog.outputs)

    def compile_stats(self) -> dict:
        return {"draft": self._prog.captures if self._prog is not None
                else 0}

    # ---- drafting ------------------------------------------------------

    def _dispatch(self, slot_id, feed, k, budget, tables):
        b = self._b
        feed_a = np.zeros((b, self.m), np.int64)
        feed_a[slot_id, :len(feed)] = feed
        n_feed = np.zeros((b,), np.int32)
        n_feed[slot_id] = len(feed)
        n_tot = np.zeros((b,), np.int32)
        n_tot[slot_id] = len(feed) + max(k - 1, 0) if k else len(feed)
        budgets = np.zeros((b,), np.int32)
        budgets[slot_id] = budget
        live = np.zeros((b,), bool)
        live[slot_id] = True
        self.warm()
        hs = self._host.stage_in((feed_a, n_feed, n_tot,
                                  self._len.astype(np.int32), budgets,
                                  tables, live))
        self._host.stage_out(hs, self._prog())
        if hs.event is not None:
            hs.event.synchronize()
        outs, lens = (t.numpy() for t in hs.outputs)
        self._len[slot_id] = int(lens[slot_id])
        return outs[slot_id].copy()

    def draft(self, slot_id, req_id, history, k, table_row=None,
              budget=None):
        if self._prog is None:
            raise RuntimeError(
                "DraftModelDrafter.draft before attach(engine): pass the "
                "drafter to ContinuousBatchingEngine(drafter=...)")
        if k <= 0:
            return []
        if self._bound[slot_id] != req_id:
            # lazy (re)bind: a new occupant starts from an empty draft
            # cache and teacher-forces its whole prompt
            self._bound[slot_id] = req_id
            self._len[slot_id] = 0
        tables = self._eng._tables
        if budget is None:
            budget = int(self._eng._budgets[slot_id])
        # teacher-force what the draft cache is missing (the whole prompt
        # on a bind, the pending token in steady state) in m-wide
        # windows; the last window appends the k - 1 free-run steps
        while True:
            start = int(self._len[slot_id])
            rem = history[start:]
            if len(rem) + k - 1 <= self.m:
                outs = self._dispatch(slot_id, rem, k, budget, tables)
                return outs[len(rem) - 1:len(rem) - 1 + k].tolist()
            self._dispatch(slot_id, rem[:self.m], 0, budget, tables)

    def note_commit(self, slot_id, committed_len):
        # positions above the committed length hold rejected drafts; the
        # ones at or below it hold what the draft model fed or made for
        # tokens the target committed
        self._len[slot_id] = min(int(self._len[slot_id]),
                                 int(committed_len))

    def release(self, slot_id):
        self._bound[slot_id] = None
        self._len[slot_id] = 0


# ---------------------------------------------------------------------------
# smoke: `python -m paddle_tpu_torch.serving.speculative`
# ---------------------------------------------------------------------------

def _smoke_prompts(cfg, n, rng):
    """Repetitive prompts the n-gram drafter matches: a short random head
    and one phrase repeated three times (the JAX smoke's trace)."""
    phrase = rng.integers(1, cfg.vocab_size, (6,)).tolist()
    out = []
    for i in range(n):
        head = rng.integers(1, cfg.vocab_size, (2 + i % 3,)).tolist()
        out.append(head + phrase * 3)
    return out


def _smoke(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="speculative-decoding smoke: a small model serves a "
                    "repetitive trace with the n-gram drafter and with "
                    "speculation off; every request's tokens must match")
    parser.add_argument("--requests", type=int, default=6)
    parser.add_argument("--max-new", type=int, default=12)
    parser.add_argument("--spec-k", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from ..models import LlamaConfig, init_serving_params
    from .engine import ContinuousBatchingEngine

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # head_dim 64 for the kernels; f32 weights on the unified step
        # (its windows and decode take f32; the cold flash prefill is
        # bf16-only), where a window and a decode step differ only in f32
        # summation order, so token identity is a fair gate
        cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512)
        geometry = dict(block_size=16, prompt_bucket=16, token_budget=16,
                        unified_step=True)
    else:
        cfg = LlamaConfig.tiny()
        geometry = dict(block_size=8, prompt_bucket=8, unified_step=False)
    params = init_serving_params(cfg, seed=11, device=dev,
                                 dtype=torch.float32)
    rng = np.random.default_rng(7)
    prompts = _smoke_prompts(cfg, args.requests, rng)

    def serve(speculative):
        eng = ContinuousBatchingEngine(
            cfg, params, slots=2, max_prompt_len=64,
            max_new_tokens=args.max_new, steps_per_sync=3,
            speculative=speculative,
            spec_k=args.spec_k if speculative != "off" else None,
            dtype=torch.float32, device=dev, **geometry)
        # the traffic's prompt buckets, cold only (its heads differ: no
        # prompt hits the prefix cache)
        pb = eng.prompt_bucket
        eng.warm(buckets=sorted({-(-len(pr) // pb) * pb for pr in prompts}),
                 prefix_widths=[])
        stats = eng.compile_stats()
        for pr in prompts:
            eng.add_request(pr, max_new=args.max_new)
        eng.run(max_iters=2000)
        if eng.compile_stats() != stats:
            raise RuntimeError(f"traffic grew compile_stats {stats} -> "
                               f"{eng.compile_stats()}")
        toks = {r.req_id: list(r.tokens) for r in eng.finished}
        return toks, eng.metrics()

    base, _ = serve("off")
    spec, em = serve("ngram")
    matched = sum(1 for rid in base if spec.get(rid) == base[rid])
    row = {
        "bench": "speculative_smoke",
        "device": str(dev),
        "requests": args.requests,
        "spec_k": args.spec_k,
        "spec_steps": em["spec_steps"],
        "spec_drafted": em["spec_drafted"],
        "spec_accepted": em["spec_accepted"],
        "acceptance_rate": em["acceptance_rate"],
        "compile_stats": em["compile_stats"],
        "token_match": matched / max(len(base), 1),
        "ok": (matched == len(base) and em["spec_drafted"] > 0
               and em["spec_accepted"] > 0),
    }
    print(json.dumps(row))
    return 0 if row["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_smoke())
