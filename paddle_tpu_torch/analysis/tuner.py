"""The static autotuner: the memory and roofline passes as an objective
over the serving engine's build-time knobs (counterpart of
paddle_tpu/analysis/tuner.py).

- **search space**: the engine's build-time knobs, each an engine kwarg
  of the same name (but `quantized_collectives`, which the port's engine
  reads from an artifact and leaves unused on one device), so
  `TunedConfig.apply` is a plain dict merge: the KV
  page size (`block_size`, from the card's page rule,
  `models.llama.serving_block_size_candidates`), `kv_cache_dtype` (bf16 |
  int8 pools), `decode_megakernel` (off | attn | full | scan),
  `unified_step`, `token_budget` (the unified window), `speculative` /
  `spec_k`, and `serving_mp` / `serving_cp` / `quantized_collectives`,
  which stay 1 / 1 / off on one card (a caller's space that asks for a
  mesh has those candidates pruned by name: ROADMAP.md section 1 item 5).
- **feasibility gate** (`memory.py`, `device_specs.auto_hbm_budget`): a
  candidate whose static params + pool bytes already exceed the device
  row's budget is pruned before any trace, and one whose traced peak
  does is pruned after. The scan rung stacks every layer's weights anew
  while the caller's dict keeps the originals, so both gates count that
  copy at scan (the JAX tuner does not: its bound differs there).
- **objective** (`roofline.py`): the survivors rank by the decode chunk's
  predicted step time, then wire bytes per token (0.0 on one device: the
  communication pass waits for item 5), traced peak, and the canonical
  config string. The all-defaults config is always scored, so the winner
  never predicts slower than it. The roofline prices each hand-written
  kernel at the share of its bound it reaches on the device row
  (`DeviceSpec.kernel_shares`: the megakernels run at a quarter to a
  third of theirs on the H100, so a rung that fuses more is not ranked
  faster for its bytes alone); those shares are measured at the main
  path's shapes, so a page or width far from them is priced less
  surely.

Each candidate engine is built on fake tensors made from the caller's
parameters (`FakeTensorMode.from_tensor`): its pools, the scan rung's
stacked weights and its programs' inputs hold no device memory, and the
programs are traced (`torch.fx` over fakes), never run, so scoring
allocates nothing on the card and launches no kernel. A program's pass
results are kept by the knobs that shape it (`_program_key`), so
candidates that differ only in speculation, or in `token_budget` for the
decode chunk, share one trace. No RNG and no clock: the same inputs give
the same report.

The winner exports as a `TunedConfig` artifact
(``.paddle_tpu_tune.json``, the JAX package's schema and file name, so
artifacts cross between the packages) that
`ContinuousBatchingEngine(config=...)`, or FLAGS_tuned_config, applies at
build time.

CLI::

    python -m paddle_tpu_torch.analysis --tune [--device cpu-container]
        [--budget-candidates N] [--tune-out PATH] [--format json]
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import itertools
import json
import os
import warnings
from typing import Dict, List, Optional, Sequence

import torch

from .device_specs import DEFAULT_HBM_HEADROOM, auto_hbm_budget, get_spec

__all__ = [
    "KNOBS", "SCHEMA_VERSION", "TUNE_FILENAME", "CandidateResult",
    "TunedConfig", "TuningReport", "autotune", "baseline_config",
    "canonical_config", "default_space", "enumerate_candidates",
    "model_signature", "space_hash", "static_candidate_bound",
]

# the engine build-time knobs the tuner sweeps, each a
# ContinuousBatchingEngine kwarg of the same name
KNOBS = ("block_size", "decode_megakernel", "kv_cache_dtype",
         "quantized_collectives", "serving_cp", "serving_mp",
         "spec_k", "speculative", "token_budget", "unified_step")

SCHEMA_VERSION = 1
TUNE_FILENAME = ".paddle_tpu_tune.json"

_MESH_UNPORTED = ("the port's engine serves one device and refuses a "
                  "serving mesh (ROADMAP.md section 1 item 5)")


def model_signature(cfg) -> str:
    """Shape identity of a model config: what a TunedConfig is valid for.
    Every field that changes a traced program's shapes takes part; the
    weights' dtype does not."""
    return ("llama:h{hidden}:l{layers}:q{q}:kv{kv}:d{dh}"
            ":i{inter}:v{vocab}").format(
        hidden=cfg.hidden_size, layers=cfg.num_hidden_layers,
        q=cfg.num_attention_heads, kv=cfg.num_key_value_heads,
        dh=cfg.head_dim, inter=cfg.intermediate_size,
        vocab=cfg.vocab_size)


def space_hash(space: Dict[str, Sequence]) -> str:
    """Hash of the searched space: an artifact tuned over one space is
    stale against another."""
    blob = json.dumps({k: list(v) for k, v in sorted(space.items())},
                      sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _engine_geometry(engine_kwargs: dict) -> dict:
    """The engine sizing the tuner holds fixed, with the engine's own
    defaults filled in."""
    kw = dict(engine_kwargs or {})
    out = {
        "slots": int(kw.get("slots", 8)),
        "prompt_bucket": int(kw.get("prompt_bucket", 64)),
        "max_prompt_len": int(kw.get("max_prompt_len", 512)),
        "max_new_tokens": int(kw.get("max_new_tokens", 64)),
        "steps_per_sync": int(kw.get("steps_per_sync", 8)),
        "block_size": int(kw.get("block_size") or 64),
        "max_pages": kw.get("max_pages"),
        "kv_pool_bytes": kw.get("kv_pool_bytes"),
    }
    out["max_prompt_len"] = -(-out["max_prompt_len"]
                              // out["prompt_bucket"]) \
        * out["prompt_bucket"]
    return out


def baseline_config(cfg, engine_kwargs: Optional[dict] = None) -> dict:
    """The all-defaults candidate: every knob resolved as a plain
    `ContinuousBatchingEngine(cfg, params, **engine_kwargs)` build would
    (explicit kwargs, then the flags). Under unified_step 'auto' that is
    the split path, where the JAX package turns the unified step on off
    its TPU."""
    from ..models.llama import (resolve_decode_megakernel,
                                resolve_kv_cache_dtype,
                                resolve_quantized_collectives,
                                resolve_serving_cp, resolve_serving_mp,
                                resolve_unified_step)
    from ..serving.speculative import resolve_spec_k, resolve_speculative

    kw = dict(engine_kwargs or {})
    geo = _engine_geometry(kw)
    speculative = resolve_speculative(kw.get("speculative"))
    config = {
        "block_size": geo["block_size"],
        "decode_megakernel": resolve_decode_megakernel(
            kw.get("decode_megakernel")),
        "kv_cache_dtype": resolve_kv_cache_dtype(
            kw.get("kv_cache_dtype")),
        "quantized_collectives": resolve_quantized_collectives(
            kw.get("quantized_collectives")),
        "serving_cp": resolve_serving_cp(kw.get("serving_cp")),
        "serving_mp": resolve_serving_mp(kw.get("serving_mp")),
        "spec_k": (resolve_spec_k(kw.get("spec_k"))
                   if speculative != "off" else 0),
        "speculative": speculative,
        "token_budget": int(kw.get("token_budget")
                            or geo["prompt_bucket"]),
        "unified_step": resolve_unified_step(kw.get("unified_step")),
    }
    return canonical_config(config, geo)


def canonical_config(config: dict, geo: dict) -> dict:
    """Collapse knob combinations that build the same programs, so no
    program is scored twice under two names: `quantized_collectives`
    means nothing at mp = cp = 1, `token_budget` nothing on the split
    path, `spec_k` nothing with speculation off; full / scan fuse the MLP
    past the tensor-parallel seam, so under a mesh they serve as attn;
    speculation does not compose with page-sharded pools; an int4 pool
    (the JAX package's) has no megakernel rung. The JAX package's rules,
    so artifacts of the two packages name the same programs alike."""
    from ..models.llama import resolve_decode_megakernel

    out = dict(config)
    out["decode_megakernel"] = resolve_decode_megakernel(
        out.get("decode_megakernel", "off"))
    if (out.get("serving_cp", 1) > 1 or out["serving_mp"] > 1) \
            and out["decode_megakernel"] in ("full", "scan"):
        out["decode_megakernel"] = "attn"
    if out.get("kv_cache_dtype") == "int4":
        out["decode_megakernel"] = "off"
    if out["serving_mp"] == 1 and out.get("serving_cp", 1) == 1:
        out["quantized_collectives"] = False
    if not out["unified_step"]:
        out["token_budget"] = geo["prompt_bucket"]
    if out.get("serving_cp", 1) > 1:
        out["speculative"] = "off"
    if out.get("speculative", "off") == "off":
        out["spec_k"] = 0
    return out


def default_space(cfg, engine_kwargs: Optional[dict] = None) -> dict:
    """The default search space for one model and engine geometry, knob
    -> candidate values: pages from the card's page rule (and the
    geometry's own), every megakernel rung, both pool dtypes, the split
    and unified paths with the window at one and two prompt buckets, the
    n-gram drafter at two depths, and mesh degrees the host's cards
    (`torch.cuda.device_count()`, 1 on the CPU) and the model's kv heads
    admit, which on one card is [1]."""
    from ..models.llama import serving_block_size_candidates

    geo = _engine_geometry(engine_kwargs)
    blocks = sorted(set(
        serving_block_size_candidates(
            cfg, prompt_bucket=geo["prompt_bucket"])
        + [geo["block_size"]]))
    n_dev = max(1, torch.cuda.device_count())
    nkv = cfg.num_key_value_heads
    mps = [m for m in (1, 2, 4, 8)
           if m <= n_dev and (m == 1 or nkv % m == 0)]
    cps = [c for c in (1, 2, 4, 8)
           if c <= n_dev and (geo["max_pages"] is None
                              or int(geo["max_pages"]) % c == 0)]
    tb = geo["prompt_bucket"]
    return {
        "block_size": blocks,
        "decode_megakernel": ["off", "attn", "full", "scan"],
        "kv_cache_dtype": ["bf16", "int8"],
        "quantized_collectives": [False, True],
        "serving_cp": cps,
        "serving_mp": mps,
        "spec_k": [4, 8],
        "speculative": ["off", "ngram"],
        "token_budget": sorted({tb, 2 * tb}),
        "unified_step": [False, True],
    }


def enumerate_candidates(space: dict, geo: dict) -> List[dict]:
    """The product of the space in knob-name order, canonicalized and
    deduplicated (first occurrence wins)."""
    names = sorted(space)
    seen, out = set(), []
    for values in itertools.product(*(space[k] for k in names)):
        config = canonical_config(dict(zip(names, values)), geo)
        key = _config_key(config)
        if key in seen:
            continue
        seen.add(key)
        out.append(config)
    return out


def _config_key(config: dict) -> str:
    return json.dumps(config, sort_keys=True, default=str)


def _stacked_copy_bytes(cfg, params) -> int:
    """Bytes of the per-layer weights the scan rung stacks anew
    (`stack_decode_layer_params`); the caller's dict keeps its own."""
    from ..models.llama import STACKED_LAYER_NAMES
    from .memory import pytree_local_bytes

    return pytree_local_bytes(
        [params[f"llama.layers.{i}.{name}"]
         for i in range(cfg.num_hidden_layers)
         for name in STACKED_LAYER_NAMES])


def static_candidate_bound(cfg, params, config: dict,
                           engine_kwargs: Optional[dict] = None) -> int:
    """A cheap lower bound of one candidate's device bytes, with no
    engine built: the params, the KV pool the engine would allocate
    (`PagedKVManager.page_bytes`), and at the scan rung the stacked copy
    of the layer weights (the JAX bound leaves that copy out). A scan
    request the card steps down counts the copy all the same; its
    stepped-down program is scored under its own rung."""
    from ..models.llama import PagedKVManager
    from .memory import pytree_local_bytes

    geo = _engine_geometry(engine_kwargs)
    bs = int(config["block_size"])
    mp = int(config["serving_mp"])
    cp = int(config.get("serving_cp", 1))
    nkv = cfg.num_key_value_heads
    if geo["kv_pool_bytes"] is not None:
        pool_bytes = int(geo["kv_pool_bytes"])
    else:
        # the engine's own sizing: every slot full-length, plus the
        # scratch page
        cap = -(-(geo["max_prompt_len"] + geo["max_new_tokens"]) // bs)
        fleet = geo["max_pages"] or -(-(geo["slots"] * cap + 1)
                                      // cp) * cp
        kv_shards = mp if (mp > 1 and nkv % mp == 0) else 1
        pool_bytes = (fleet // cp) * PagedKVManager.page_bytes(
            bs, n_layers=cfg.num_hidden_layers, num_kv_heads=nkv,
            head_dim=cfg.head_dim,
            kv_cache_dtype=config["kv_cache_dtype"], mp=kv_shards)
    stacked = _stacked_copy_bytes(cfg, params) \
        if config["decode_megakernel"] == "scan" else 0
    return pytree_local_bytes(params) + pool_bytes + stacked


@dataclasses.dataclass
class CandidateResult:
    """One scored (or pruned) point of the search space."""

    config: dict
    feasible: bool
    static_bound_bytes: int
    pruned_reason: Optional[str] = None
    peak_hbm_bytes: Optional[int] = None
    predicted_step_ms: Optional[float] = None
    predicted_ms_per_token: Optional[float] = None
    predicted_mfu: Optional[float] = None
    predicted_wire_bytes_per_token: Optional[float] = None
    bound: Optional[str] = None
    n_programs: int = 0

    def sort_key(self):
        """Ascending is better: predicted decode step time, wire bytes per
        token, traced peak, then the canonical config string."""
        return (self.predicted_step_ms or 0.0,
                self.predicted_wire_bytes_per_token or 0.0,
                self.peak_hbm_bytes or 0,
                _config_key(self.config))

    def to_dict(self) -> dict:
        out = {"config": dict(self.config), "feasible": self.feasible,
               "static_bound_bytes": self.static_bound_bytes}
        if self.feasible:
            out.update({
                "peak_hbm_bytes": self.peak_hbm_bytes,
                "predicted_step_ms": self.predicted_step_ms,
                "predicted_ms_per_token": self.predicted_ms_per_token,
                "predicted_mfu": self.predicted_mfu,
                "predicted_wire_bytes_per_token":
                    self.predicted_wire_bytes_per_token,
                "bound": self.bound,
                "n_programs": self.n_programs,
            })
        else:
            out["pruned_reason"] = self.pruned_reason
        return out


@dataclasses.dataclass
class TunedConfig:
    """The persisted winner: engine knobs, the identity they were tuned
    against (device row, model shape, searched space) and the passes'
    predictions for them."""

    knobs: dict
    device: str
    model: str
    space_hash: str
    predicted: dict = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "device": self.device,
            "model": self.model,
            "space_hash": self.space_hash,
            "knobs": dict(self.knobs),
            "predicted": dict(self.predicted),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        return cls(knobs=dict(d["knobs"]), device=d["device"],
                   model=d["model"], space_hash=d["space_hash"],
                   predicted=dict(d.get("predicted", {})),
                   schema_version=int(d.get("schema_version", -1)))

    def save(self, path: str) -> str:
        """Write the artifact (a directory gets ``.paddle_tpu_tune.json``
        inside it), through a rename, so a crashed writer never leaves a
        half-written artifact."""
        if os.path.isdir(path):
            path = os.path.join(path, TUNE_FILENAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True, indent=2)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "TunedConfig":
        if os.path.isdir(path):
            path = os.path.join(path, TUNE_FILENAME)
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def stale_reason(self, cfg=None, device=None,
                     space: Optional[dict] = None) -> Optional[str]:
        """None when the artifact is valid for this (model, device row,
        space), else why it is stale. Each check but the schema version's
        is opt-in through its argument."""
        if self.schema_version != SCHEMA_VERSION:
            return (f"schema_version {self.schema_version} != "
                    f"{SCHEMA_VERSION}")
        if cfg is not None and model_signature(cfg) != self.model:
            return (f"model signature {model_signature(cfg)!r} != "
                    f"tuned {self.model!r}")
        if device is not None and get_spec(device).name != self.device:
            return (f"device row {get_spec(device).name!r} != "
                    f"tuned {self.device!r}")
        if space is not None and space_hash(space) != self.space_hash:
            return (f"flag-space hash {space_hash(space)} != "
                    f"tuned {self.space_hash}")
        return None

    def apply(self, engine_kwargs: dict) -> dict:
        """Merge the tuned knobs into engine kwargs: an explicit caller
        value wins, None counts as unset."""
        out = dict(engine_kwargs)
        for k, v in self.knobs.items():
            if out.get(k) is None:
                out[k] = v
        return out


@dataclasses.dataclass
class TuningReport:
    """Ranked outcome of one `autotune` run (`to_dict` / `to_json` are the
    CLI's ``--format json`` schema, the JAX package's)."""

    device: str
    model: str
    space: dict
    hbm_budget_bytes: int
    ranking: List[CandidateResult]
    pruned: List[CandidateResult]
    baseline: CandidateResult
    n_candidates: int
    engine_geometry: dict

    @property
    def best(self) -> CandidateResult:
        if not self.ranking:
            raise RuntimeError(
                "no feasible candidate: every config in the space "
                f"exceeded the {self.hbm_budget_bytes} B budget")
        return self.ranking[0]

    @property
    def n_pruned(self) -> int:
        return len(self.pruned)

    @property
    def space_hash(self) -> str:
        return space_hash(self.space)

    def tuned_config(self) -> TunedConfig:
        best = self.best
        return TunedConfig(
            knobs=dict(best.config), device=self.device,
            model=self.model, space_hash=self.space_hash,
            predicted={
                "step_ms": best.predicted_step_ms,
                "ms_per_token": best.predicted_ms_per_token,
                "mfu": best.predicted_mfu,
                "wire_bytes_per_token":
                    best.predicted_wire_bytes_per_token,
                "peak_hbm_bytes": best.peak_hbm_bytes,
            })

    def to_dict(self, top_k: int = 8) -> dict:
        base = self.baseline
        best = self.ranking[0] if self.ranking else None
        speedup = None
        if best is not None and base.feasible \
                and best.predicted_step_ms:
            speedup = round(base.predicted_step_ms
                            / best.predicted_step_ms, 4)
        return {
            "device": self.device,
            "model": self.model,
            "space": {k: list(v) for k, v in sorted(self.space.items())},
            "space_hash": self.space_hash,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "engine_geometry": dict(self.engine_geometry),
            "n_candidates": self.n_candidates,
            "n_feasible": len(self.ranking),
            "n_pruned": self.n_pruned,
            "ranking": [c.to_dict() for c in self.ranking[:top_k]],
            "pruned": [c.to_dict() for c in self.pruned],
            "baseline": base.to_dict(),
            "best": best.to_dict() if best is not None else None,
            "predicted_speedup_vs_default": speedup,
        }

    def to_json(self, top_k: int = 8) -> str:
        return json.dumps(self.to_dict(top_k), sort_keys=True, indent=2)

    def format(self, top_k: int = 8) -> str:
        lines = [
            f"autotune: {self.model} on {self.device} "
            f"(budget {self.hbm_budget_bytes / (1 << 20):.1f} MiB)",
            f"  candidates: {self.n_candidates}  feasible: "
            f"{len(self.ranking)}  pruned: {self.n_pruned}",
        ]
        for i, c in enumerate(self.ranking[:top_k]):
            mark = " <- best" if i == 0 else ""
            lines.append(
                f"  #{i + 1} {c.predicted_step_ms:.4f} ms/step  "
                f"mfu={c.predicted_mfu:.4f}  "
                f"wire/tok={c.predicted_wire_bytes_per_token:.0f}B  "
                f"peak={c.peak_hbm_bytes / (1 << 20):.2f} MiB  "
                f"{_config_key(c.config)}{mark}")
        for c in self.pruned:
            lines.append(f"  pruned {_config_key(c.config)}: "
                         f"{c.pruned_reason}")
        if self.ranking:
            base = self.baseline
            if base.feasible and base.predicted_step_ms:
                lines.append(
                    f"  baseline (all defaults): "
                    f"{base.predicted_step_ms:.4f} ms/step -> best is "
                    f"{base.predicted_step_ms / self.best.predicted_step_ms:.2f}x")
        return "\n".join(lines)


# the knobs that shape each scored program: the decode chunk by the
# page, rung, pool dtype and mesh; the unified window by those and its
# width. Speculation shapes neither (its verify window is not scored),
# `unified_step` and `token_budget` not the decode chunk
_SHAPED_BY = {
    "decode": ("block_size", "decode_megakernel", "kv_cache_dtype",
               "quantized_collectives", "serving_cp", "serving_mp"),
}
_SHAPED_BY["unified"] = _SHAPED_BY["decode"] + ("token_budget",)


def _program_key(program: str, config: dict) -> tuple:
    """The memo key of one program's pass results (the graph itself is
    dropped once its passes ran)."""
    return (program,) + tuple(config[k] for k in _SHAPED_BY[program])


def _fake_engine(cfg, params, engine_kwargs: dict):
    """A candidate engine built on fakes of the caller's params: pools,
    stacked weights and program inputs hold no memory (the rung planner's
    warnings are the served build's business, not the tuner's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    from ..serving import ContinuousBatchingEngine

    mode = FakeTensorMode(allow_non_fake_inputs=True, shape_env=ShapeEnv(),
                          static_shapes=True)

    def fake(v):
        if isinstance(v, tuple):
            return tuple(fake(x) for x in v)
        return mode.from_tensor(v)

    fakes = {name: fake(w) for name, w in params.items()}
    with mode, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ContinuousBatchingEngine(cfg, fakes, **engine_kwargs)


def _score_candidate(cfg, params, config, engine_kwargs, spec, budget,
                     static_bound, memo: dict) -> CandidateResult:
    """Trace the candidate's steady-state programs once each (the decode
    chunk, and the unified window where built) on a fake engine, gate the
    traced peak against the budget, and price the decode chunk with the
    roofline pass."""
    from . import memory as _mem
    from . import roofline as _roof

    geo = _engine_geometry(engine_kwargs)
    # the engine takes no quantized_collectives (nothing to quantize on
    # one device)
    kw = {k: v for k, v in {**(engine_kwargs or {}), **config}.items()
          if k != "quantized_collectives"}
    kw.setdefault("device", params["llama.embed_tokens.weight"].device)
    progs = ["decode"] + (["unified"] if config["unified_step"] else [])
    keys = {name: _program_key(name, config) for name in progs}
    results = {name: memo.get(keys[name]) for name in progs}
    missing = [name for name in progs if results[name] is None]
    if missing:
        eng = _fake_engine(cfg, params, kw)
        # at scan the caller's per-layer weights stay beside the stack
        extra = _stacked_copy_bytes(cfg, params) \
            if eng.megakernel_rung == "scan" else 0
        for name, graph in eng._traced_inventory(programs=missing):
            res = {"peak": _mem.audit_graph(graph).peak_bytes + extra}
            if name == "decode":
                roof = _roof.audit_graph(graph, spec)
                res.update(step_ms=roof.predicted_step_ms,
                           mfu=roof.predicted_mfu, bound=roof.bound)
            results[name] = memo[keys[name]] = res
    peak = max(res["peak"] for res in results.values())
    if peak > budget:
        return CandidateResult(
            config=config, feasible=False,
            static_bound_bytes=static_bound, peak_hbm_bytes=peak,
            pruned_reason=(
                f"traced per-chip peak {peak} B exceeds the "
                f"{budget} B budget"))
    dec = results["decode"]
    tokens = max(geo["steps_per_sync"] * geo["slots"], 1)
    return CandidateResult(
        config=config, feasible=True,
        static_bound_bytes=static_bound, peak_hbm_bytes=peak,
        predicted_step_ms=dec["step_ms"],
        predicted_ms_per_token=dec["step_ms"] / tokens,
        predicted_mfu=dec["mfu"],
        # no wire on one device: the communication pass waits for
        # ROADMAP.md section 1 item 5; the key keeps the JAX schema
        predicted_wire_bytes_per_token=0.0,
        bound=dec["bound"], n_programs=len(results))


def autotune(cfg, params, *, engine_kwargs: Optional[dict] = None,
             device=None, hbm_budget_bytes=None,
             headroom: float = DEFAULT_HBM_HEADROOM,
             space: Optional[dict] = None,
             budget_candidates: Optional[int] = None) -> TuningReport:
    """Enumerate, gate, score, rank; deterministic end to end.

    `params` is the decode-params dict the engine would be built with;
    it is read for its shapes only (fakes are made from it).
    `engine_kwargs` is the fixed engine geometry (slots, buckets,
    steps_per_sync, dtype, device: by default the params'); a knob inside
    it pins that knob's baseline, but the space still sweeps it unless
    `space` says otherwise. `device` names the device row the roofline
    prices against (None: the card's row, else the H100's).
    `hbm_budget_bytes` overrides the budget (default: the row's memory
    less `headroom`): bytes, or a function of the all-defaults baseline's
    `CandidateResult` (scored first without a budget; its programs are
    traced once). `budget_candidates` scores at most that many
    candidates in enumeration order, and the all-defaults baseline
    besides."""
    spec = get_spec(device)
    geo = _engine_geometry(engine_kwargs)
    if space is None:
        space = default_space(cfg, engine_kwargs)
    base_cfg = baseline_config(cfg, engine_kwargs)
    # the baseline is scored even when the caller's space leaves out one
    # of its values (appended, so the caller's order stands)
    space = {k: (list(v) if base_cfg[k] in v
                 else list(v) + [base_cfg[k]])
             for k, v in space.items()}
    memo = {}
    if callable(hbm_budget_bytes):
        budget = int(hbm_budget_bytes(_score_candidate(
            cfg, params, base_cfg, engine_kwargs, spec, float("inf"),
            static_candidate_bound(cfg, params, base_cfg, engine_kwargs),
            memo)))
    elif hbm_budget_bytes is not None:
        budget = int(hbm_budget_bytes)
    else:
        budget = auto_hbm_budget(spec, headroom=headroom)
    candidates = enumerate_candidates(space, geo)
    if budget_candidates is not None and budget_candidates > 0:
        kept = candidates[:int(budget_candidates)]
        if base_cfg not in kept:
            kept.append(base_cfg)
        candidates = kept
    ranking, pruned = [], []
    baseline_result = None
    for config in candidates:
        bound = static_candidate_bound(cfg, params, config,
                                       engine_kwargs)
        mp = int(config["serving_mp"])
        cp = int(config.get("serving_cp", 1))
        if mp > 1 or cp > 1:
            # named, never built: the engine would raise
            res = CandidateResult(
                config=config, feasible=False, static_bound_bytes=bound,
                pruned_reason=f"serving_mp={mp}, serving_cp={cp}: "
                              f"{_MESH_UNPORTED}")
        elif bound > budget:
            res = CandidateResult(
                config=config, feasible=False,
                static_bound_bytes=bound,
                pruned_reason=(
                    f"static params+pool bound {bound} B exceeds the "
                    f"{budget} B budget (pruned before tracing)"))
        else:
            res = _score_candidate(cfg, params, config, engine_kwargs,
                                   spec, budget, bound, memo)
        (ranking if res.feasible else pruned).append(res)
        if config == base_cfg:
            baseline_result = res
    # the candidate engines and their traces sit in reference cycles
    gc.collect()
    ranking.sort(key=CandidateResult.sort_key)
    assert baseline_result is not None  # always enumerated above
    return TuningReport(
        device=spec.name, model=model_signature(cfg), space=space,
        hbm_budget_bytes=budget, ranking=ranking, pruned=pruned,
        baseline=baseline_result, n_candidates=len(candidates),
        engine_geometry=geo)
