"""Global runtime flag registry of the PyTorch port.

Same contract as the JAX package's registry (``paddle_tpu/framework/
flags.py``): flags are plain Python values registered with a default,
overridable from the environment (``FLAGS_<name>``, or the first set
environment alias) and via ``set_flags``. The port keeps its own copy so
it never imports the JAX package. Only the flags the port reads are
registered, with the JAX package's names, defaults and environment
aliases.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def define_flag(name: str, default, doc: str = "", env_aliases=()):
    """Register a flag; `env_aliases` are extra environment variable
    names honoured besides FLAGS_<name> (first set one wins)."""
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    env = os.environ.get(name)
    for alias in env_aliases:
        if env is not None:
            break
        env = os.environ.get(alias)
    _REGISTRY[name] = _coerce(default, env) if env is not None else default
    return _REGISTRY[name]


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if not k.startswith("FLAGS_"):
            k = "FLAGS_" + k
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k}; known: {sorted(_REGISTRY)}")
        _REGISTRY[k] = v


def get_flags(flags=None) -> Dict[str, Any]:
    if flags is None:
        return dict(_REGISTRY)
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        if not k.startswith("FLAGS_"):
            k = "FLAGS_" + k
        out[k] = _REGISTRY[k]
    return out


def flag(name: str):
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    return _REGISTRY[name]


# --- serving flags read by the port's engine ---
define_flag("prefix_prefill_kernel", True,
            "serve cached-prefix suffix prefills through the ragged "
            "paged prefix-prefill kernel. Mirrors the JAX registry; the "
            "port has no jnp fallback to switch to, so its CUDA path "
            "always launches the kernel "
            "(also: PADDLE_TPU_PREFIX_PREFILL_KERNEL)",
            env_aliases=("PADDLE_TPU_PREFIX_PREFILL_KERNEL",))
define_flag("kv_cache_dtype", "bf16",
            "element type of the paged serving KV pools: 'bf16' "
            "(default) or 'int8' (int8 pools with per-(page, kv head) f32 "
            "absmax scales, attended by the int8 paged-attention "
            "kernels). Read when an engine is BUILT "
            "(also: PADDLE_TPU_KV_CACHE_DTYPE)",
            env_aliases=("PADDLE_TPU_KV_CACHE_DTYPE",))
define_flag("decode_megakernel", "off",
            "fusion rung of the paged decode step "
            "(kernels/decode_megakernel.py), a ladder: 'off' (default) "
            "= the multi-kernel oracle path; 'attn' = rms + QKV + "
            "rotary + paged attention + in-kernel KV commit + o-proj "
            "in ONE kernel launch per layer; 'full' = 'attn' plus the "
            "MLP half (post-attention rms + gate/up + silu*mul + down "
            "+ residual) fused into the same per-layer launch; 'scan' = "
            "the whole decode step as ONE kernel launch that walks "
            "every layer over stacked weights and "
            "stacked K/V pools. Legacy booleans map onto the ladder "
            "(False/'0' -> off, True/'1' -> attn). Unsupported shapes "
            "fall back one rung at a time with a build-time warning. "
            "Read when a paged program / engine is BUILT (the rung "
            "joins every program key), so flip it before constructing "
            "(or warming) an engine "
            "(also: PADDLE_TPU_DECODE_MEGAKERNEL)",
            env_aliases=("PADDLE_TPU_DECODE_MEGAKERNEL",))
define_flag("unified_step", "auto",
            "serve mixed prefill+decode through the unified ragged step; "
            "'auto' (default) resolves to the split path in the port, "
            "'1'/'0' force "
            "(also: PADDLE_TPU_UNIFIED_STEP)",
            env_aliases=("PADDLE_TPU_UNIFIED_STEP",))
define_flag("serving_mp", 1,
            "tensor-parallel degree of the paged serving stack; 1 "
            "(default) = one device; above 1 the engine runs on every "
            "rank of a process group of serving_mp * serving_cp ranks "
            "(parallel/ranks.py) (also: PADDLE_TPU_SERVING_MP)",
            env_aliases=("PADDLE_TPU_SERVING_MP",))
define_flag("serving_cp", 1,
            "context-parallel degree of the paged serving stack (pools "
            "sharded by page); 1 (default) = one device "
            "(also: PADDLE_TPU_SERVING_CP)",
            env_aliases=("PADDLE_TPU_SERVING_CP",))
define_flag("speculative", "off",
            "speculative decoding policy of the serving engine "
            "(serving/speculative.py): 'off' (default) | 'ngram' | "
            "'draft'. Read when an engine is BUILT "
            "(also: PADDLE_TPU_SPECULATIVE)",
            env_aliases=("PADDLE_TPU_SPECULATIVE",))
define_flag("spec_k", 4,
            "tokens drafted per slot per speculative step (the verify "
            "window is spec_k+1 rows). Read when an engine is BUILT "
            "(also: PADDLE_TPU_SPEC_K)",
            env_aliases=("PADDLE_TPU_SPEC_K",))
define_flag("spec_adaptive", False,
            "acceptance-adaptive speculative draft depth: a host policy "
            "(serving/speculative.py AdaptiveSpecPolicy) that shrinks the "
            "depth the drafter is asked for while drafts miss and grows "
            "it back toward spec_k; the verify window keeps spec_k+1 rows "
            "(also: PADDLE_TPU_SPEC_ADAPTIVE)",
            env_aliases=("PADDLE_TPU_SPEC_ADAPTIVE",))

define_flag("fleet_heartbeat_s", 0.25,
            "decode-fleet worker heartbeat interval in seconds "
            "(serving/fleet.py): each worker renews a TTL lease in the "
            "fleet store every interval; a lease older than 4x the "
            "interval marks the worker dead and triggers fencing + "
            "in-flight request recovery "
            "(also: PADDLE_TPU_FLEET_HEARTBEAT_S)",
            env_aliases=("PADDLE_TPU_FLEET_HEARTBEAT_S",))
define_flag("router_max_queue", 64,
            "SLO router queue-depth bound (serving/router.py): the "
            "admission cap for LOW-priority requests; normal gets 2x, "
            "high 4x. Beyond its class cap a request is shed with a "
            "structured Rejected(reason='overloaded', retry_after_s) "
            "instead of growing an unbounded backlog "
            "(also: PADDLE_TPU_ROUTER_MAX_QUEUE)",
            env_aliases=("PADDLE_TPU_ROUTER_MAX_QUEUE",))

# --- observability (paddle_tpu_torch.observability) ---
define_flag("trace", "",
            "host span tracing: a non-empty value arms the global "
            "observability tracer and is the chrome-trace/Perfetto "
            "JSON export path (written at exit, or via "
            "observability.trace.export_global()). Empty (default) = "
            "off with a no-allocation fast path "
            "(also: PADDLE_TPU_TRACE)",
            env_aliases=("PADDLE_TPU_TRACE",))
define_flag("metrics", False,
            "arm the global observability metrics registry (TTFT / "
            "TPOT / queue-wait / chunk-time histograms, resilience "
            "event log; snapshot()/emit_jsonl()/prometheus_text()). "
            "Off (default) = a single is-None check per site "
            "(also: PADDLE_TPU_METRICS)",
            env_aliases=("PADDLE_TPU_METRICS",))

# --- resilience (paddle_tpu_torch.resilience) ---
define_flag("tpu_chaos", "",
            "fault-injection spec, e.g. 'io_error:0.1,preempt_at:200,"
            "hang:decode' (also: PADDLE_TPU_CHAOS; see resilience/chaos.py)",
            env_aliases=("PADDLE_TPU_CHAOS",))
define_flag("tpu_chaos_seed", 0,
            "seed of the deterministic chaos schedule "
            "(also: PADDLE_TPU_CHAOS_SEED)",
            env_aliases=("PADDLE_TPU_CHAOS_SEED",))
define_flag("io_retry_attempts", 3,
            "attempts for transient-IOError retry at the io seams "
            "(shard reads); 1 disables retrying "
            "(also: PADDLE_TPU_IO_RETRIES)",
            env_aliases=("PADDLE_TPU_IO_RETRIES",))
define_flag("io_retry_base_delay_s", 0.05,
            "first backoff delay of the io RetryPolicy (doubles per "
            "retry, jittered)")
define_flag("step_timeout_s", 0.0,
            "default wall-clock watchdog deadline per serving-engine "
            "step; 0 disables (also: PADDLE_TPU_STEP_TIMEOUT_S)",
            env_aliases=("PADDLE_TPU_STEP_TIMEOUT_S",))
define_flag("barrier_timeout_s", 60.0,
            "default deadline of a gang coordination barrier "
            "(resilience/coordination.py): how long a host waits for "
            "its peers at a checkpoint stage/commit or generation "
            "agreement before raising a structured BarrierTimeout "
            "naming the missing ranks (also: "
            "PADDLE_TPU_BARRIER_TIMEOUT_S)",
            env_aliases=("PADDLE_TPU_BARRIER_TIMEOUT_S",))

# --- the wire: serving seams and the dp gradient sync ---
define_flag("quantized_collectives", False,
            "ship the hot cross-chip payloads as absmax-scaled int8 "
            "with an f32 scale sidecar (parallel/collectives.py, "
            "EQuARX-style — the int8 KV pools' proven scheme): the "
            "per-layer o-proj activation all-gather at serving_mp > 1 "
            "(and the megakernel path's partial-sum psum), and the dp "
            "gradient sum in Model.fit (quantized_psum_tree: an "
            "all_to_all of int8 chunks + f32 dequant-accumulate + "
            "all-gather). ~0.5x the "
            "bf16 wire bytes, ~0.25x f32. Off (default) = every wire "
            "byte-identical to today. Read at program-BUILD time like "
            "every serving flag (it joins the jit program keys; "
            "warm() covers it), so flip it before constructing (or "
            "warming) an engine or calling fit "
            "(also: PADDLE_TPU_QUANTIZED_COLLECTIVES)",
            env_aliases=("PADDLE_TPU_QUANTIZED_COLLECTIVES",))
define_flag("tpu_lint", False,
            "run the lint pipeline (analysis/: rules over the torch.fx "
            "graph of a program, traced on fake tensors) at the audit "
            "hooks; it implies the memory and roofline audits "
            "(also: PADDLE_TPU_LINT=1)", env_aliases=("PADDLE_TPU_LINT",))
define_flag("audit_memory", False,
            "run the static memory auditor (analysis/memory.py: "
            "liveness over the program's torch.fx graph -> peak device "
            "memory + in-place analysis) at the audit hooks — "
            "ContinuousBatchingEngine.warm() over every program and "
            "Model.fit over the training step. PADDLE_TPU_LINT=1 "
            "implies it (the hooks compose with the lint switch) "
            "(also: PADDLE_TPU_AUDIT_MEMORY)",
            env_aliases=("PADDLE_TPU_AUDIT_MEMORY",))
define_flag("audit_comms", False,
            "run the static communication auditor (analysis/comms.py: "
            "bytes on wire per rank from the collective operators' "
            "nodes, TPU801-803) at the audit hooks — "
            "ContinuousBatchingEngine.warm() over every program and "
            "Model.fit over the training step. PADDLE_TPU_LINT=1 "
            "implies it (also: PADDLE_TPU_AUDIT_COMMS)",
            env_aliases=("PADDLE_TPU_AUDIT_COMMS",))
define_flag("audit_roofline", False,
            "run the static roofline auditor (analysis/roofline.py: "
            "FLOPs / HBM bytes of the program's torch.fx graph against "
            "the device-spec table -> predicted step latency, bound "
            "class, MFU) at the audit hooks — "
            "ContinuousBatchingEngine.warm() over every program and "
            "Model.fit over the training step. PADDLE_TPU_LINT=1 "
            "implies it (the hooks compose with the lint switch) "
            "(also: PADDLE_TPU_AUDIT_ROOFLINE)",
            env_aliases=("PADDLE_TPU_AUDIT_ROOFLINE",))

# --- the static autotuner's artifact and the kernel build cache ---
define_flag("compile_cache", "",
            "directory the hand-written CUDA kernels are built into and "
            "loaded from (kernels/_build.py: one nvcc per csrc/*.cu "
            "source, keyed by a hash of the sources and flags), in "
            "place of paddle_tpu_torch/_build/: a fleet restart or a "
            "new worker process whose directory already holds the "
            "libraries builds nothing (warm_compile_stats in "
            "engine.metrics() counts the libraries requested, found "
            "built and built by nvcc). Read when the first kernel of a "
            "process is loaded. Empty (default) = paddle_tpu_torch/"
            "_build/ (also: PADDLE_TPU_COMPILE_CACHE)",
            env_aliases=("PADDLE_TPU_COMPILE_CACHE",))
define_flag("tuned_config", "",
            "path of a persisted TunedConfig artifact "
            "(analysis/tuner.py, .paddle_tpu_tune.json; a directory "
            "means <dir>/.paddle_tpu_tune.json): non-empty makes "
            "ContinuousBatchingEngine default its build-time knobs "
            "(kv_cache_dtype, decode_megakernel, unified_step, "
            "token_budget, block_size, speculative, spec_k; "
            "serving_mp / serving_cp / quantized_collectives, from the "
            "degrees the host's cards build) from the autotuner's winner, ranked by the "
            "H100 roofline with each kernel priced at the share of its "
            "bound it reaches on the card at the main path's shapes "
            "(check a winner far from those on the card); explicit "
            "engine kwargs still win per knob. "
            "A stale (schema / model mismatch) or unreadable artifact "
            "is ignored with a warning. Empty (default) = off "
            "(also: PADDLE_TPU_TUNED_CONFIG)",
            env_aliases=("PADDLE_TPU_TUNED_CONFIG",))
