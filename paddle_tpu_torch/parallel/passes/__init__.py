"""paddle.distributed.passes on the port (counterpart of
paddle_tpu/parallel/passes/__init__.py; reference:
python/paddle/distributed/passes/pass_base.py — PassBase / PassManager /
new_pass / register_pass, plus the auto-parallel pass zoo: amp,
recompute, sharding, gradient-merge, fuse-allreduce, the pipeline
schedulers).

The reference's passes rewrite static Programs op by op. The port runs
eager steps, so a pass is a declarative transformation of the training
step's CONFIGURATION (the strategy dict `parallel.make_train_step` and
``models.llama_pipe.make_llama_pp_train_step`` read): recompute flips the
remat knobs, sharding picks the ZeRO stage and axis, and the pipeline
scheduler passes select the schedule and microbatches of
`parallel.pipeline_spmd` (`parallel.trainer.resolve_pipeline`). The pass
protocol (registration, check / apply, manager ordering, the context) is
the reference's, so pass lists written against paddle carry over.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Type

__all__ = ["PassBase", "PassContext", "PassManager", "new_pass",
           "register_pass"]

_PASS_REGISTRY: Dict[str, Type["PassBase"]] = {}


def register_pass(name: str):
    """reference: pass_base.py register_pass — class decorator."""
    def deco(cls):
        cls.name = name
        _PASS_REGISTRY[name] = cls
        return cls

    return deco


def new_pass(name: str, pass_attrs: Optional[dict] = None) -> "PassBase":
    """reference: pass_base.py new_pass."""
    if name not in _PASS_REGISTRY:
        raise ValueError(
            f"no pass named {name!r}; registered: "
            f"{sorted(_PASS_REGISTRY)}")
    p = _PASS_REGISTRY[name]()
    for k, v in (pass_attrs or {}).items():
        p.set_attr(k, v)
    return p


class PassContext:
    """reference: pass_base.py PassContext — records applied passes and
    cross-pass attributes."""

    def __init__(self):
        self.passes: List[PassBase] = []
        self.attrs: Dict[str, object] = {}

    def set_attr(self, k, v):
        self.attrs[k] = v

    def get_attr(self, k, default=None):
        return self.attrs.get(k, default)


class PassBase:
    """reference: pass_base.py PassBase — check/apply protocol. `apply`
    receives the strategy-config dict (in place of the reference's
    main_program) and mutates it."""

    name = "base"

    def __init__(self):
        self._attrs: Dict[str, object] = {}

    def set_attr(self, k, v):
        self._attrs[k] = v
        return self

    def get_attr(self, k, default=None):
        return self._attrs.get(k, default)

    def _check_self(self) -> bool:
        return True

    def _check_conflict(self, other: "PassBase") -> bool:
        return True

    def apply(self, main_programs, startup_programs=None, context=None):
        if not self._check_self():
            raise ValueError(f"pass {self.name} attrs invalid: "
                             f"{self._attrs}")
        ctx = context or PassContext()
        for p in ctx.passes:
            if p is self:
                continue  # re-applying the same manager/context is fine
            # both directions, like the reference: either side may declare
            # the conflict
            if not self._check_conflict(p) or not p._check_conflict(self):
                raise ValueError(
                    f"pass {self.name} conflicts with {p.name}")
        configs = main_programs if isinstance(main_programs, list) \
            else [main_programs]
        for cfg in configs:
            self._apply_single(cfg, ctx)
        if self not in ctx.passes:
            ctx.passes.append(self)
        return ctx

    def _apply_single(self, config, context):
        raise NotImplementedError


class PassManager:
    """reference: pass_base.py PassManager — ordered application with a
    shared context."""

    def __init__(self, passes: List[PassBase]):
        self._passes = list(passes)
        self._context = PassContext()

    def apply(self, main_programs, startup_programs=None):
        for p in self._passes:
            self._context = p.apply(main_programs, startup_programs,
                                    self._context)
        return self._context

    @property
    def context(self):
        return self._context

    @property
    def names(self):
        return [p.name for p in self._passes]


@register_pass("auto_parallel_amp")
class AMPPass(PassBase):
    """reference: passes/auto_parallel_amp.py — sets the mixed-precision
    policy (bf16 compute over f32 params and optimizer; no loss scaler
    needed: the trainer's amp section)."""

    def _apply_single(self, config, context):
        config.setdefault("amp", {})
        config["amp"]["enable"] = self.get_attr("enable", True)
        config["amp"]["dtype"] = self.get_attr("dtype", "bfloat16")
        config["amp"]["level"] = self.get_attr("level", "O2")
        context.set_attr("amp_dtype", config["amp"]["dtype"])


@register_pass("auto_parallel_fp16")
class FP16Pass(AMPPass):
    """reference: passes/auto_parallel_fp16.py — bf16 is the default half
    type; the dtype attr may still request float16."""

    def _apply_single(self, config, context):
        self.set_attr("dtype", self.get_attr("dtype", "bfloat16"))
        super()._apply_single(config, context)


@register_pass("auto_parallel_recompute")
class RecomputePass(PassBase):
    """reference: passes/auto_parallel_recompute.py — turns on selective
    recompute (the trainer's recompute section: recompute_skip /
    remat_policy; see LlamaConfig)."""

    def _apply_single(self, config, context):
        config.setdefault("recompute", {})
        config["recompute"]["enable"] = self.get_attr("enable", True)
        for k in ("checkpoints", "refined_ops_patterns", "remat_policy",
                  "recompute_skip"):
            if self.get_attr(k) is not None:
                config["recompute"][k] = self.get_attr(k)


@register_pass("auto_parallel_sharding")
class ShardingPass(PassBase):
    """reference: passes/auto_parallel_sharding.py — ZeRO stage over the
    sharding mesh axis (stage 1/2/3 = optimizer / +grad / +param
    sharding specs; see parallel/sharding.py)."""

    def _apply_single(self, config, context):
        config.setdefault("sharding", {})
        config["sharding"]["enable"] = True
        config["sharding"]["stage"] = int(self.get_attr("stage", 2))
        config["sharding"]["degree"] = int(self.get_attr("degree", 1))
        config["sharding"]["axis"] = self.get_attr("axis", "sharding")

    def _check_self(self):
        return int(self.get_attr("stage", 2)) in (1, 2, 3)


@register_pass("auto_parallel_gradient_merge")
class GradientMergePass(PassBase):
    """reference: passes/auto_parallel_gradient_merge.py — microbatch
    gradient accumulation (hapi accumulate_grad_batches / pipeline
    n_micro)."""

    def _apply_single(self, config, context):
        config.setdefault("gradient_merge", {})
        config["gradient_merge"]["enable"] = True
        config["gradient_merge"]["k_steps"] = int(
            self.get_attr("k_steps", 1))
        config["gradient_merge"]["avg"] = bool(self.get_attr("avg", True))


@register_pass("fuse_all_reduce")
class FuseAllReducePass(PassBase):
    """reference: passes/fuse_all_reduce.py — bucketed allreduce fusion.
    The port's gradient sync already makes one all-reduce a dtype
    (`collectives.all_reduce_tree`); the knob records the bucket size for
    introspection."""

    def _apply_single(self, config, context):
        config.setdefault("fuse_all_reduce", {})
        config["fuse_all_reduce"]["enable"] = self.get_attr("enable", True)
        config["fuse_all_reduce"]["max_memory_size"] = self.get_attr(
            "max_memory_size", 32 << 20)


class _PipelinePassBase(PassBase):
    schedule = "FThenB"

    def _apply_single(self, config, context):
        config.setdefault("pipeline", {})
        config["pipeline"]["enable"] = True
        config["pipeline"]["schedule_mode"] = self.schedule
        config["pipeline"]["micro_batch_size"] = self.get_attr(
            "micro_batch_size", 1)
        config["pipeline"]["accumulate_steps"] = self.get_attr(
            "accumulate_steps", 1)

    def _check_conflict(self, other):
        return not isinstance(other, _PipelinePassBase)


@register_pass("pipeline_scheduler_FThenB")
class PipelineFThenBPass(_PipelinePassBase):
    """reference: pipeline_scheduler_pass/pipeline_fthenb.py."""
    schedule = "FThenB"


@register_pass("pipeline_scheduler_1F1B")
class Pipeline1F1BPass(_PipelinePassBase):
    """reference: pipeline_scheduler_pass/pipeline_1f1b.py — the schedule
    parallel/pipeline_spmd.py runs as a tick table on each pp rank."""
    schedule = "1F1B"


@register_pass("pipeline_scheduler_Eager1F1B")
class PipelineEager1F1BPass(_PipelinePassBase):
    """reference: pipeline_scheduler_pass/pipeline_eager_1f1b.py:31 —
    more in-flight warmup forwards so boundary sends overlap compute
    (pipeline_spmd.pipeline_eager_1f1b)."""
    schedule = "Eager1F1B"


@register_pass("pipeline_scheduler_VPP")
class PipelineVPPPass(_PipelinePassBase):
    """reference: pipeline_scheduler_pass/pipeline_vpp.py (interleaved
    virtual stages)."""
    schedule = "VPP"


@register_pass("pipeline_scheduler_ZBH1")
class PipelineZeroBubblePass(_PipelinePassBase):
    """reference: pipeline_scheduler_pass/pipeline_zero_bubble.py."""
    schedule = "ZBH1"
