"""paddle.distributed.passes.pipeline_scheduler_pass on the port
(counterpart of paddle_tpu/parallel/passes/pipeline_scheduler_pass;
reference: distributed/passes/pipeline_scheduler_pass/__init__.py) — the
schedule passes the pp train step reads (``models.llama_pipe``,
tests/test_torch_pp.py)."""
from .. import (  # noqa: F401
    PassContext,
    Pipeline1F1BPass,
    PipelineEager1F1BPass,
    PipelineFThenBPass,
    PipelineVPPPass,
    PipelineZeroBubblePass,
    new_pass,
)

__all__ = []

_SCHEDULES = ("FThenB", "1F1B", "Eager1F1B", "VPP", "ZBH1")


def apply_pass(main_program, startup_program, pass_name, pass_attr=None):
    """Reference: pipeline_scheduler_pass/__init__.py:27 — build + apply the
    named schedule pass over the strategy config dict the pp train step
    reads; returns the pass context."""
    if pass_name not in _SCHEDULES:
        raise AssertionError(
            "pipeline scheduler only support FThenB, 1F1B, Eager1F1B, VPP "
            f"and ZBH1, but receive {pass_name}")
    pipeline_pass = new_pass("pipeline_scheduler_" + pass_name,
                             pass_attr or {})
    context = PassContext()
    pipeline_pass.apply([main_program], [startup_program], context)
    return context
