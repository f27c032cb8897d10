"""paddle_tpu_torch.analysis — lint, memory and roofline audits of the
port's programs (counterpart of paddle_tpu/analysis).

A program (a function of tensors, a module, an engine's decode chunk, a
training step) is traced to a ``torch.fx`` graph over fake tensors: no
data is read, no device memory allocated, nothing launched. Each
hand-written kernel is one operator node ``paddle_tpu::<name>``
(``kernels/_build.kernel_op``), so a trace on the CPU has the kernel
nodes the card runs. Rules, a liveness pass and a FLOPs / bytes pass run
over the graph::

    import paddle_tpu_torch.analysis as analysis
    report = analysis.analyze(fn, *example_args)
    print(report.format());  report.raise_or_warn()
    analysis.audit_memory(fn, *args).peak_bytes
    analysis.audit_roofline(fn, *args, device="h100-sxm").predicted_step_ms

    eng.warm(audit_memory=True, audit_roofline=True)   # every program
    model.fit(..., audit_memory=True, audit_roofline=True)  # the step

    python -m paddle_tpu_torch.analysis --roofline --device cpu

The rules keep the JAX package's ids, so findings compare one to one;
each states the card's version of the TPU hazard it was written for:

=======  =================  =================================================
id       JAX (TPU) hazard   the port's rule (H100)
=======  =================  =================================================
TPU101   (8|16|32) x 128    bf16 / f16 / int8 products outside the kernels
         MXU tile padding   off the mma tile (m16n8k16, int8 k32). The
                            kernels' own limits (head_dim 64 / 128, the
                            pool's pages, the GEMV's K multiple of 32) are
                            TPU102's: for a kernel node the two rules would
                            say the same thing, so TPU101 skips them.
TPU102   pallas_call shape  kernel operator shapes the CUDA kernel refuses,
         vs block consts    from ``kernels/constraints.py`` (the wrappers'
                            checks as shape math, the megakernel's "card
                            limit" reasons).
TPU103   f32 / scale-less   f32 pools at the paged and contiguous decode,
         KV pools           paged prefill and megakernel nodes; int8 pools
                            without their scales.
TPU105   many distinct      many distinct small-output launches in a
         launches per scan  program (the unrolled decode chunk counts one
         body               step's once): dispatch-bound; the megakernel.
TPU201   a Python scalar    a Python scalar baked into a program: a CUDA
         retraces jit       graph captures one value (`GraphSite`), so each
                            new value needs a capture of its own.
TPU202   closure constants  tensors captured from the closure
         burned into HLO    (``get_attr``): the graph names their memory.
TPU301   bf16 -> f32, MXU   bf16 -> f32 upcasts feeding compute; f32
         f32 rate           products over widened operands run at the
                            CUDA-core f32 rate (the H100 row prices f32 at
                            67 TFLOP/s: the port never enables TF32).
TPU401   collectives        dead and duplicate collectives, an axis
                            outside the declared mesh, large float
                            payloads (the collective operators' nodes,
                            ``comms.py``'s inventory).
TPU501   host callbacks     ``.item()``, ``.tolist()``
                            (``_local_scalar_dense``), ``.cpu()`` and host
                            calls inside a program: ERROR, since a CUDA
                            graph capture of the program fails there.
TPU601   checkpoint in jit  a checkpoint save inside a program (the port
                            raises under a capture at run time).
TPU602   trace emitter in   a trace span / instant / counter inside a
         jit                program (TraceUnderJitError at run time).
TPU701   donation miss      a fresh full-size copy of an input the program
                            drops (a pool updated out of place); the port
                            updates in place where JAX donates.
TPU702   HBM over budget    the liveness peak over the budget (the card's
                            memory, or the engine's pools + params).
TPU703   live-range bloat   a large intermediate live across many calls.
TPU801   collective in a    a collective repeated by the program's
         scan body          unrolled steps past `max_step_wire_bytes`.
TPU802   implicit reshard   silent by construction: SPMD ranks make only
                            the collectives they call.
TPU803   quantizable        a float-payload collective >= `min_bytes`
         collective         (amplified): quantized_collectives' rewrite.
TPU901   bandwidth-bound    a repeated call (the unrolled loop's) below
         scan body          the ridge point, with >= 0.5 ms of HBM time.
TPU902   tile padding       the products' mma tile padding share.
TPU903   launch-bound step  launch overhead share of the predicted time
                            (the H100 row's replayed-launch cost).
=======  =================  =================================================

The static autotuner (``tuner.py``) turns the memory and roofline passes
into an objective over the serving engine's build-time knobs; its
`TunedConfig` artifact is what ``ContinuousBatchingEngine(config=...)``
and FLAGS_tuned_config apply::

    report = analysis.autotune(cfg, params, engine_kwargs=geometry)
    report.tuned_config().save(directory)

    python -m paddle_tpu_torch.analysis --tune --device cpu-container

The communication audit (``comms.py``; TPU401, TPU801-803) prices each
rank's bytes on the wire from the collective operators' nodes
(``parallel/collectives.py``), with a program's unrolled steps folded
into sites::

    analysis.audit_comms(fn, *args, steps=8).total_wire_bytes
    eng.warm(audit_comms=True);  eng.audit_comms()   # a sharded engine
    model.fit(..., audit_comms=True)                 # the dp step

    python -m paddle_tpu_torch.analysis --comms --format json
"""
from .diagnostics import (  # noqa: F401
    Diagnostic, LintError, Report, Severity,
)
from .graph import Graph, trace_graph  # noqa: F401
from .pipeline import Pipeline, analyze, lint  # noqa: F401
from .rules import (  # noqa: F401
    RULES, Rule, default_rules, register_rule,
)
# imported for their side effect too: they register TPU701-703,
# TPU801-803 and TPU901-903
from . import comms, device_specs, memory, roofline  # noqa: F401,E402
from .comms import (  # noqa: F401,E402
    CommsReport, audit_comms, resolve_audit_comms,
)
from .device_specs import DeviceSpec, auto_hbm_budget, get_spec  # noqa
from .memory import (  # noqa: F401
    MemoryReport, audit_graph, audit_memory, trace_for_memory,
)
from .roofline import (  # noqa: F401
    RooflineReport, audit_roofline, count_kernel_launches,
    count_step_kernels, kernel_launches,
)
from . import tuner  # noqa: F401,E402
from .tuner import TunedConfig, TuningReport, autotune  # noqa: F401,E402

__all__ = [
    "CommsReport", "DeviceSpec", "Diagnostic", "Graph", "LintError",
    "MemoryReport", "Pipeline", "Report", "RooflineReport", "RULES",
    "Rule", "Severity", "analyze", "audit_comms", "audit_graph",
    "audit_memory", "audit_roofline", "auto_hbm_budget", "comms",
    "count_kernel_launches", "count_step_kernels", "default_rules",
    "device_specs", "get_spec", "kernel_launches", "lint", "memory",
    "register_rule", "resolve_audit_comms", "roofline", "trace_for_memory",
    "trace_graph", "TunedConfig", "TuningReport", "autotune", "tuner",
]
