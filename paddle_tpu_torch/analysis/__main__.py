"""CLI: lint (and memory / roofline audit) a program of the port
(counterpart of ``python -m paddle_tpu.analysis``).

    python -m paddle_tpu_torch.analysis --device cpu         # tiny forward
    python -m paddle_tpu_torch.analysis --memory --device cpu --format json
    python -m paddle_tpu_torch.analysis --roofline --device cpu
    python -m paddle_tpu_torch.analysis --roofline --spec h100-sxm
    python -m paddle_tpu_torch.analysis mypkg.models:factory --device cpu
    python -m paddle_tpu_torch.analysis --rule-config TPU702.hbm_budget_bytes=2147483648

A factory is a zero-argument callable in an importable module returning
``(fn, args)`` or ``(fn, args, kwargs)``; `fn` is traced called with
those example arguments (tensors on any device, or meta tensors), on fake
tensors: nothing runs. With no target the bundled demos run on
``--device`` (default: the card, as every entry point of the port; pass
``cpu`` on a host without one): the tiny Llama forward for the lint, and
the tiny serving engine's decode chunk (its paged KV pools updated in
place) under ``--memory`` / ``--roofline``. ``--spec`` names the device
row the roofline prices against (default: the card's row, else
``h100-sxm``).

``--comms`` and ``--tune`` are not ported: they raise, naming their
ROADMAP.md items. ``--format json`` prints one object (the `Report`
schema plus ``memory`` / ``roofline`` keys); the exit status is 1 when a
diagnostic reaches ``--fail-on`` (default: error).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys


def _parse_rule_config(pairs):
    """KEY=VALUE strings -> a rule_config dict with typed values."""
    out = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep or not key:
            raise SystemExit(f"--rule-config expects KEY=VALUE, got {pair!r}")
        val: object = raw
        low = raw.lower()
        if low in ("true", "false"):
            val = low == "true"
        else:
            for cast in (int, float):
                try:
                    val = cast(raw)
                    break
                except ValueError:
                    continue
        out[key] = val
    return out


def _tiny_model(device):
    import torch

    from ..models import LlamaConfig, LlamaForCausalLM, init_train_params

    cfg = LlamaConfig.tiny()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, 0, device)).to(dtype)
    return cfg, model


def _forward_demo(device):
    import torch

    _, model = _tiny_model(device)
    ids = torch.zeros((1, 32), dtype=torch.int64, device=device)
    return model, (ids,), {}, "models.llama tiny forward"


def _decode_demo(device):
    """The tiny serving engine's decode chunk: its program body over the
    params, the paged pools and the program's static inputs."""
    import torch

    from ..models import LlamaConfig, init_serving_params
    from ..serving import ContinuousBatchingEngine

    cfg = LlamaConfig.tiny()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    eng = ContinuousBatchingEngine(
        cfg, init_serving_params(cfg, seed=0, device=device, dtype=dtype),
        slots=2, prompt_bucket=16, max_prompt_len=32, max_new_tokens=8,
        block_size=16, steps_per_sync=4, device=device, dtype=dtype)
    name, fn, ins = eng._program_inventory()[0]
    return fn, (eng.p, eng.kcs, eng.vcs, *ins), {}, \
        "models.llama tiny paged decode"


def _resolve_target(spec, device, serving: bool):
    if spec is None:
        return _decode_demo(device) if serving else _forward_demo(device)
    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(f"target {spec!r} must be module.path:factory_name")
    sys.path.insert(0, "")
    factory = getattr(importlib.import_module(mod_name), attr)
    obj = factory() if callable(factory) else factory
    if not isinstance(obj, tuple):
        raise SystemExit(f"factory {spec!r} must return (fn, args) or "
                         "(fn, args, kwargs)")
    fn = obj[0]
    args = tuple(obj[1]) if len(obj) > 1 else ()
    kwargs = dict(obj[2]) if len(obj) > 2 else {}
    return fn, args, kwargs, spec


def main(argv=None) -> int:
    from .device_specs import DEVICE_SPECS

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description="lint + static memory / roofline audits of the port's "
                    "programs, traced as torch.fx graphs on fake tensors")
    parser.add_argument("target", nargs="?", default=None,
                        help="module.path:factory (default: the bundled "
                             "tiny-llama demos)")
    parser.add_argument("--device", default=None,
                        help="torch device of the demos (default: the "
                             "card; 'cpu' on a host without one)")
    parser.add_argument("--spec", default=None, choices=sorted(DEVICE_SPECS),
                        help="device row the roofline prices against "
                             "(default: the card's row, else h100-sxm)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--rule-config", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="rule knob, repeatable: bare keys reach every "
                             "rule, TPUxxx.-prefixed keys one rule")
    parser.add_argument("--memory", action="store_true",
                        help="also run the static memory auditor")
    parser.add_argument("--roofline", action="store_true",
                        help="also run the static roofline auditor")
    parser.add_argument("--comms", action="store_true",
                        help="not ported (ROADMAP.md section 1 item 5)")
    parser.add_argument("--tune", action="store_true",
                        help="not ported (ROADMAP.md section 1 item 6)")
    parser.add_argument("--format", default="text", choices=["text", "json"])
    parser.add_argument("--fail-on", default="error",
                        choices=["info", "warning", "error", "never"])
    parser.add_argument("--min-severity", default="info",
                        choices=["info", "warning", "error"])
    args = parser.parse_args(argv)

    from . import COMMS_UNPORTED, Severity, analyze
    from .graph import trace_graph

    if args.comms:
        raise NotImplementedError(COMMS_UNPORTED)
    if args.tune:
        raise NotImplementedError(
            "--tune: the static autotuner (analysis/tuner.py, "
            "ContinuousBatchingEngine(config=)) is not ported yet "
            "(ROADMAP.md section 1 item 6)")
    from ..device import resolve_device

    device = resolve_device(args.device)
    rules = args.rules.split(",") if args.rules else None
    rule_config = _parse_rule_config(args.rule_config)
    if args.spec:
        for rid in ("TPU901", "TPU902", "TPU903", "TPU702"):
            rule_config.setdefault(f"{rid}.device", args.spec)
    fn, call_args, call_kwargs, label = _resolve_target(
        args.target, device, args.memory or args.roofline)
    graph = trace_graph(fn, *call_args, name=label, **call_kwargs)
    report = analyze(None, graph=graph, rules=rules,
                     rule_config=rule_config or None)
    mem = roof = None
    if args.memory:
        from .memory import audit_graph

        mem = audit_graph(graph)
    if args.roofline:
        from .roofline import audit_graph as roofline_audit_graph

        roof = roofline_audit_graph(graph, device=args.spec)
    if args.format == "json":
        out = report.to_dict()
        if mem is not None:
            out["memory"] = mem.to_dict()
        if roof is not None:
            out["roofline"] = roof.to_dict()
        print(json.dumps(out, sort_keys=True, indent=2))
    else:
        print(report.format(min_severity=Severity[args.min_severity.upper()]))
        for rep in (mem, roof):
            if rep is not None:
                print(rep.format())
    if args.fail_on != "never" and \
            report.at_least(Severity[args.fail_on.upper()]):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
