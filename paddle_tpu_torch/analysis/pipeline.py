"""The lint pipeline: trace -> run rules -> report (counterpart of
paddle_tpu/analysis/pipeline.py).

Use it two ways:
  - library:  `report = analyze(fn, *example_args)`
  - CLI:      `python -m paddle_tpu_torch.analysis`
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

from .diagnostics import Diagnostic, Report, Severity
from .graph import Graph, trace_graph
from .rules import RULES, Rule, default_rules, rule_config_for


class Pipeline:
    """A configured rule set runnable over many graphs."""

    def __init__(self, rules: Optional[Sequence[Rule]] = None,
                 severity_overrides: Optional[Dict[str, Severity]] = None,
                 **config):
        self.rules = default_rules(severity_overrides, **config) \
            if rules is None else list(rules)

    def run(self, graph: Graph) -> Report:
        report = Report(target=graph.name)
        for rule in self.rules:
            try:
                report.extend(rule.check(graph))
            except Exception as e:  # a broken rule must not kill the lint
                report.add(Diagnostic(
                    rule=rule.id, severity=Severity.INFO,
                    message=f"rule crashed: {type(e).__name__}: {e}",
                    where=graph.name))
        return report

    def analyze(self, fn: Callable, *args, name: Optional[str] = None,
                **kwargs) -> Report:
        return self.run(trace_graph(fn, *args, name=name, **kwargs))


def analyze(fn: Optional[Callable], *args,
            rules: Optional[Iterable] = None,
            severity_overrides: Optional[Dict[str, Severity]] = None,
            rule_config: Optional[Dict] = None,
            name: Optional[str] = None,
            graph: Optional[Graph] = None,
            **kwargs) -> Report:
    """Lint `fn` called with `args` / `kwargs` (tensors on any device,
    meta tensors or fakes: nothing runs). `rules` are Rule instances,
    Rule classes or registered ids (default: every registered rule);
    `severity_overrides` ({id: Severity, or None to disable}) applies
    either way. `rule_config` passes rule knobs: bare keys to every rule,
    ``TPUxxx.key`` keys to rule TPUxxx only
    (``{"TPU702.hbm_budget_bytes": 2 << 30}``). `graph` runs the rules
    over an already-traced `Graph` instead of tracing `fn`."""
    overrides = severity_overrides or {}
    cfg = rule_config or {}
    if "severity" in cfg:
        raise ValueError("rule_config key 'severity' is reserved: use "
                         "severity_overrides= for per-rule severities")
    unknown = sorted({k.split(".", 1)[0] for k in cfg if "." in k}
                     - set(RULES))
    if unknown:
        raise ValueError(
            f"rule_config prefixes {unknown} name no registered rule; "
            f"registered: {sorted(RULES)}")
    resolved = None
    if rules is not None:
        resolved = []
        for r in rules:
            if isinstance(r, Rule):
                rule = r
            elif isinstance(r, str):
                if r not in RULES:
                    raise KeyError(
                        f"unknown rule {r!r}; registered: {sorted(RULES)}")
                rule = RULES[r](**rule_config_for(r, cfg))
            elif isinstance(r, type) and issubclass(r, Rule):
                rule = r(**rule_config_for(r.id, cfg))
            else:
                raise TypeError(f"cannot interpret rule {r!r}")
            if rule.id in overrides:
                if overrides[rule.id] is None:
                    continue
                rule.severity = overrides[rule.id]
            resolved.append(rule)
    pipe = Pipeline(rules=resolved, severity_overrides=severity_overrides,
                    **cfg)
    if graph is not None:
        return pipe.run(graph)
    return pipe.analyze(fn, *args, name=name, **kwargs)


def lint(fn: Callable, *args, fail_on: Severity = Severity.ERROR,
         **kwargs) -> Report:
    """`analyze` + the default severity policy: `LintError` on error
    findings, Python warnings for warnings."""
    report = analyze(fn, *args, **kwargs)
    report.raise_or_warn(fail_on=fail_on)
    return report
