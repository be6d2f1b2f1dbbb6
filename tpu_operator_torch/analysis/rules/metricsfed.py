"""metrics-fed — every registered metric must have a feeding call site.

Contract encoded: the obs surface (docs/observability.md) is only
trustworthy if every series it exports moves. A gauge registered in
``operator_metrics.py`` that no code ever ``.set()``s is worse than
missing — dashboards read a permanent 0 and alerts silently never fire.
As the surface grows (21+ series and counting), dead registrations are
exactly the drift this rule catches.

Mechanics: collect ``self.NAME = g(...)/c(...)/h(...)`` (or direct
``Gauge``/``Counter``/``Histogram``) registrations from the configured
metrics module, then every attribute LOAD named ``NAME`` anywhere in
the scanned tree — ``metrics.slices_ready.set(...)``, a bound-method
hook wire like ``_wp.on_queue_wait_ms = hist.observe`` reading the
attribute, or a convenience feeder inside the metrics class itself all
count. Registrations with zero loads are findings at their
registration line.
"""

from __future__ import annotations

import ast
from collections import Counter
from typing import Dict, List, Tuple

from tpu_operator_torch.analysis.config import AnalysisConfig
from tpu_operator_torch.analysis.engine import Finding, ParsedModule
from tpu_operator_torch.analysis.rules import Rule, dotted

REGISTER_FUNCS = {"g", "c", "h", "Gauge", "Counter", "Histogram", "Summary"}


class MetricsFedRule(Rule):
    id = "metrics-fed"

    def __init__(self) -> None:
        # attr -> (relpath, line)
        self.registered: Dict[str, Tuple[str, int]] = {}
        self.loads: Counter = Counter()

    def visit_module(
        self, mod: ParsedModule, config: AnalysisConfig
    ) -> List[Finding]:
        if mod.relpath == config.metrics_module:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Assign):
                    continue
                if not isinstance(node.value, ast.Call):
                    continue
                func = node.value.func
                fname = (dotted(func) or "").split(".")[-1]
                if fname not in REGISTER_FUNCS:
                    continue
                for target in node.targets:
                    if (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        self.registered[target.attr] = (
                            mod.relpath,
                            node.lineno,
                        )
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load
            ):
                self.loads[node.attr] += 1
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "getattr"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                # getattr(metrics, "name", None) feeders count as loads
                self.loads[node.args[1].value] += 1
        return []

    def finalize(self, config: AnalysisConfig) -> List[Finding]:
        findings = []
        for attr, (relpath, line) in sorted(self.registered.items()):
            if self.loads[attr] == 0:
                findings.append(
                    Finding(
                        self.id,
                        relpath,
                        line,
                        f"metric '{attr}' is registered but never fed "
                        f"(no attribute load anywhere in the scanned tree)",
                        scope="OperatorMetrics",
                    )
                )
        self.registered = {}
        self.loads = Counter()
        return findings
