"""layering — the package's import-direction contracts.

Contracts encoded (docs/architecture.md, docs/observability.md, the
obs/ and kube/ module docstrings):

* ``obs/`` imports NOTHING from ``tpu_operator_torch`` — it is the
  always-importable instrumentation layer every other module may use;
* ``kube/`` never imports upward (``controllers/``, ``schedsim/``,
  ``upgrade/``, ...): the module-hook pattern
  (``write_pipeline.on_queue_wait_ms``, ``client.on_conflict_retry``)
  is the only allowed inversion, and it is an assignment made BY the
  upper layer, not an import made by kube/;
* nothing in the runtime package imports ``tpu_operator_torch.analysis`` —
  the analyzer stands outside the stack it checks.

The port holds its own package to the same three contracts
(``PKG = "tpu_operator_torch"``). No runtime module imports
``lockwatch`` either: the tests and ``chip_smoke.py`` enable it around
the chaos suites, as the reference's session fixture does.

Deliberate inversions in simulation/test scaffolding (the kubelet sim
IS the kubelet side of the device-plugin wire) carry file-level
``# lint: ignore-file[layering]`` headers where a reviewer sees them.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from tpu_operator_torch.analysis.config import AnalysisConfig
from tpu_operator_torch.analysis.engine import Finding, ParsedModule
from tpu_operator_torch.analysis.rules import Rule

PKG = "tpu_operator_torch"
# what kube/ may reach: itself, the dependency-free obs layer, shared
# constants, and the API types
KUBE_ALLOWED = {
    f"{PKG}.kube",
    f"{PKG}.obs",
    f"{PKG}.consts",
    f"{PKG}.api",
}


def _resolve_relative(modname: str, level: int, module: Optional[str]) -> str:
    parts = modname.split(".")
    base = parts[: len(parts) - level] if level <= len(parts) else []
    if module:
        base = base + [module]
    return ".".join(base)


def _imports_of(mod: ParsedModule) -> List[Tuple[str, int]]:
    """Every (dotted-target, line) the module imports, relative imports
    resolved against the module's own dotted name."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.append((alias.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                pkg_name = mod.modname
                # a module's relative base is its package
                if not mod.relpath.endswith("/__init__.py"):
                    pkg_name = ".".join(pkg_name.split(".")[:-1]) if pkg_name else ""
                    level = node.level - 1
                else:
                    level = node.level - 1
                target = _resolve_relative(pkg_name, level, node.module)
            else:
                target = node.module or ""
            # `from tpu_operator_torch import consts` imports tpu_operator_torch.consts
            if target:
                for alias in node.names:
                    out.append((f"{target}.{alias.name}", node.lineno))
            else:
                for alias in node.names:
                    out.append((alias.name, node.lineno))
    return out


def _allowed(target: str, allowed_prefixes) -> bool:
    if target == PKG:  # bare "import tpu_operator_torch" (namespace only)
        return True
    return any(
        target == p or target.startswith(p + ".") for p in allowed_prefixes
    )


class LayeringRule(Rule):
    id = "layering"

    def visit_module(
        self, mod: ParsedModule, config: AnalysisConfig
    ) -> List[Finding]:
        findings: List[Finding] = []
        if not mod.modname.startswith(PKG):
            return findings
        in_obs = mod.modname.startswith(f"{PKG}.obs")
        in_kube = mod.modname.startswith(f"{PKG}.kube")
        in_analysis = mod.modname.startswith(f"{PKG}.analysis")
        for target, line in _imports_of(mod):
            if not target.startswith(PKG):
                continue
            if in_obs and not _allowed(target, {f"{PKG}.obs"}):
                findings.append(
                    Finding(
                        self.id,
                        mod.relpath,
                        line,
                        f"obs/ must import nothing from the package "
                        f"(imports {target})",
                        scope=mod.modname,
                    )
                )
            elif in_kube and not _allowed(target, KUBE_ALLOWED):
                findings.append(
                    Finding(
                        self.id,
                        mod.relpath,
                        line,
                        f"kube/ must not import upward (imports {target}; "
                        f"use a module hook like on_queue_wait_ms for "
                        f"inversions)",
                        scope=mod.modname,
                    )
                )
            elif (
                not in_analysis
                and _allowed(target, {f"{PKG}.analysis"})
            ):
                findings.append(
                    Finding(
                        self.id,
                        mod.relpath,
                        line,
                        f"runtime code must not import the analyzer "
                        f"(imports {target})",
                        scope=mod.modname,
                    )
                )
        return findings
