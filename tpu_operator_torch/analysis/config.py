"""Analyzer configuration: the ``[tool.gpu_analysis]`` pyproject block.

The port's copy of ``tpu_operator/analysis/config.py``. The reader is
the reference's; the section is ``[tool.gpu_analysis]`` and the defaults
are the port's own (its package and ``chip_smoke.py``, its baseline and
metrics module). The repo's ``pyproject.toml`` carries no such section,
so these defaults are what ``python -m tpu_operator_torch.analysis``
runs with; a root with its own section (a test fixture) overrides them.

Python 3.10 has no ``tomllib`` and the analyzer must stay
dependency-free, so this is a deliberately tiny TOML-subset reader:
one section, ``key = value`` pairs where value is a string, bool, int,
or a (possibly multiline) array of strings. That covers every knob the
analyzer has; anything fancier in the block is a configuration error
worth failing loudly on.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List

SECTION = "tool.gpu_analysis"


@dataclass
class AnalysisConfig:
    # roots the default invocation scans (repo-relative)
    paths: List[str] = field(
        default_factory=lambda: ["tpu_operator_torch", "chip_smoke.py"]
    )
    baseline: str = "tpu_operator_torch/analysis/baseline.json"
    # rule ids disabled outright
    disable: List[str] = field(default_factory=list)
    # guarded-by: also flag UNLOCKED READS of guarded attributes (off by
    # default: GIL-atomic scalar reads of counters/flags are idiomatic
    # here — the reference's docs/analysis.md#guarded-by)
    guarded_by_strict_reads: bool = False
    # methods with this suffix follow the repo's caller-holds-lock
    # convention (``_begin_pass_locked``, ``_commit_main_locked``):
    # guarded-by treats their bodies as lock-held, and lock-blocking
    # still flags blocking calls inside them
    locked_method_suffix: str = "_locked"
    # lock-blocking: method names that block the calling thread
    blocking_methods: List[str] = field(
        default_factory=lambda: ["result", "drain", "join_all", "urlopen", "getresponse"]
    )
    # lock-blocking: dotted call paths that block
    blocking_functions: List[str] = field(
        default_factory=lambda: ["time.sleep"]
    )
    # frozen-view: regex a receiver name must match to count as an
    # informer-backed read surface
    frozen_receivers: str = r"(client|cache|informer|store)"
    # metrics-fed: attribute assignments in this module register metrics
    metrics_module: str = "tpu_operator_torch/controllers/operator_metrics.py"
    repo_root: str = "."

    def is_enabled(self, rule_id: str) -> bool:
        return rule_id not in self.disable


_STR = re.compile(r'^"((?:[^"\\]|\\.)*)"$')


def _parse_scalar(text: str):
    text = text.strip()
    m = _STR.match(text)
    if m:
        return m.group(1).replace('\\"', '"').replace("\\\\", "\\")
    if text in ("true", "false"):
        return text == "true"
    try:
        return int(text)
    except ValueError:
        raise ValueError(f"unsupported TOML value: {text!r}")


def _strip_comment(line: str) -> str:
    """Drop a trailing comment, respecting double-quoted strings."""
    out, in_str = [], False
    i = 0
    while i < len(line):
        ch = line[i]
        if ch == '"' and (i == 0 or line[i - 1] != "\\"):
            in_str = not in_str
        elif ch == "#" and not in_str:
            break
        out.append(ch)
        i += 1
    return "".join(out)


def parse_tool_section(text: str, section: str = SECTION) -> Dict[str, object]:
    """Extract ``[section]`` key/values from pyproject-style TOML text."""
    values: Dict[str, object] = {}
    in_section = False
    pending_key = None
    pending_items: List[str] = []
    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if line.startswith("["):
            in_section = line == f"[{section}]"
            continue
        if not in_section:
            continue
        if pending_key is not None:
            # accumulating a multiline array
            closed = line.endswith("]")
            body = line[:-1] if closed else line
            pending_items.extend(
                p.strip() for p in body.split(",") if p.strip()
            )
            if closed:
                values[pending_key] = [_parse_scalar(p) for p in pending_items]
                pending_key, pending_items = None, []
            continue
        if "=" not in line:
            raise ValueError(f"unparseable [{section}] line: {raw!r}")
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if val.startswith("["):
            if val.endswith("]"):
                body = val[1:-1]
                items = [p.strip() for p in body.split(",") if p.strip()]
                values[key] = [_parse_scalar(p) for p in items]
            else:
                pending_key = key
                pending_items = [
                    p.strip() for p in val[1:].split(",") if p.strip()
                ]
        else:
            values[key] = _parse_scalar(val)
    return values


def load_config(repo_root: str = ".") -> AnalysisConfig:
    cfg = AnalysisConfig(repo_root=repo_root)
    pyproject = os.path.join(repo_root, "pyproject.toml")
    if not os.path.exists(pyproject):
        return cfg
    with open(pyproject, encoding="utf-8") as f:
        values = parse_tool_section(f.read())
    for key, val in values.items():
        if not hasattr(cfg, key):
            raise ValueError(f"unknown [{SECTION}] key: {key}")
        setattr(cfg, key, val)
    return cfg
