"""AST rule engine: file discovery, parsing, suppression, baseline,
deterministic reporting.

The port's copy of ``tpu_operator/analysis/engine.py``; nothing but the
package's names and the baseline's path differs.

Determinism is a hard contract (tests byte-compare two runs): files are
walked sorted, findings are sorted by (path, line, rule, message), and
nothing in the report carries a timestamp, pid, or absolute path.

Suppression syntax (same line as the finding)::

    self._executor = make()  # lint: ignore[guarded-by] caller holds _lock

``# lint: ignore`` without a bracket suppresses every rule on the line;
``# lint: ignore-file[rule-id]`` anywhere in a file's first 20 lines
suppresses that rule for the whole file (the sim/test scaffolding
escape: kube/testing.py is ALLOWED to import upward, and says so at the
top where a reviewer sees it).

The baseline (``tpu_operator_torch/analysis/baseline.json``) maps finding fingerprints —
``sha1(rule|path|scope|message)``, line-number-free so unrelated edits
do not churn it — to accepted counts. The CLI fails only on
findings beyond the baselined count; an empty baseline means the gate
bites on everything.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpu_operator_torch.analysis.config import AnalysisConfig

SUPPRESS_RE = re.compile(r"#\s*lint:\s*ignore(?:\[([a-zA-Z0-9_,\- ]+)\])?")
SUPPRESS_FILE_RE = re.compile(r"#\s*lint:\s*ignore-file\[([a-zA-Z0-9_,\- ]+)\]")
FILE_SUPPRESS_SCAN_LINES = 20


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    # enclosing class/function, part of the fingerprint so baselines
    # survive line drift without colliding across scopes
    scope: str = ""

    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.scope}|{self.message}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class ParsedModule:
    path: str  # absolute
    relpath: str  # repo-relative posix
    source: str
    lines: List[str]
    tree: ast.Module
    # dotted module name when under the package root, else ""
    modname: str


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)  # post-suppression
    new: List[Finding] = field(default_factory=list)  # beyond baseline
    suppressed: int = 0
    baselined: int = 0
    files_scanned: int = 0
    parse_errors: List[Finding] = field(default_factory=list)

    def render_text(self) -> str:
        out = []
        for f in self.new:
            out.append(f.render())
        out.append(
            f"{len(self.new)} finding(s) "
            f"({len(self.findings)} total, {self.baselined} baselined, "
            f"{self.suppressed} suppressed) in {self.files_scanned} file(s)"
        )
        return "\n".join(out)

    def render_json(self) -> str:
        return json.dumps(
            {
                "new": [f.__dict__ for f in self.new],
                "total": len(self.findings),
                "baselined": self.baselined,
                "suppressed": self.suppressed,
                "files_scanned": self.files_scanned,
            },
            indent=2,
            sort_keys=True,
        )


def _modname_for(relpath: str) -> str:
    if not relpath.endswith(".py"):
        return ""
    parts = relpath[: -len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def collect_files(repo_root: str, paths: List[str]) -> List[str]:
    """Sorted absolute paths of every .py under the given roots (a root
    may itself be a file)."""
    found = []
    for root in paths:
        abs_root = os.path.join(repo_root, root)
        if os.path.isfile(abs_root):
            found.append(abs_root)
            continue
        for dirpath, dirnames, filenames in os.walk(abs_root):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__" and not d.startswith(".")
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    found.append(os.path.join(dirpath, name))
    return sorted(set(found))


def parse_modules(
    repo_root: str, files: List[str]
) -> Tuple[List[ParsedModule], List[Finding]]:
    modules, errors = [], []
    for path in files:
        relpath = os.path.relpath(path, repo_root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=relpath)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            line = getattr(e, "lineno", 1) or 1
            errors.append(
                Finding("parse", relpath, line, f"cannot parse: {e.__class__.__name__}")
            )
            continue
        modules.append(
            ParsedModule(
                path=path,
                relpath=relpath,
                source=source,
                lines=source.splitlines(),
                tree=tree,
                modname=_modname_for(relpath),
            )
        )
    return modules, errors


# ---------------------------------------------------------------------------
# suppression
# ---------------------------------------------------------------------------


def _line_suppressions(lines: List[str]) -> Dict[int, Optional[set]]:
    """line number -> set of suppressed rule ids (None = all rules)."""
    out: Dict[int, Optional[set]] = {}
    for i, line in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _file_suppressions(lines: List[str]) -> set:
    out = set()
    for line in lines[:FILE_SUPPRESS_SCAN_LINES]:
        m = SUPPRESS_FILE_RE.search(line)
        if m:
            out.update(r.strip() for r in m.group(1).split(",") if r.strip())
    return out


def apply_suppressions(
    findings: List[Finding], modules: List[ParsedModule]
) -> Tuple[List[Finding], int]:
    # precompute per module: rescanning every line per FINDING would be
    # O(findings × file lines) on a regression-heavy run
    by_path = {
        m.relpath: (_file_suppressions(m.lines), _line_suppressions(m.lines))
        for m in modules
    }
    kept, dropped = [], 0
    for f in findings:
        entry = by_path.get(f.path)
        if entry is None:
            kept.append(f)
            continue
        file_rules, line_rules = entry
        if f.rule in file_rules:
            dropped += 1
            continue
        rules = line_rules.get(f.line, ())
        if rules is None or f.rule in rules:
            dropped += 1
            continue
        kept.append(f)
    return kept, dropped


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> Dict[str, int]:
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != 1:
        raise ValueError(f"unsupported baseline version in {path}")
    return {str(k): int(v) for k, v in data.get("fingerprints", {}).items()}


def write_baseline(path: str, findings: List[Finding]) -> None:
    counts: Dict[str, int] = {}
    notes: Dict[str, str] = {}
    for f in findings:
        fp = f.fingerprint()
        counts[fp] = counts.get(fp, 0) + 1
        notes.setdefault(fp, f.render())
    payload = {
        "version": 1,
        # human-readable context only; the gate reads fingerprints
        "notes": {k: notes[k] for k in sorted(notes)},
        "fingerprints": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def split_baselined(
    findings: List[Finding], baseline: Dict[str, int]
) -> Tuple[List[Finding], int]:
    budget = dict(baseline)
    new = []
    baselined = 0
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            baselined += 1
        else:
            new.append(f)
    return new, baselined


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------


def run_analysis(
    config: AnalysisConfig,
    paths: Optional[List[str]] = None,
    baseline_path: Optional[str] = None,
    use_baseline: bool = True,
) -> Report:
    from tpu_operator_torch.analysis.rules import build_rules

    files = collect_files(config.repo_root, paths or config.paths)
    modules, parse_errors = parse_modules(config.repo_root, files)
    rules = [r for r in build_rules(config) if config.is_enabled(r.id)]

    findings: List[Finding] = list(parse_errors)
    for rule in rules:
        for mod in modules:
            findings.extend(rule.visit_module(mod, config))
        findings.extend(rule.finalize(config))

    findings, suppressed = apply_suppressions(findings, modules)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))

    if use_baseline:
        bl_path = baseline_path or os.path.join(config.repo_root, config.baseline)
        baseline = load_baseline(bl_path)
    else:
        baseline = {}
    new, baselined = split_baselined(findings, baseline)

    return Report(
        findings=findings,
        new=new,
        suppressed=suppressed,
        baselined=baselined,
        files_scanned=len(modules),
        parse_errors=parse_errors,
    )
