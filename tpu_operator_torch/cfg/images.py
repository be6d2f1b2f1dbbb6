"""The commands the port's containers exec, and whether an image has them.

The operator image (``deploy/docker/Dockerfile``) serves every in-repo
role, so each command a container of the port runs must resolve in it: the
operand assets' containers (their ``sh -c`` bodies read command by
command), the runtime ConfigMap's ``entrypoint.sh``, the chart's templates
with their hooks, and the kustomize base's manager. ``deploy/docker/
install.sh`` writes the image's commands under a prefix; ``unresolved``
names what such a prefix lacks, and ``foreign_modules`` the files under its
``bin`` that name a module of the reference package.

PyYAML is imported only where a manifest is read.
"""

from __future__ import annotations

import os
import re
import shlex
from pathlib import Path
from typing import Dict, List, Set, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
DEPLOY_DIR = PKG_DIR / "deploy"
INSTALL_SCRIPT = DEPLOY_DIR / "docker" / "install.sh"

# what the image's base system provides: the shell, its builtins and the
# utilities the manifests' shell bodies call
BASE_COMMANDS = frozenset({"sh", "set", "[", "test", "echo", "sleep", "touch", "rm", "grep"})
# sh words after which the next word is a command
_LEADING_WORDS = {"until", "while", "if", "then", "else", "elif", "do", "exec", "!", "{"}
# sh words that close a compound command
_CLOSING_WORDS = {"done", "fi", "}"}
_PUNCTUATION = "();<>|&\n"
# a file of the reference package's modules, as a shim or script names it
_REFERENCE_MODULE = re.compile(r"\btpu_operator\.")


def shell_commands(body: str) -> Set[str]:
    """The commands a POSIX shell body runs: the first word of each simple
    command, after ``exec``, ``until``, ``do`` and the like, quoted words
    kept whole and redirection targets skipped."""
    lex = shlex.shlex(body, posix=True, punctuation_chars=_PUNCTUATION)
    lex.whitespace = " \t\r"
    lex.whitespace_split = True
    found: Set[str] = set()
    at_start, skip = True, False
    for tok in lex:
        if skip:
            skip = False
        elif tok and all(c in _PUNCTUATION for c in tok):
            if tok[0] in "<>":
                skip = True  # the redirection's target
            else:
                at_start = True
        elif at_start and tok not in _LEADING_WORDS:
            if tok not in _CLOSING_WORDS:
                found.add(tok)
            at_start = False
    return found


def _command_of(cmd: list, args: list) -> Set[str]:
    """The program of a ``command``, and for ``sh -c`` the commands of its
    body (``command[2]``, else ``args[0]``)."""
    cmd = [str(c) for c in cmd or []]
    if not cmd:
        return set()
    found = {cmd[0]}
    if cmd[:2] == ["sh", "-c"]:
        found |= shell_commands(cmd[2] if len(cmd) > 2 else str((args or [""])[0]))
    return found


def _exec_handlers(node):
    """Every ``exec: {command: [...]}`` under a container: its probes and
    its lifecycle hooks."""
    if isinstance(node, dict):
        handler = node.get("exec")
        if isinstance(handler, dict) and handler.get("command"):
            yield handler["command"]
        for value in node.values():
            yield from _exec_handlers(value)
    elif isinstance(node, list):
        for value in node:
            yield from _exec_handlers(value)


def container_commands(ctr: dict) -> Set[str]:
    """What one container runs: its ``command`` with its ``args``, and the
    ``exec`` handlers of its probes and lifecycle hooks."""
    found = _command_of(ctr.get("command"), ctr.get("args"))
    for cmd in _exec_handlers(ctr):
        found |= _command_of(cmd, [])
    return found


def _containers(doc):
    if isinstance(doc, dict):
        for key in ("containers", "initContainers"):
            for ctr in doc.get(key) or []:
                if isinstance(ctr, dict):
                    yield ctr
        for value in doc.values():
            yield from _containers(value)
    elif isinstance(doc, list):
        for value in doc:
            yield from _containers(value)


def helm_free(text: str) -> str:
    """A chart template as plain YAML: lines holding only a directive
    dropped, inline expressions as ``x`` (no command holds one)."""
    lines = [line for line in text.splitlines() if not re.match(r"^\s*\{\{-?.*\}\}\s*$", line)]
    return re.sub(r"\{\{.*?\}\}", "x", "\n".join(lines))


def _manifests(pkg_dir: Path) -> List[Tuple[str, str]]:
    """(path relative to ``pkg_dir``, YAML text) of every manifest whose
    containers the image runs."""
    out = []
    roots = [(pkg_dir / "assets", False), (pkg_dir / "deploy" / "gpu-operator" / "templates", True),
             (pkg_dir / "deploy" / "config" / "manager", False)]
    for root, templated in roots:
        for dirpath, _, names in sorted(os.walk(root)):
            for name in sorted(names):
                if name.endswith(".yaml"):
                    path = Path(dirpath) / name
                    text = path.read_text()
                    out.append((str(path.relative_to(pkg_dir)), helm_free(text) if templated else text))
    return out


def exec_commands(pkg_dir: Path = PKG_DIR) -> Dict[str, Set[str]]:
    """Every command the port's containers exec, with the manifests that
    exec it: the assets, the runtime ConfigMap's shell scripts, the
    chart's templates and the kustomize manager."""
    import yaml

    found: Dict[str, Set[str]] = {}
    for rel, text in _manifests(Path(pkg_dir)):
        for doc in yaml.safe_load_all(text):
            if not doc:
                continue
            cmds = set()
            for ctr in _containers(doc.get("spec") or {}):
                cmds |= container_commands(ctr)
            if doc.get("kind") == "ConfigMap":
                for key, value in (doc.get("data") or {}).items():
                    if key.endswith(".sh"):
                        cmds |= shell_commands(value)
            for cmd in cmds:
                found.setdefault(cmd, set()).add(rel)
    return found


def unresolved(prefix: str, pkg_dir: Path = PKG_DIR) -> Dict[str, Set[str]]:
    """The commands of ``exec_commands`` that are neither an executable
    file under ``prefix/bin`` nor one of ``BASE_COMMANDS``."""
    bin_dir = Path(prefix) / "bin"
    return {cmd: files for cmd, files in exec_commands(pkg_dir).items()
            if cmd not in BASE_COMMANDS and not os.access(bin_dir / cmd, os.X_OK)}


def foreign_modules(prefix: str) -> List[str]:
    """The files under ``prefix/bin`` that name a ``tpu_operator.`` module."""
    bin_dir = Path(prefix) / "bin"
    hits = []
    for path in sorted(bin_dir.iterdir()):
        if _REFERENCE_MODULE.search(path.read_bytes().decode("utf-8", "replace")):
            hits.append(path.name)
    return hits


def install_table(script: Path = INSTALL_SCRIPT) -> Dict[str, str]:
    """``install.sh``'s ``COMMANDS``: command name -> ``module:function``."""
    body = re.search(r"^COMMANDS=\(\n(.*?)^\)", Path(script).read_text(), re.M | re.S).group(1)
    table = {}
    for line in body.splitlines():
        name, module, func = line.strip().split(":")
        table[name] = f"{module}:{func}"
    return table
