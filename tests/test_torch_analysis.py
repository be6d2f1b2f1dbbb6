"""The port's static analyser (``tpu_operator_torch/analysis``): the
reference's self-tests of ``tests/test_analysis.py`` at the port's names
(layering fixtures under ``tpu_operator_torch/``, the
``[tool.gpu_analysis]`` section), every seeded fixture run through both
analysers with equal findings, the port's tree clean and the report
byte-identical over two runs, and KubeSim's host width after it stopped
reading ``workloads/`` from ``kube/``."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from tpu_operator.analysis.config import AnalysisConfig as RefConfig
from tpu_operator.analysis.engine import run_analysis as ref_run_analysis
from tpu_operator_torch.analysis.config import (
    SECTION,
    AnalysisConfig,
    load_config,
    parse_tool_section,
)
from tpu_operator_torch.analysis.engine import (
    Finding,
    load_baseline,
    run_analysis,
    split_baselined,
    write_baseline,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG, PORT_PKG = "tpu_operator", "tpu_operator_torch"

# the reference's seeded-violation fixtures; layering's name the port's
# package (the reference's names ``tpu_operator``, renamed per side)
LAYERING = {
    "tpu_operator_torch/obs/bad.py": """\
        from tpu_operator_torch.kube.client import Client
    """,
    "tpu_operator_torch/kube/bad.py": """\
        from tpu_operator_torch.controllers import operator_metrics
        import tpu_operator_torch.schedsim.engine
    """,
    "tpu_operator_torch/kube/good.py": """\
        from tpu_operator_torch import consts
        from tpu_operator_torch.obs import trace
        from tpu_operator_torch.kube import frozen
    """,
    "tpu_operator_torch/controllers/bad_analysis.py": """\
        from tpu_operator_torch.analysis import engine
    """,
}
GUARDED_BY = {
    "mod.py": """\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []
                self._free = 0

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def bad(self, x):
                self._items.append(x)

            def suppressed(self, x):
                self._items.append(x)  # lint: ignore[guarded-by] test double, single-threaded

            def _flush_locked(self):
                self._items.clear()

            def unrelated(self):
                self._free = 1
    """,
}
CONDITION_ALIAS = {
    "mod.py": """\
        import threading

        class P:
            def __init__(self):
                self._lock = threading.Lock()
                self._idle = threading.Condition(self._lock)
                self._n = 0

            def locked_via_cond(self):
                with self._idle:
                    self._n += 1

            def locked_via_lock(self):
                with self._lock:
                    self._n -= 1
    """,
}
LOCK_ORDER = {
    "mod.py": """\
        import threading

        class D:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    with self._a:
                        pass

            def self_dead(self):
                with self._a:
                    with self._a:
                        pass
    """,
}
LOCK_ORDER_MULTI_ITEM = {
    "mod.py": """\
        import threading

        class D:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a, self._b:
                    pass

            def two(self):
                with self._b:
                    with self._a:
                        pass
    """,
}
LOCK_ORDER_CONSISTENT = {
    "mod.py": """\
        import threading

        class D:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.RLock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def reentrant_ok(self):
                with self._b:
                    with self._b:
                        pass
    """,
}
LOCK_BLOCKING = {
    "mod.py": """\
        import threading
        import time

        class E:
            def __init__(self):
                self._lock = threading.Lock()
                self._cond = threading.Condition(self._lock)

            def bad_sleep(self):
                with self._lock:
                    time.sleep(1)

            def bad_result(self, fut):
                with self._lock:
                    return fut.result()

            def ok_cond_wait(self):
                with self._cond:
                    self._cond.wait(0.1)

            def ok_unlocked(self, fut):
                return fut.result()

            def closure_not_held(self):
                with self._lock:
                    def later():
                        time.sleep(1)
                    return later
    """,
}
FROZEN_VIEW = {
    "mod.py": """\
        def bad_subscript(client):
            node = client.get("v1", "Node", "n")
            node["metadata"]["labels"]["x"] = "y"

        def bad_loop_mutator(client):
            for pod in client.list("v1", "Pod"):
                pod.setdefault("status", {})

        def ok_copy(client):
            node = client.get("v1", "Node", "n", copy=True)
            node["metadata"]["labels"]["x"] = "y"

        def ok_thaw(client):
            node = thaw(client.get("v1", "Node", "n"))
            node["x"] = 1

        def ok_unrelated_receiver(job):
            spec = job.get("spec", {})
            spec["x"] = 1
    """,
}
METRICS_FED = {
    "operator_metrics.py": """\
        class M:
            def _init_collectors(self):
                g = lambda *a: None
                self.fed_direct = g("a")
                self.fed_getattr = g("b")
                self.dead_gauge = g("c")
    """,
    "feeder.py": """\
        def feed(m):
            m.fed_direct.set(1)
            hist = getattr(m, "fed_getattr", None)
            if hist:
                hist.observe(2)
    """,
}
FILE_SUPPRESSION = {
    "tpu_operator_torch/kube/scaffold.py": """\
        # lint: ignore-file[layering] deliberate: test scaffolding
        from tpu_operator_torch.controllers import operator_metrics
    """,
}
METRICS_CFG = {"metrics_module": "operator_metrics.py"}

FIXTURES = {
    "layering": (LAYERING, {}),
    "guarded-by": (GUARDED_BY, {}),
    "guarded-by-condition-alias": (CONDITION_ALIAS, {}),
    "lock-order": (LOCK_ORDER, {}),
    "lock-order-multi-item": (LOCK_ORDER_MULTI_ITEM, {}),
    "lock-order-consistent": (LOCK_ORDER_CONSISTENT, {}),
    "lock-blocking": (LOCK_BLOCKING, {}),
    "frozen-view": (FROZEN_VIEW, {}),
    "metrics-fed": (METRICS_FED, METRICS_CFG),
    "file-suppression": (FILE_SUPPRESSION, {}),
}


def _write(root, files, rename=None):
    for rel, source in files.items():
        if rename is not None:
            rel, source = rename(rel), rename(source)
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))


def _run(tmp_path, files, **cfg):
    """Write fixture files under tmp_path and analyze them."""
    _write(tmp_path, files)
    config = AnalysisConfig(repo_root=str(tmp_path), paths=["."], **cfg)
    return run_analysis(config, use_baseline=False)


def _rules(report):
    return [(f.rule, f.path, f.line) for f in report.findings]


# ---------------------------------------------------------------------------
# per-rule seeded violations
# ---------------------------------------------------------------------------


def test_layering_obs_and_kube(tmp_path):
    report = _run(tmp_path, LAYERING)
    found = _rules(report)
    assert ("layering", "tpu_operator_torch/obs/bad.py", 1) in found
    assert ("layering", "tpu_operator_torch/kube/bad.py", 1) in found
    assert ("layering", "tpu_operator_torch/kube/bad.py", 2) in found
    assert ("layering", "tpu_operator_torch/controllers/bad_analysis.py", 1) in found
    assert not any(f.path.endswith("good.py") for f in report.findings)


def test_guarded_by_unlocked_write(tmp_path):
    report = _run(tmp_path, GUARDED_BY)
    guarded = [f for f in report.findings if f.rule == "guarded-by"]
    assert len(guarded) == 1
    assert guarded[0].line == 14  # bad()'s append only
    assert "_items" in guarded[0].message
    assert report.suppressed == 1


def test_guarded_by_condition_alias_and_init_exempt(tmp_path):
    report = _run(tmp_path, CONDITION_ALIAS)
    assert not [f for f in report.findings if f.rule == "guarded-by"]


def test_lock_order_cycle_and_self_deadlock(tmp_path):
    report = _run(tmp_path, LOCK_ORDER)
    order = [f for f in report.findings if f.rule == "lock-order"]
    cycle = [f for f in order if "cycle" in f.message]
    dead = [f for f in order if "self-deadlock" in f.message]
    assert len(cycle) == 1 and "D._a" in cycle[0].message and "D._b" in cycle[0].message
    assert len(dead) == 1 and dead[0].line == 20


def test_lock_order_multi_item_with(tmp_path):
    """`with self._a, self._b:` acquires left-to-right: it must order
    a -> b and cycle against an inverted nesting elsewhere."""
    report = _run(tmp_path, LOCK_ORDER_MULTI_ITEM)
    cycle = [f for f in report.findings if f.rule == "lock-order" and "cycle" in f.message]
    assert len(cycle) == 1


def test_lock_order_consistent_is_clean(tmp_path):
    report = _run(tmp_path, LOCK_ORDER_CONSISTENT)
    assert not [f for f in report.findings if f.rule == "lock-order"]


def test_lock_blocking(tmp_path):
    report = _run(tmp_path, LOCK_BLOCKING)
    blocking = [f for f in report.findings if f.rule == "lock-blocking"]
    assert {(f.line, f.message.split(" while")[0]) for f in blocking} == {
        (11, "blocking call time.sleep()"),
        (15, "blocking call .result()"),
    }


def test_frozen_view(tmp_path):
    report = _run(tmp_path, FROZEN_VIEW)
    frozen = [f for f in report.findings if f.rule == "frozen-view"]
    assert sorted(f.line for f in frozen) == [3, 7]


def test_metrics_fed(tmp_path):
    report = _run(tmp_path, METRICS_FED, **METRICS_CFG)
    fed = [f for f in report.findings if f.rule == "metrics-fed"]
    assert len(fed) == 1
    assert "dead_gauge" in fed[0].message and fed[0].line == 6


# ---------------------------------------------------------------------------
# suppression / baseline / determinism / CLI
# ---------------------------------------------------------------------------


def test_file_level_suppression(tmp_path):
    report = _run(tmp_path, FILE_SUPPRESSION)
    assert not report.findings
    assert report.suppressed == 1


def test_baseline_gates_only_new_findings():
    f1 = Finding("r", "a.py", 3, "msg one", scope="S")
    f2 = Finding("r", "a.py", 9, "msg two", scope="S")
    baseline = {f1.fingerprint(): 1}
    new, baselined = split_baselined([f1, f2], baseline)
    assert baselined == 1 and new == [f2]
    # a second occurrence of a baselined fingerprint is NEW
    new, baselined = split_baselined([f1, f1, f2], baseline)
    assert baselined == 1 and len(new) == 2
    # line drift does not churn the fingerprint
    drifted = Finding("r", "a.py", 33, "msg one", scope="S")
    assert drifted.fingerprint() == f1.fingerprint()


def test_baseline_roundtrip(tmp_path):
    findings = [
        Finding("r", "a.py", 3, "m1", scope="S"),
        Finding("r", "a.py", 3, "m1", scope="S"),
        Finding("q", "b.py", 7, "m2", scope="T"),
    ]
    path = str(tmp_path / "baseline.json")
    write_baseline(path, findings)
    loaded = load_baseline(path)
    assert loaded[findings[0].fingerprint()] == 2
    assert loaded[findings[2].fingerprint()] == 1
    new, baselined = split_baselined(findings, loaded)
    assert not new and baselined == 3


def test_config_parser():
    assert SECTION == "tool.gpu_analysis"
    values = parse_tool_section(
        textwrap.dedent("""\
            [tool.tpu_analysis]
            paths = ["nope"]

            [tool.gpu_analysis]
            paths = ["tpu_operator_torch", "chip_smoke.py"]  # trailing comment
            baseline = "tpu_operator_torch/analysis/baseline.json"
            guarded_by_strict_reads = false
            blocking_methods = [
                "result",
                "drain",
            ]

            [tool.pytest.ini_options]
            testpaths = ["tests"]
        """)
    )
    assert values["paths"] == ["tpu_operator_torch", "chip_smoke.py"]
    assert values["guarded_by_strict_reads"] is False
    assert values["blocking_methods"] == ["result", "drain"]
    assert "testpaths" not in values


def test_repo_config_is_the_ports_defaults():
    """The repo's pyproject carries the reference's section only, so the
    port runs on its own defaults; the knobs the two share are equal."""
    cfg, ref = load_config(REPO_ROOT), RefConfig()
    assert cfg.paths == ["tpu_operator_torch", "chip_smoke.py"]
    assert cfg.baseline == "tpu_operator_torch/analysis/baseline.json"
    assert cfg.metrics_module == "tpu_operator_torch/controllers/operator_metrics.py"
    for knob in ("disable", "guarded_by_strict_reads", "locked_method_suffix",
                 "blocking_methods", "blocking_functions", "frozen_receivers"):
        assert getattr(cfg, knob) == getattr(ref, knob), knob
    with open(os.path.join(REPO_ROOT, cfg.baseline)) as f:
        assert json.load(f) == {"fingerprints": {}, "notes": {}, "version": 1}


def test_cli_exit_codes_and_baseline_flow(tmp_path):
    (tmp_path / "pyproject.toml").write_text(
        '[tool.gpu_analysis]\npaths = ["pkg"]\nbaseline = "bl.json"\n'
    )
    _write(tmp_path / "pkg", {"mod.py": """\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def bad(self, x):
                self._items.append(x)
    """})
    from tpu_operator_torch.analysis.__main__ import main

    root = str(tmp_path)
    assert main(["--repo-root", root]) == 1  # gate bites
    assert main(["--repo-root", root, "--write-baseline"]) == 0
    assert main(["--repo-root", root]) == 0  # baselined now
    data = json.loads((tmp_path / "bl.json").read_text())
    assert data["version"] == 1 and len(data["fingerprints"]) == 1
    assert main(["--repo-root", root, "--no-baseline"]) == 1
    assert main(["--repo-root", root, "--disable", "guarded-by"]) == 0


def test_repo_lint_is_clean_and_deterministic():
    """The port's lint passes on HEAD, and two runs are byte-identical
    (no timestamps/pids/absolute paths in the report)."""
    cmd = [sys.executable, "-m", "tpu_operator_torch.analysis", "--repo-root", REPO_ROOT]
    runs = [
        subprocess.run(cmd, cwd=REPO_ROOT, env=dict(os.environ), capture_output=True, timeout=300)
        for _ in range(2)
    ]
    for r in runs:
        assert r.returncode == 0, r.stdout.decode() + r.stderr.decode()
    assert runs[0].stdout == runs[1].stdout
    assert b"0 finding(s)" in runs[0].stdout


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------


def _to_ref(text):
    return text.replace(PORT_PKG, REF_PKG)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_finds_what_the_reference_finds(tmp_path, name):
    """Each seeded fixture through both analysers: equal findings
    ``(rule, path, line, message)`` and suppression counts. The
    reference's side gets the fixture under its own package name, and its
    findings are read back under the port's."""
    files, cfg = FIXTURES[name]
    _write(tmp_path / "ref", files, rename=_to_ref)
    _write(tmp_path / "port", files)
    ref = ref_run_analysis(RefConfig(repo_root=str(tmp_path / "ref"), paths=["."], **cfg),
                           use_baseline=False)
    port = run_analysis(AnalysisConfig(repo_root=str(tmp_path / "port"), paths=["."], **cfg),
                        use_baseline=False)

    def seen(report, rename):
        return [(f.rule, rename(f.path), f.line, rename(f.message)) for f in report.findings]

    ported = seen(ref, lambda s: s.replace(REF_PKG, PORT_PKG))
    assert seen(port, str) == ported
    assert (port.suppressed, port.files_scanned) == (ref.suppressed, ref.files_scanned)
    if name not in ("guarded-by-condition-alias", "lock-order-consistent"):
        assert port.findings or port.suppressed  # every seeded fixture bites


# ---------------------------------------------------------------------------
# the repairs the clean lint needed
# ---------------------------------------------------------------------------


def test_kubesim_host_cards_without_workloads_import():
    """KubeSim reads its host width through ``kube/testing.py`` now; the
    value is the board's card count, as when it imported ``workloads/``."""
    from tpu_operator_torch.kube import kubesim, testing
    from tpu_operator_torch.workloads.topology import CARDS_PER_HOST

    assert kubesim.HOST_CARDS == CARDS_PER_HOST[testing.DEFAULT_VARIANT] == testing.HOST_CARDS
