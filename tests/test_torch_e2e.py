"""The port's end-to-end drivers (``tpu_operator_torch/e2e``): the HTTP
driver against KubeSim in a subprocess, the fake-cluster driver with its
four parallelism probes on the CPU (two gloo ranks), and both holding the
reference's steps (``tests/scripts/http_e2e.py``, ``fake_e2e.py``) in the
reference's order, read from the sources without importing them."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = re.compile(r'print\(\s*f?"=== ([^"]*)"')
# the port's words for the reference's, in step headers
RENAME = (("libtpu", "driver"), ("TPU", "GPU"))


def _steps(path, rename=False):
    """Each ``=== `` header's step name (the text before its ``(``
    gloss), in source order."""
    with open(path, encoding="utf-8") as f:
        headers = HEADER.findall(f.read())
    steps = []
    for h in headers:
        if rename:
            for old, new in RENAME:
                h = h.replace(old, new)
        steps.append(h.split(" (")[0])
    return steps


@pytest.mark.parametrize("name", ["http_e2e", "fake_e2e"])
def test_drivers_keep_the_reference_steps_in_order(name):
    ref = _steps(os.path.join(REPO, "tests", "scripts", f"{name}.py"), rename=True)
    port = _steps(os.path.join(REPO, "tpu_operator_torch", "e2e", f"{name}.py"))
    assert len(ref) >= 10
    assert port == ref


def test_http_e2e_passes():
    env = dict(os.environ, OPERATOR_NAMESPACE="tpu-operator", UNIT_TEST="true")
    # subprocess isolation: the driver starts an HTTP server and operator
    # loops that must not leak threads into other tests
    res = subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.e2e.http_e2e"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr}"
    assert "HTTP-E2E PASSED" in res.stdout
    assert _steps(os.path.join(REPO, "tpu_operator_torch", "e2e", "http_e2e.py"))[1:] == [
        line[len("=== "):].split(" (")[0] for line in res.stdout.splitlines()
        if line.startswith("=== ")
    ][1:]


def test_fake_e2e_passes_with_probes_on_the_cpu(monkeypatch, capsys):
    from tpu_operator_torch.e2e import fake_e2e

    monkeypatch.setenv("OPERATOR_NAMESPACE", "tpu-operator")
    monkeypatch.setenv("UNIT_TEST", "true")
    assert fake_e2e.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert "FAKE-E2E PASSED" in out
    assert "ok: all parallelism probes passed on the CPU, 2 gloo ranks" in out


def test_fake_e2e_probe_placement_is_explicit(monkeypatch):
    import torch

    from tpu_operator_torch.e2e import fake_e2e

    assert fake_e2e.probe_args("cpu") == ["--allow-cpu", "--expect-devices", "2"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="no card visible"):
        fake_e2e.probe_args(None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert fake_e2e.probe_args("cuda") == ["--expect-devices", "4"]
    with pytest.raises(ValueError):
        fake_e2e.probe_args("tpu")
