"""The reference's ``tests/test_must_gather.py`` on both scripts: the
reference's ``hack/must-gather.sh`` and the port's
``tpu_operator_torch/deploy/must-gather.sh``, each with its own stub
``kubectl`` answering the same canned output under the rename (operand
apps through ``consts.OPERAND_APPS``, ``google.com/tpu`` as
``nvidia.com/gpu``, the upgrade FSM's label and the status files).

One case holds the port's recorded kubectl calls against the
reference's under the same rename, the GKE topology column (which names
no label the port's nodes carry) left out; one checks the port's script
parses under ``bash -n``."""

import os
import re
import stat
import subprocess
import tarfile

import pytest

from tpu_operator_torch import consts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SCRIPT = os.path.join(REPO, "hack", "must-gather.sh")
PORT_SCRIPT = os.path.join(REPO, "tpu_operator_torch", "deploy", "must-gather.sh")
TIMEOUT_S = 60

REF_STUB = """#!/usr/bin/env bash
# records each invocation; emits canned output ('echo "$@"' would eat a
# leading -n flag, so printf)
printf '%s\\n' "$*" >> "$STUB_LOG"
case "$*" in
  *"get pods -l app=tpu-node-status-exporter -o name"*)
    echo "pod/tpu-node-status-exporter-n1" ;;
  *"get pods -o name"*) echo "pod/tpu-operator-abc"; echo "pod/tpu-libtpu-xyz" ;;
  *"get daemonsets -o name"*) echo "daemonset.apps/tpu-device-plugin" ;;
  *"-o jsonpath={.spec.nodeName}"*) echo "node-1" ;;
  *".spec.containers[*].name}"*) echo "main sidecar" ;;
  *"logs -c "*"--previous"*)
    # only the operator pod's main container has a previous incarnation
    case "$*" in
      *"-c main"*tpu-operator-abc*) echo "previous log line" ;;
      *) echo "no previous" >&2; exit 1 ;;
    esac ;;
  *logs*) echo "log line" ;;
  *exec*) echo "-rw-r--r-- libtpu-ready"; echo "--- /run/tpu/validations/libtpu-ready"; echo '{"ok": true}' ;;
  *"get clusterpolicies.tpu.k8s.io -o name"*) echo "clusterpolicy.tpu.k8s.io/cp" ;;
  *) echo "kind: List" ;;
esac
"""
REF_EXEC_LINE = ('*exec*) echo "-rw-r--r-- libtpu-ready"; echo "--- /run/tpu/validations/libtpu-ready"; '
                 'echo \'{"ok": true}\' ;;')

# the reference's names as the port's: the stub's pods and DaemonSet, the
# operand apps, the resource, the upgrade FSM's label, the status file,
# the node files and their column headers
NAME_RENAMES = (
    ("tpu-operator-abc", "gpu-operator-abc"),
    ("tpu-libtpu-xyz", "gpu-driver-xyz"),
    ("daemonset.apps/tpu-device-plugin", "daemonset.apps/gpu-device-plugin"),
    ("libtpu-ready", consts.STATUS_FILE_DRIVER),
    ("tpu-capacity.txt", "gpu-capacity.txt"),
    ("tpu-nodes.descr", "gpu-nodes.descr"),
    ("ds-tpu-device-plugin", "ds-gpu-device-plugin"),
) + tuple(sorted(((f"app={old}", f"app={new}") for old, new in consts.OPERAND_APPS.items()), reverse=True)) + (
    ("tpu-node-status-exporter-n1", "gpu-node-status-exporter-n1"),
    ("google\\.com/tpu", consts.GPU_RESOURCE.replace(".", "\\.")),
    ("tpu\\.k8s\\.io/libtpu-upgrade-state", consts.UPGRADE_STATE_LABEL.replace(".", "\\.")),
    ("TPU:.metadata", "GPU:.metadata"),
    ("TPUCAP:", "GPUCAP:"),
    ("TPUALLOC:", "GPUALLOC:"),
)
# the GKE topology column: the port's nodes carry no such label
GKE_TOPOLOGY_COLUMN = r",TOPO:\.metadata\.labels\.cloud\\\.google\\\.com/gke-tpu-topology"


def as_port(text: str) -> str:
    for old, new in NAME_RENAMES:
        text = text.replace(old, new)
    return text


PORT_STUB = as_port(REF_STUB)


@pytest.fixture(params=["reference", "port"])
def side(request):
    if request.param == "reference":
        return {"script": REF_SCRIPT, "stub": REF_STUB, "map": lambda s: s}
    return {"script": PORT_SCRIPT, "stub": PORT_STUB, "map": as_port}


def run_script(tmp_path, script, stub, env_extra=None):
    kubectl = tmp_path / "kubectl"
    kubectl.write_text(stub)
    kubectl.chmod(kubectl.stat().st_mode | stat.S_IEXEC)
    out = tmp_path / "bundle"
    log = tmp_path / "calls.log"
    env = dict(os.environ, KUBECTL=str(kubectl), ARTIFACT_DIR=str(out), OPERATOR_NAMESPACE="tpu-ns",
               STUB_LOG=str(log), VERSION="v0.2.0", **(env_extra or {}))
    res = subprocess.run(["bash", script], env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    return res, out, log


def test_must_gather_collects(side, tmp_path):
    res, out, log = run_script(tmp_path, side["script"], side["stub"])
    assert res.returncode == 0, res.stderr
    for f in (
        "version",
        "must-gather.log",
        "cluster/version.yaml",
        "cluster/clusterpolicy.yaml",
        "cluster/crd.yaml",
        "cluster/events.txt",
        "nodes/nodes.yaml",
        "nodes/node-labels.txt",
        "nodes/node-os-info.txt",
        "nodes/tpu-capacity.txt",
        "nodes/tpu-nodes.descr",
        "nfd/nodefeatures.yaml",
        "nfd/nodefeaturerules.yaml",
        "slices/slice-status.json",
        "slices/slice-configmaps.yaml",
        "operator/daemonsets.yaml",
        "operator/ds-tpu-device-plugin.descr",
        "operator/events.txt",
        "operator/pod-images.txt",
    ):
        assert (out / side["map"](f)).exists(), f
    header = (out / "version").read_text().splitlines()
    assert header[1] == "v0.2.0"
    assert header[0] == ("TPU Operator" if side["script"] == REF_SCRIPT else "GPU Operator")


def test_must_gather_pod_logs_including_previous(side, tmp_path):
    res, out, log = run_script(tmp_path, side["script"], side["stub"])
    assert res.returncode == 0, res.stderr
    m = side["map"]
    logs = out / "pod-logs"
    assert (logs / m("tpu-operator-abc.log")).exists()
    assert (logs / m("tpu-libtpu-xyz.log")).exists()
    assert (logs / m("tpu-operator-abc.descr")).exists()
    # previous logs per container, kept only where a previous incarnation
    # existed
    assert (logs / m("tpu-operator-abc.main.previous.log")).exists()
    assert not (logs / m("tpu-operator-abc.sidecar.previous.log")).exists()
    assert not (logs / m("tpu-libtpu-xyz.main.previous.log")).exists()
    calls = log.read_text()
    assert "logs -c main --previous" in calls
    assert "logs -c sidecar --previous" in calls


def test_must_gather_host_validations_and_tarball(side, tmp_path):
    res, out, log = run_script(tmp_path, side["script"], side["stub"])
    assert res.returncode == 0, res.stderr
    m = side["map"]
    vals = (out / "validations" / "node-1.txt").read_text()
    assert m("libtpu-ready") in vals and '{"ok": true}' in vals
    assert m("exec tpu-node-status-exporter-n1") in log.read_text()
    tarball = tmp_path / "bundle.tar.gz"
    assert tarball.exists()
    with tarfile.open(tarball) as t:
        names = t.getnames()
    assert any(n.endswith("nodes/node-labels.txt") for n in names)


def test_must_gather_fails_without_kubectl(side, tmp_path):
    env = dict(os.environ, KUBECTL=str(tmp_path / "missing-kubectl"), ARTIFACT_DIR=str(tmp_path / "bundle2"))
    res = subprocess.run(["bash", side["script"]], env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 1
    assert "not working" in res.stderr


def test_must_gather_empty_validations_not_reported_as_exec_failure(side, tmp_path):
    """A node with no validation files yet reads as 'empty', not as an
    exec failure (the remote glob test must not set the exit code)."""
    stub = side["stub"].replace(side["map"](REF_EXEC_LINE), '*"exit 0"*) exit 0 ;;')
    assert stub != side["stub"]
    res, out, _ = run_script(tmp_path, side["script"], stub)
    assert res.returncode == 0, res.stderr
    assert "exec failed" not in (out / "validations" / "node-1.txt").read_text()


def test_port_calls_are_the_reference_s_under_the_rename(tmp_path):
    """The port's script issues the reference's kubectl calls, in order,
    under the rename, the GKE topology column left out; the node-label
    columns name the port's label bus."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref, _, ref_log = run_script(tmp_path / "ref", REF_SCRIPT, REF_STUB)
    port, out, port_log = run_script(tmp_path / "port", PORT_SCRIPT, PORT_STUB)
    assert ref.returncode == port.returncode == 0, (ref.stderr, port.stderr)
    ref_calls = ref_log.read_text().replace(str(tmp_path / "ref"), "<tmp>")
    port_calls = port_log.read_text().replace(str(tmp_path / "port"), "<tmp>")
    assert re.search(GKE_TOPOLOGY_COLUMN, ref_calls)
    assert port_calls.splitlines() == as_port(re.sub(GKE_TOPOLOGY_COLUMN, "", ref_calls)).splitlines()
    labels = next(line for line in port_calls.splitlines() if "NAME:.metadata.name,GPU:" in line)
    for label in (consts.TPU_PRESENT_LABEL, consts.GENERATION_LABEL, consts.TFD_SLICE_ID_LABEL,
                  consts.SLICE_READY_LABEL, consts.SLICE_CONFIG_STATE_LABEL, consts.UPGRADE_STATE_LABEL):
        assert label.replace(".", "\\.") in labels, label
    assert consts.VALIDATION_DIR in port_calls
    assert "google" not in port_calls and "libtpu" not in port_calls


def test_port_script_parses():
    res = subprocess.run(["bash", "-n", PORT_SCRIPT], capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr
    assert os.access(PORT_SCRIPT, os.X_OK)
