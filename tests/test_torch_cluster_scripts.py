"""The port's cluster scripts against the reference's, on the model of
``tests/test_torch_must_gather.py``: ``tpu_operator_torch/e2e/`` (``local.sh``,
``cases/``, ``scripts/end-to-end.sh`` with ``checks.sh``, ``gke/``) and
``tpu_operator_torch/deploy/scripts/install-gpu-operator.sh`` against
``tests/local.sh``, ``tests/cases/``, ``tests/scripts/``, ``tests/gke/`` and
``scripts/install-tpu-operator.sh``.

Each script runs on both packages against one recording stub, installed as
``kubectl``, ``helm``, ``gcloud`` and ``sleep`` first on ``PATH`` (polls at
``POLL_S=0``): a cluster where every poll reads ready. The port's recorded
calls equal the reference's under the rename (the operand apps through
``consts.OPERAND_APPS``, the chart's sections, the release, the workload
pod, the node pool's accelerator), paths read relative to the repo. The
reference's failure paths give the same exit code and message on both.
Every run has a time limit; no cloud or cluster is reached.
"""

import os
import re
import shutil
import stat
import subprocess

import pytest

from tpu_operator_torch import consts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60
SCRIPTS = {
    "reference": {"e2e": "tests/scripts/end-to-end.sh", "checks": "tests/scripts/checks.sh",
                  "install": "scripts/install-tpu-operator.sh", "up": "tests/gke/cluster-up.sh",
                  "down": "tests/gke/cluster-down.sh", "local": "tests/local.sh"},
    "port": {"e2e": "tpu_operator_torch/e2e/scripts/end-to-end.sh", "checks": "tpu_operator_torch/e2e/scripts/checks.sh",
             "install": "tpu_operator_torch/deploy/scripts/install-gpu-operator.sh",
             "up": "tpu_operator_torch/e2e/gke/cluster-up.sh", "down": "tpu_operator_torch/e2e/gke/cluster-down.sh",
             "local": "tpu_operator_torch/e2e/local.sh"},
}
NEW_SCRIPTS = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for top in ("tpu_operator_torch/e2e", "tpu_operator_torch/deploy/scripts", "tpu_operator_torch/deploy/docker")
    for d, _, fs in os.walk(os.path.join(REPO, top)) for f in fs if f.endswith(".sh"))

# one stub for every tool: records its name and arguments, tab-separated,
# and answers as a cluster where everything is ready; the STUB_* variables
# turn on the reference's failure paths
STUB = r"""#!/usr/bin/env bash
# a pipe's reader records after its writer: read stdin to its end first
case "$*" in *"apply -f -"*) cat > /dev/null ;; esac
{ printf '%s' "$(basename "$0")"; for a in "$@"; do printf '\t%s' "$a"; done; printf '\n'; } >> "$STUB_LOG"
case "$(basename "$0") $*" in
  "sleep "*|"helm "*|"gcloud "*|"python3 "*) ;;
  *"{.items[*].metadata.name}"*) echo "pod-a" ;;
  *'@.type=="Ready"'*) echo "${STUB_READY:-True}" ;;
  *"{.items[0].status.state}"*) echo "ready" ;;
  *"{.items[*].metadata.uid}"*)
    n=$(($(cat "$STUB_LOG.uid" 2>/dev/null || echo 0) + 1)); echo "$n" > "$STUB_LOG.uid"
    if [ -n "${STUB_UID_CHANGES:-}" ]; then echo "uid-$n"; else echo "uid-1"; fi ;;
  *"{.status.phase}"*) echo "Succeeded" ;;
  *"kubectl logs "*) echo "OK 2048.0 card" ;;
  *"initContainers[*].name}"*)
    if [ -n "${STUB_NO_RINGATTN:-}" ]; then echo "cuda-validation"; else echo "cuda-validation ringattn-validation"; fi ;;
  *" get ds "*) [ -n "${STUB_EXPORTER_LEFT:-}" ] || exit 1 ;;
  *" get namespace "*) exit 1 ;;
  *"create secret"*) echo "kind: Secret" ;;
esac
"""
STUB_TOOLS = ("kubectl", "helm", "gcloud", "sleep")

# the reference's names as the port's, in order: paths, the operand apps
# (longest first), the workload pod, the chart's sections, the release, the
# node pool
E2E_RENAMES = (
    ("deployments/tpu-operator", "tpu_operator_torch/deploy/gpu-operator"),
    ("tests/tpu-pod.yaml", "tpu_operator_torch/deploy/gpu-pod.yaml"),
) + tuple(sorted(consts.OPERAND_APPS.items(), key=lambda kv: -len(kv[0]))) + (
    ("jax-matmul", "torch-matmul"),
    ("libtpu.", "driver."),
    ("runtime.", "toolkit."),
    ("tpu-operator", "gpu-operator"),
    ("tpu-pool", "gpu-pool"),
    ("--tpu-topology", "--accelerator"),
)


def as_port(calls: list) -> list:
    out = []
    for call in calls:
        toks = []
        for tok in call:
            for old, new in E2E_RENAMES:
                tok = tok.replace(old, new)
            toks.append(tok)
        out.append(toks)
    return out


def run(tmp_path, side, script, *args, env=None, tools=STUB_TOOLS):
    """``script`` of ``side`` with the stub first on PATH, from the repo root:
    (rc, stdout, stderr, recorded calls with paths relative to the repo)."""
    stubs = tmp_path / f"stubs-{side}"
    stubs.mkdir(exist_ok=True)
    for tool in tools:
        path = stubs / tool
        path.write_text(STUB)
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    path_var = f"{stubs}{os.pathsep}{os.environ['PATH']}"
    for tool in tools:
        assert shutil.which(tool, path=path_var) == str(stubs / tool)  # never a real cloud or cluster client
    log = tmp_path / f"calls-{side}.log"
    full_env = dict(os.environ, PATH=path_var, STUB_LOG=str(log), POLL_S="0", CLOUDSDK_CONFIG=str(tmp_path / "gcloud"))
    full_env.update(env or {})
    proc = subprocess.run(["bash", os.path.join(REPO, SCRIPTS[side][script]), *args], capture_output=True,
                          text=True, timeout=TIMEOUT_S, cwd=REPO, env=full_env)
    calls = []
    if log.exists():
        for line in log.read_text().splitlines():
            toks = []
            for tok in line.split("\t"):
                path = tok if os.path.isabs(tok) else os.path.join(REPO, tok)
                if "/" in tok and os.path.exists(path):
                    tok = os.path.relpath(os.path.realpath(path), REPO)
                toks.append(tok)
            calls.append(toks)
    return proc.returncode, proc.stdout, proc.stderr, calls


def both(tmp_path, script, *args, env=None, port_env=None, ref_env=None, tools=STUB_TOOLS):
    ref = run(tmp_path, "reference", script, *args, env={**(env or {}), **(ref_env or {})}, tools=tools)
    port = run(tmp_path, "port", script, *args, env={**(env or {}), **(port_env or {})}, tools=tools)
    return ref, port


def message(stderr: str) -> str:
    """The last line of stderr without bash's ``<script>: line N:`` prefix."""
    return re.sub(r"^.*?: line \d+: ", "", stderr.strip().splitlines()[-1])


@pytest.mark.parametrize("path", NEW_SCRIPTS)
def test_new_scripts_parse_under_bash_n(path):
    proc = subprocess.run(["bash", "-n", os.path.join(REPO, path)], capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    assert os.access(os.path.join(REPO, path), os.X_OK), path


def test_checks_keep_the_reference_s_timeouts_and_messages():
    def code(side):
        with open(os.path.join(REPO, SCRIPTS[side]["checks"])) as f:
            return [line for line in f.read().splitlines() if line.strip() and not line.lstrip().startswith("#")]

    assert code("port") == code("reference")


E2E_ENV = {"TEST_NAMESPACE": "e2e-ns"}


@pytest.mark.parametrize("how", [("e2e",), ("local", "defaults"), ("local", "sandbox")])
def test_end_to_end_issues_the_reference_s_calls(tmp_path, how):
    (ref_rc, ref_out, ref_err, ref_calls), (rc, out, err, calls) = both(tmp_path, *how, env=E2E_ENV)
    assert (ref_rc, rc) == (0, 0), (ref_err, err)
    assert out.strip().splitlines()[-1] == ref_out.strip().splitlines()[-1] == "E2E PASSED"
    assert calls == as_port(ref_calls)
    helm = [c for c in calls if c[0] == "helm"]
    assert helm[0][:4] == ["helm", "upgrade", "--install", "gpu-operator"]
    assert helm[0][4] == "tpu_operator_torch/deploy/gpu-operator"
    assert ("--set" in helm[0]) == (how[-1] == "sandbox")
    assert ["kubectl", "apply", "-f", "tpu_operator_torch/deploy/gpu-pod.yaml"] in calls
    ds = {c[c.index("ds") + 1] for c in calls if "ds" in c}
    assert ds == {consts.OPERAND_APPS["tpu-metrics-exporter"], consts.VALIDATOR_APP}


def test_end_to_end_defaults_to_the_port_s_namespace(tmp_path):
    rc, _, err, calls = run(tmp_path, "port", "e2e")
    assert rc == 0, err
    namespaces = {c[c.index("-n") + 1] for c in calls if "-n" in c}
    assert namespaces == {consts.DEFAULT_NAMESPACE}


@pytest.mark.parametrize("fault,env", [
    ("operands restarted by an operator restart", {"STUB_UID_CHANGES": "1"}),
    ("the exporter left after disable", {"STUB_EXPORTER_LEFT": "1"}),
    ("no ringattn-validation after enable", {"STUB_NO_RINGATTN": "1"}),
    ("a pod never Ready", {"STUB_READY": "False", "TIMEOUT_S": "1"}),
])
def test_end_to_end_failure_paths_match(tmp_path, fault, env):
    (ref_rc, _, ref_err, _), (rc, _, err, _) = both(tmp_path, "e2e", env={**E2E_ENV, **env})
    assert (ref_rc, rc) == (1, 1), fault
    assert message(err) == as_port([[message(ref_err)]])[0][0], fault


INSTALL_ENV = {"OPERATOR_NAMESPACE": "ops-ns", "REGISTRY": "registry.example.com/team", "VERSION": "1.2.3",
               "REGISTRY_SECRET": "pull", "EXTRA_HELM_ARGS": "--timeout 5m"}


def test_install_issues_the_reference_s_calls(tmp_path):
    key = tmp_path / "key.json"
    key.write_text("KEY")
    env = dict(INSTALL_ENV, REGISTRY_JSON_KEY=str(key))
    (ref_rc, _, ref_err, ref_calls), (rc, out, err, calls) = both(
        tmp_path, "install", env=env, ref_env={"LIBTPU_VERSION": "9.9"}, port_env={"DRIVER_VERSION": "9.9"})
    assert (ref_rc, rc) == (0, 0), (ref_err, err)
    assert calls == as_port(ref_calls)
    (helm,) = [c for c in calls if c[0] == "helm"]
    assert helm[3:5] == ["gpu-operator", "tpu_operator_torch/deploy/gpu-operator"]
    sections = [s.split(".")[0] for s in helm if s.endswith(".repository=registry.example.com/team")]
    assert "driver" in sections and "toolkit" in sections and len(sections) == 15
    assert "driver.version=9.9" in helm
    assert "gpu-operator deployed to namespace ops-ns" in out


def test_install_defaults_are_the_port_s(tmp_path):
    rc, _, err, calls = run(tmp_path, "port", "install")
    assert rc == 0, err
    (helm,) = [c for c in calls if c[0] == "helm"]
    assert helm[helm.index("--namespace") + 1] == consts.DEFAULT_NAMESPACE
    assert f"operatorDeployment.repository={consts.DEFAULT_REGISTRY}" in helm


def test_install_secret_without_its_key_fails_as_the_reference(tmp_path):
    (ref_rc, _, ref_err, _), (rc, _, err, calls) = both(tmp_path, "install", env={"REGISTRY_SECRET": "pull"})
    assert (ref_rc, rc) == (1, 1)
    assert message(err) == message(ref_err) == \
        "REGISTRY_JSON_KEY: REGISTRY_SECRET set but REGISTRY_JSON_KEY (key file) missing"
    assert not any(c[0] == "helm" for c in calls)


GKE_ENV = {"GCP_PROJECT": "proj", "CLUSTER_NAME": "e2e", "ZONE": "zone-a", "MACHINE_TYPE": "mt", "NUM_NODES": "2",
           "RELEASE_CHANNEL": "regular"}


@pytest.mark.parametrize("script", ["up", "down"])
def test_gke_scripts_issue_the_reference_s_calls(tmp_path, script):
    (ref_rc, _, ref_err, ref_calls), (rc, _, err, calls) = both(
        tmp_path, script, env=GKE_ENV, ref_env={"TPU_TOPOLOGY": "acc"}, port_env={"ACCELERATOR": "acc"})
    assert (ref_rc, rc) == (0, 0), (ref_err, err)
    assert calls == as_port(ref_calls)
    assert all(c[0] == "gcloud" for c in calls) and calls


def test_gke_defaults_make_an_h100_pool_without_a_driver(tmp_path):
    rc, _, err, calls = run(tmp_path, "port", "up", env={"GCP_PROJECT": "proj"})
    assert rc == 0, err
    (pool,) = [c for c in calls if c[1:4] == ["container", "node-pools", "create"]]
    assert pool[pool.index("--machine-type") + 1] == "a3-highgpu-1g"
    assert pool[pool.index("--accelerator") + 1] == "type=nvidia-h100-80gb,count=1,gpu-driver-version=disabled"
    assert pool[pool.index("--cluster") + 1] == "gpu-operator-e2e"


@pytest.mark.parametrize("script", ["up", "down"])
def test_gke_scripts_need_a_project_as_the_reference(tmp_path, script):
    (ref_rc, _, ref_err, _), (rc, _, err, calls) = both(tmp_path, script)
    assert (ref_rc, rc) == (1, 1)
    assert message(err) == message(ref_err) == "GCP_PROJECT: set GCP_PROJECT"
    assert calls == []


def test_local_refuses_an_unknown_case_as_the_reference(tmp_path):
    (ref_rc, _, ref_err, _), (rc, _, err, _) = both(tmp_path, "local", "nope")
    assert (ref_rc, rc) == (2, 2)
    assert message(err) == message(ref_err) == "unknown case: nope (want fake|defaults|sandbox)"


def test_local_fake_runs_the_port_s_driver(tmp_path):
    import importlib.util

    rc, _, err, calls = run(tmp_path, "port", "local", "fake", tools=STUB_TOOLS + ("python3",))
    assert rc == 0, err
    assert calls == [["python3", "-m", "tpu_operator_torch.e2e.fake_e2e"]]
    spec = importlib.util.find_spec("tpu_operator_torch.e2e.fake_e2e")
    with open(spec.origin) as f:
        assert 'if __name__ == "__main__":' in f.read()


def test_package_data_carries_the_scripts():
    """An installed ``tpu_operator_torch`` carries every new script."""
    import fnmatch
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"]["tpu_operator_torch"]
    for path in NEW_SCRIPTS:
        rel = os.path.relpath(path, "tpu_operator_torch")
        assert any(fnmatch.fnmatch(rel, p) and rel.count("/") == p.count("/") for p in patterns), rel
