"""The port's own operand assets (``tpu_operator_torch/assets/``) and the
rollout ledger's head (``controllers/rollout.py``) against the JAX
package's.

Assets: the port carries the reference's 18 state directories and 63 file
names; the port's loader (``controllers/resource_manager.py``) gives, state
by state, the kinds and the order of controls the reference's loader gives
for the reference's directory; and no file names the TPU's resource, its
libtpu images or its validator. Every DaemonSet's name and ``app`` are a
value of ``consts.OPERAND_APPS``, its node selector the label bus, and it
tolerates ``nvidia.com/gpu``. The wheel carries the YAML
(``pyproject.toml``'s package data).

Rollout: ``apply_override`` on one CR through
``convert.clusterpolicy_from_reference`` pins the same effective version
on both sides, the cases of ``tests/test_rollout.py:265-290``, and the
ledger's kind crosses both ways. Tolerance: exact equality.
"""

import json
import os
import re

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator.controllers import resource_manager as ref_rm, rollout as ref_ro, state_manager as ref_sm
from tpu_operator_torch import consts, convert
from tpu_operator_torch.controllers import resource_manager as rm, rollout as ro, state_manager as sm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ASSETS = os.path.join(REPO, "assets")
ASSETS = sm.PACKAGE_ASSETS_DIR


def _files(root):
    return {state: sorted(os.listdir(os.path.join(root, state))) for state in sorted(os.listdir(root))}


def test_the_port_carries_the_reference_directories_and_file_names():
    assert _files(ASSETS) == _files(REF_ASSETS)
    assert sorted(_files(ASSETS)) == sorted(sm.STATE_ORDER)
    assert sum(len(v) for v in _files(ASSETS).values()) == 63
    assert ASSETS == os.path.join(REPO, "tpu_operator_torch", "assets")


@pytest.mark.parametrize("state", ref_sm.STATE_ORDER)
@pytest.mark.parametrize("openshift", [False, True])
def test_each_state_loads_the_reference_kinds_in_order(state, openshift):
    ref_res, ref_controls = ref_rm.add_resources_controls(os.path.join(REF_ASSETS, state), openshift)
    res, controls = rm.add_resources_controls(os.path.join(ASSETS, state), openshift)
    assert [(c, o["kind"]) for c, o in controls] == [(c, o["kind"]) for c, o in ref_controls]
    assert {k: len(v) for k, v in res.by_kind.items()} == {k: len(v) for k, v in ref_res.by_kind.items()}


def test_no_file_names_the_tpu():
    """No TPU resource, libtpu image, TPU validator or JAX component left:
    every line that names the accelerator names the card."""
    banned = re.compile(r"google\.com/tpu|libtpu-installer|tpu-libtpu|tpu-validator|--component (jax|libtpu|runtime)"
                        r"|jax-validation|/home/kubernetes/lib/tpu|tpu-device-plugin|gcr\.io/.*tpu-")
    for state, names in _files(ASSETS).items():
        for name in names:
            with open(os.path.join(ASSETS, state, name)) as f:
                for n, line in enumerate(f, 1):
                    assert not banned.search(line), f"{state}/{name}:{n}: {line.strip()}"


def test_daemonsets_carry_the_port_names():
    apps = set(consts.OPERAND_APPS.values())
    seen = set()
    for state in sm.STATE_ORDER:
        res, _ = rm.add_resources_controls(os.path.join(ASSETS, state))
        for ds in res.of("DaemonSet"):
            name = ds["metadata"]["name"]
            seen.add(name)
            assert name in apps and ds["metadata"]["labels"]["app"] == name
            assert ds["spec"]["selector"]["matchLabels"]["app"] == name
            spec = ds["spec"]["template"]["spec"]
            assert all(k.startswith(consts.DEPLOY_LABEL_PREFIX) for k in spec["nodeSelector"])
            assert {"key": consts.GPU_RESOURCE, "operator": "Exists", "effect": "NoSchedule"} in spec["tolerations"]
    assert seen == apps


def test_the_validator_chain_runs_the_port_components():
    res, _ = rm.add_resources_controls(os.path.join(ASSETS, "state-operator-validation"))
    ds = res.first("DaemonSet")
    inits = ds["spec"]["template"]["spec"]["initContainers"]
    assert [c["name"] for c in inits] == ["driver-validation", "toolkit-validation", "plugin-validation",
                                          "cuda-validation"]
    assert [c["args"][0].split()[:3] for c in inits] == [["gpu-validator", "--component", n]
                                                        for n in ("driver", "toolkit", "plugin", "cuda")]
    stop = " ".join(ds["spec"]["template"]["spec"]["containers"][0]["lifecycle"]["preStop"]["exec"]["command"])
    for name in (consts.STATUS_FILE_DRIVER, consts.STATUS_FILE_TOOLKIT, consts.STATUS_FILE_PLUGIN,
                 consts.STATUS_FILE_CUDA):
        assert f"{consts.VALIDATION_DIR}/{name}" in stop


def test_the_wheel_carries_the_assets_and_the_validator_script():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert 'gpu-validator = "tpu_operator_torch.validator.main:main"' in text
    assert re.search(r'tpu_operator_torch = \[[^\]]*"assets/\*/\*\.yaml"', text)


def test_default_assets_dir_is_the_package_s_own(monkeypatch, tmp_path):
    from tpu_operator_torch.kube.client import FakeClient

    assert sm.ClusterPolicyController(FakeClient()).assets_dir in (sm.DEFAULT_ASSETS_DIR, ASSETS)
    if not os.path.isdir(sm.DEFAULT_ASSETS_DIR):
        assert sm.ClusterPolicyController(FakeClient()).assets_dir == ASSETS
    monkeypatch.setattr(sm, "DEFAULT_ASSETS_DIR", str(tmp_path))
    assert sm.ClusterPolicyController(FakeClient()).assets_dir == str(tmp_path)
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, "ns")
    c = sm.ClusterPolicyController(FakeClient())
    with pytest.raises(FileNotFoundError, match="asset dir missing"):
        c.init({"metadata": {"name": "cluster-policy"}, "spec": {}})


# ---------------------------------------------------------------------------
# the rollout ledger's head
# ---------------------------------------------------------------------------


def _ref_cp(version, state="rolled-back", kind="libtpu", target="2.0", previous="1.0"):
    rec = {"kind": kind, "target": target, "previous": previous, "state": state}
    return {"metadata": {"annotations": {ref_consts.ROLLOUT_STATE_ANNOTATION: json.dumps(rec)}},
            "spec": {"libtpu": {"version": version}, "sliceManager": {"config": {"default": "all-1x1"}}}}


@pytest.mark.parametrize("version,state,want", [
    ("2.0", "rolled-back", "1.0"),  # pinned while rolled back
    ("3.0", "rolled-back", "3.0"),  # the user moved on: the override lapses
    ("2.0", "rolling", "2.0"),  # no rollback in force
    ("2.0", "paused", "2.0"),
])
def test_apply_override_pins_previous_version_only_while_rolled_back(version, state, want):
    ref_cp = _ref_cp(version, state)
    port_cp = convert.clusterpolicy_from_reference(ref_cp)
    ref_raw = ref_ro.apply_override(ref_cp)
    raw = ro.apply_override(port_cp)
    assert raw == {ro.KIND_DRIVER: ref_raw[ref_ro.KIND_LIBTPU], ro.KIND_LAYOUT: ref_raw[ref_ro.KIND_LAYOUT]}
    assert raw[ro.KIND_DRIVER] == version
    assert ref_cp["spec"]["libtpu"]["version"] == port_cp["spec"]["driver"]["version"] == want


def test_apply_override_layout_kind():
    ref_cp = _ref_cp("2.0", kind="layout", target="all-1x1", previous="all-balanced")
    port_cp = convert.clusterpolicy_from_reference(ref_cp)
    ref_ro.apply_override(ref_cp)
    ro.apply_override(port_cp)
    assert ref_cp["spec"]["sliceManager"] == port_cp["spec"]["sliceManager"]
    assert port_cp["spec"]["sliceManager"]["config"]["default"] == "all-balanced"


def test_ledger_kind_crosses_both_ways():
    ref_cp = _ref_cp("2.0")
    port_cp = convert.clusterpolicy_from_reference(ref_cp)
    rec = ro.load_record(port_cp)
    assert rec["kind"] == ro.KIND_DRIVER == "driver" and rec["target"] == "2.0"
    back = convert.clusterpolicy_to_reference(port_cp)
    assert ref_ro.load_record(back) == ref_ro.load_record(ref_cp)
    assert consts.ROLLOUT_STATE_ANNOTATION == ref_consts.ROLLOUT_STATE_ANNOTATION


@pytest.mark.parametrize("raw", [None, "", "{not json", json.dumps({"kind": "driver"}), json.dumps([1])])
def test_load_record_reads_garbled_as_none(raw):
    ann = {} if raw is None else {consts.ROLLOUT_STATE_ANNOTATION: raw}
    cp = {"metadata": {"annotations": ann}, "spec": {}}
    assert ro.load_record(cp) is None and ref_ro.load_record(cp) is None
    assert convert.clusterpolicy_from_reference(cp) == cp
