"""The port's PrometheusRule assets and their control against the JAX
package's, on the 8 cases of ``tests/test_prometheus_rules.py``: the rule
files are valid, every alert's expression names a metric a collector
exports, the rules are applied in a reconcile, and
``object_controls.prometheus_rule`` skips a missing monitoring CRD, reports
RBAC as not ready, recreates a rule deleted mid-flight and reports a
different error on the retry as not ready.

Each case runs one script on both packages (``both``), each on its own
``FakeClient``, its own assets (``assets/`` and
``tpu_operator_torch/assets/``) and its own collectors, and compares the
outcomes in the port's names: alert names through ``ALERT_WORDS``
(``Libtpu`` → ``Driver``, ``TPU`` → ``GPU``), metric names through
``_port_metric``, rule objects ``tpu-…`` → ``gpu-…``, a ``State`` by its value.
Tolerance: exact equality under those renames.

The port creates ``NodeMetrics``' gauges in ``run()``, not at construction
as the reference does (``validator/metrics.py``; ROADMAP queue 3 item 4:
``test_torch_node_metrics.py::test_passes_run_without_prometheus_client``
depends on it). So the port's node names are listed by
``run(block=False)`` on port 0 with a scratch registry, the server stopped
in a ``finally``; the reference's by construction, as its test does.
"""

import os
import re
from types import SimpleNamespace

import pytest
import yaml

from tpu_operator import consts as ref_consts
from tpu_operator.api.v1.clusterpolicy_types import State as RefState
from tpu_operator.controllers import clusterpolicy_controller as ref_cpc
from tpu_operator.controllers import object_controls as ref_oc
from tpu_operator.controllers import operator_metrics as ref_om
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube.testing import make_tpu_node
from tpu_operator.validator import metrics as ref_vm
from tpu_operator_torch import consts, convert
from tpu_operator_torch.api.v1.clusterpolicy_types import State
from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
from tpu_operator_torch.controllers import object_controls as oc
from tpu_operator_torch.controllers import operator_metrics as om
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube.testing import make_gpu_node
from tpu_operator_torch.validator import metrics as vm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"
RULE_FILES = (("state-operator-metrics", "0300_prometheus_rule.yaml"),
              ("state-node-status-exporter", "0800_prometheus_rule.yaml"))
ALERT_WORDS = (("Libtpu", "Driver"), ("TPU", "GPU"))
# the reference's metric names that differ from the port's beyond the
# namespace (``tpu_operator`` / ``tpu_validator`` -> ``gpu_…``)
NODE_METRICS = {"tpu_capacity": "gpu_capacity", "libtpu_validation": "driver_validation",
                "runtime_ready": "toolkit_ready", "jax_ready": "cuda_ready"}


def _port_metric(name):
    ns, _, rest = name.partition("_")[2].partition("_")
    return f"gpu_{ns}_{NODE_METRICS.get(rest, rest)}"


def _port_alert(name):
    for old, new in ALERT_WORDS:
        name = name.replace(old, new)
    return name


def _ref_node_names():
    from prometheus_client import CollectorRegistry

    scratch = CollectorRegistry()
    ref_vm.NodeMetrics(node_name="n", registry=scratch)
    return {m.name for m in scratch.collect()}


def _port_node_names():
    from prometheus_client import CollectorRegistry

    scratch = CollectorRegistry()
    nm = vm.NodeMetrics(node_name="n", port=0, registry=scratch)
    try:
        nm.run(block=False)
        return {m.name for m in scratch.collect()}
    finally:
        nm.stop()


SIDES = {
    "reference": SimpleNamespace(
        name="reference", client=RefFakeClient, node=make_tpu_node, cpc=ref_cpc, oc=ref_oc, om=ref_om,
        consts=ref_consts, State=RefState, NotFoundError=ref_kclient.NotFoundError, cr=lambda cr: cr,
        assets=os.path.join(REPO, "assets"), metric=re.compile(r"\b(tpu_operator_\w+|tpu_validator_\w+)"),
        node_names=_ref_node_names, alert=_port_alert, metric_name=_port_metric,
        obj_name=lambda n: "gpu-" + n[len("tpu-"):] if n.startswith("tpu-") else n),
    "port": SimpleNamespace(
        name="port", client=kclient.FakeClient, node=make_gpu_node, cpc=cpc, oc=oc, om=om, consts=consts,
        State=State, NotFoundError=kclient.NotFoundError, cr=convert.clusterpolicy_from_reference,
        assets=os.path.join(REPO, "tpu_operator_torch", "assets"),
        metric=re.compile(r"\b(gpu_operator_\w+|gpu_validator_\w+)"), node_names=_port_node_names,
        alert=lambda a: a, metric_name=lambda m: m, obj_name=lambda n: n),
}


def both(script, *args):
    """``script(side, *args)`` on each package; the outcomes (in the port's
    names) must agree. Returns the port's."""
    out = {name: script(side, *args) for name, side in SIDES.items()}
    assert out["reference"] == out["port"], out
    return out["port"]


def rules(side, path):
    with open(os.path.join(side.assets, *path)) as f:
        return yaml.safe_load(f)


def rule_obj():
    return {"apiVersion": "monitoring.coreos.com/v1", "kind": "PrometheusRule",
            "metadata": {"name": "x", "namespace": ""}, "spec": {"groups": []}}


def control(side, client):
    """The control's view of the controller: its client, namespace and CR."""
    return SimpleNamespace(client=client, namespace=NS, cp_obj={"metadata": {"name": "cp", "uid": "u"}})


@pytest.mark.parametrize("path", RULE_FILES, ids=[p[0] for p in RULE_FILES])
def test_rule_files_valid(path):
    def script(side):
        obj = rules(side, path)
        out = []
        for g in obj["spec"]["groups"]:
            for rule in g["rules"]:
                assert rule["alert"] and rule["expr"]
                out.append((side.alert(rule["alert"]), rule["labels"]["severity"], rule.get("for")))
        return obj["kind"], len(obj["spec"]["groups"]), out

    kind, groups, alerts = both(script)
    assert kind == "PrometheusRule" and groups
    assert alerts and all(severity in ("warning", "critical") for _, severity, _ in alerts)


def test_alert_exprs_reference_real_metric_names():
    """Every metric an alert's expression names is exported by a collector
    (the operator's ``OperatorMetrics``, the node's ``NodeMetrics``), so
    the alert can fire; the alerts and their metrics map one to one onto
    the reference's."""
    from prometheus_client import REGISTRY

    def script(side):
        side.om.OperatorMetrics()
        known = {m.name for m in REGISTRY.collect()} | side.node_names()
        out = {}
        for path in RULE_FILES:
            for g in rules(side, path)["spec"]["groups"]:
                for rule in g["rules"]:
                    names = side.metric.findall(rule["expr"])
                    unknown = [n for n in names if n not in known and n.removesuffix("_total") not in known]
                    out[side.alert(rule["alert"])] = ([side.metric_name(n) for n in names], unknown)
        return out

    out = both(script)
    assert len(out) == 10
    for alert, (names, unknown) in out.items():
        assert names, f"{alert}: no metric in expr"
        assert not unknown, f"{alert} references unknown metric(s) {unknown}"


def test_rules_applied_during_reconcile(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)

    def script(side):
        client = side.client()
        with open(os.path.join(REPO, "config", "samples", "v1_clusterpolicy.yaml")) as f:
            cr = yaml.safe_load(f)
        cr["metadata"]["uid"] = "uid-cp"
        client.create(side.cr(cr))
        client.create(side.node("n1"))
        side.cpc.ClusterPolicyReconciler(client, assets_dir=side.assets).reconcile()
        return sorted((side.obj_name(r["metadata"]["name"]), r["metadata"]["namespace"],
                       bool(r["metadata"].get("ownerReferences")))
                      for r in client.list("monitoring.coreos.com/v1", "PrometheusRule", NS))

    assert both(script) == [("gpu-node-status-exporter-alerts", NS, True), ("gpu-operator-metrics", NS, True)]


def test_rule_apply_failure_is_graceful():
    """No monitoring CRDs: the apply raises, and the control returns READY."""

    class ExplodingClient:
        def get_or_none(self, *a, **k):
            raise RuntimeError("the server could not find the requested resource")

    def script(side):
        return side.oc.prometheus_rule(control(side, ExplodingClient()), "state-operator-metrics", rule_obj())

    assert both(script) == State.READY


def test_rule_apply_rbac_failure_is_not_ready():
    """A failure that is not absence (RBAC) is NotReady."""

    class ForbiddenClient:
        def get_or_none(self, *a, **k):
            raise RuntimeError("403: prometheusrules is forbidden")

    def script(side):
        return side.oc.prometheus_rule(control(side, ForbiddenClient()), "state-operator-metrics", rule_obj())

    assert both(script) == State.NOT_READY


def test_rule_deleted_midflight_is_recreated():
    """NotFound from a racing delete retries and recreates the rule rather
    than reading as a missing CRD."""

    def script(side):
        client = side.client()
        calls = {"n": 0}
        real = client.get_or_none

        def flaky(api, kind, name, ns=""):
            calls["n"] += 1
            if calls["n"] == 1:
                raise side.NotFoundError("racing delete")
            return real(api, kind, name, ns)

        client.get_or_none = flaky
        state = side.oc.prometheus_rule(control(side, client), "state-operator-metrics", rule_obj())
        return state, real("monitoring.coreos.com/v1", "PrometheusRule", "x", NS) is not None

    assert both(script) == (State.READY, True)


def test_rule_retry_failure_with_different_error_is_not_ready():
    """NotFound, then a different error on the retry (RBAC): NotReady, not a
    graceful missing-CRD skip."""

    def script(side):
        calls = {"n": 0}

        class FlakyThenForbidden:
            def get_or_none(self, *a, **k):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise side.NotFoundError("racing delete")
                raise RuntimeError("403: prometheusrules is forbidden")

        return side.oc.prometheus_rule(control(side, FlakyThenForbidden()), "state-operator-metrics", rule_obj())

    assert both(script) == State.NOT_READY
