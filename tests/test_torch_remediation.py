"""The port's node-health remediation (``controllers/remediation.py``)
against the JAX package's, on the 20 cases of ``tests/test_remediation.py``
(``test_reconciler_reports_systemic_condition`` through both ClusterPolicy
reconcilers) and the port's operand filter.

Each case runs one script on both sides over paired worlds, as
``tests/test_torch_upgrade.py`` sets out (``World``, ``both``): the
reference's node, operand, validator and workload pods cross to the port
through ``convert``, and the reference's nodes are picked by
``has_tpu_labels``, the port's by ``has_gpu_labels``. Tolerance: exact
equality of every node's labels, annotations, taints and
``unschedulable``, of the pods left, of every eviction and deletion and of
the Events, apart from the renames and the clock-derived annotations
(held to their properties; the attempts record's ``attempts`` count is
compared exactly). ``backoffSeconds`` is 0 and both modules' ``_utc_now``
read one clock, so every pass is deterministic.

The operand pod of the reference's fixture carries ``app:
tpu-device-plugin``, which no operand renders and ``convert`` leaves as it
is; here it carries the reference's real operand app,
``tpu-device-plugin-daemonset``, which crosses as
``gpu-device-plugin-daemonset``.
"""

import logging

import pytest

from tests.test_torch_upgrade import NS, SIDES, World, both, pinned_clock  # noqa: F401  (autouse fixture)
from tpu_operator import consts as ref_consts
from tpu_operator.kube.testing import make_validator_pod, make_tpu_node
from tpu_operator_torch import consts, convert
from tpu_operator_torch.controllers import remediation as rem

OPERAND_APP = "tpu-device-plugin-daemonset"


def tpu_node(name, chips="8"):
    node = make_tpu_node(name)
    node["status"]["capacity"]["google.com/tpu"] = "8"
    node["status"]["allocatable"]["google.com/tpu"] = chips
    node["metadata"]["labels"][ref_consts.DEPLOY_LABEL_PREFIX + ref_consts.COMPONENT_OPERATOR_VALIDATOR] = "true"
    return node


def operand_pod(name, node, app=OPERAND_APP):
    return {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": NS, "labels": {"app": app}},
            "spec": {"nodeName": node}, "status": {"phase": "Running", "containerStatuses": [{"ready": True}]}}


def workload_pod(name, node, namespace="default", labels=None, owned=True):
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": namespace, "labels": labels or {"job": "train"}},
           "spec": {"nodeName": node,
                    "containers": [{"name": "train", "resources": {"limits": {"google.com/tpu": "4"}}}]},
           "status": {"phase": "Running"}}
    if owned:
        pod["metadata"]["ownerReferences"] = [{"kind": "Job", "name": "train", "uid": "j1"}]
    return pod


def spec(w, **kw):
    defaults = dict(enabled=True, max_attempts=2, backoff_seconds=0, max_unavailable="50%", systemic_threshold="50%")
    defaults.update(kw)
    return w.side.cpt.RemediationSpec(**defaults)


def seeded(w, n_nodes=4, validators=True):
    for i in range(1, n_nodes + 1):
        w.create(tpu_node(f"node-{i}"))
        w.create(operand_pod(f"plugin-node-{i}", f"node-{i}"))
        if validators:
            w.create(make_validator_pod(f"node-{i}", True, NS))
    w.ctrl = w.side.rem.NodeRemediationController(w.client)
    return w


def run_pass(w, sp):
    return w.ctrl.reconcile([n for n in w.client.list("v1", "Node") if w.side.has_labels(n)], sp, NS)


def rstate(w, name):
    return w.label(name, w.c.REMEDIATION_STATE_LABEL)


def set_chips(w, name, chips):
    n = w.node(name)
    n["status"]["allocatable"][w.side.resource] = chips
    w.client.update(n)


def kill(w, name):
    set_chips(w, name, "0")


def heal(w, name, chips="8"):
    """Cards return AND the validator DaemonSet re-places its pod."""
    set_chips(w, name, chips)
    if w.pod(f"val-{name}") is None:
        w.create(make_validator_pod(name, True, NS))


def repaired(w, name):
    node = w.node(name)
    return (w.unschedulable(name), w.side.kclient.has_taint(node, w.c.REPAIR_TAINT_KEY, w.c.REPAIR_PENDING),
            (node["metadata"].get("labels") or {}).get(w.c.REPAIR_LABEL))


S = consts  # the state values are the same strings on both sides
QUARANTINE = (True, True, consts.REPAIR_PENDING)
LIFTED = (False, False, None)


def test_health_signals():
    def script(w):
        seeded(w)
        summary = run_pass(w, spec(w))
        first = (summary.unhealthy, summary.active, [rstate(w, f"node-{i}") for i in (1, 2, 3, 4)])
        kill(w, "node-1")
        p = w.pod("plugin-node-2")
        p["status"]["containerStatuses"] = [{"ready": False, "state": {"waiting": {"reason": "CrashLoopBackOff"}}}]
        w.client.update(p)
        w.client.delete("v1", "Pod", "val-node-3", NS)
        summary = run_pass(w, spec(w, systemic_threshold="90%"))
        return first, sorted(summary.unhealthy_hosts), summary.active

    assert both(script) == (((0, False, [None] * 4), ["node-1", "node-2", "node-3"], True),) * 2


def test_verdict_names_the_card_resource():
    """A node whose every card is unhealthy reads ``0 allocatable
    nvidia.com/gpu`` (the reference's reason with its resource renamed)."""

    def script(w):
        seeded(w)
        kill(w, "node-1")
        pods, validators = w.ctrl._namespace_pods_by_node()
        return w.ctrl._verdict(w.node("node-1"), pods, validators).reasons, sorted(validators)

    ref, port = both(script)
    assert [SIDES["reference"].message(r) for r in ref[0]] == port[0] == [f"0 allocatable {consts.GPU_RESOURCE}"]
    assert ref[1] == port[1] == [f"node-{i}" for i in (1, 2, 3, 4)]


def test_fsm_escalates_quarantines_and_recovers():
    def script(w):
        seeded(w)
        sp = spec(w, systemic_threshold="90%")
        w.create(workload_pod("train-1", "node-1"))
        kill(w, "node-1")
        seen = []
        run_pass(w, sp)
        seen.append(rstate(w, "node-1"))
        run_pass(w, sp)
        seen.append((rstate(w, "node-1"), w.pod("plugin-node-1") is None, w.ctrl.attempts_total,
                     w.pod("train-1", "default") is not None))
        summary = run_pass(w, sp)
        seen.append((rstate(w, "node-1"), repaired(w, "node-1"), w.pod("train-1", "default") is None,
                     summary.quarantined, ["node-1" in e["message"] for e in w.events("NodeQuarantined")]))
        run_pass(w, sp)
        seen.append(rstate(w, "node-1"))
        heal(w, "node-1")
        run_pass(w, sp)
        seen.append((rstate(w, "node-1"), repaired(w, "node-1")))
        run_pass(w, sp)
        seen.append(rstate(w, "node-1"))
        return seen

    ref, port = both(script)
    assert ref == port == [
        S.REMEDIATION_STATE_OBSERVED, (S.REMEDIATION_STATE_REVALIDATE, True, 1, True),
        (S.REMEDIATION_STATE_QUARANTINED, QUARANTINE, True, 1, [True]), S.REMEDIATION_STATE_QUARANTINED,
        (S.REMEDIATION_STATE_RECOVERED, LIFTED), None]


def test_precordoned_node_stays_cordoned_after_recovery():
    def script(w):
        seeded(w)
        sp = spec(w, systemic_threshold="90%")
        w.set_unschedulable("node-1")
        kill(w, "node-1")
        for _ in range(4):
            run_pass(w, sp)
        held = rstate(w, "node-1")
        heal(w, "node-1")
        run_pass(w, sp)
        return held, repaired(w, "node-1")

    assert both(script) == ((S.REMEDIATION_STATE_QUARANTINED, (True, False, None)),) * 2


def test_flapping_node_lands_exhausted_at_attempt_cap():
    def script(w):
        seeded(w)
        sp = spec(w, systemic_threshold="90%")
        kill(w, "node-1")
        for _ in range(4):
            run_pass(w, sp)
        seen = [(rstate(w, "node-1"), w.ctrl.attempts_total)]
        heal(w, "node-1")
        run_pass(w, sp)
        seen.append(rstate(w, "node-1"))
        kill(w, "node-1")
        summary = run_pass(w, sp)
        seen.append((rstate(w, "node-1"), repaired(w, "node-1")[:2], summary.exhausted,
                     len(w.events("NodeRemediationExhausted"))))
        heal(w, "node-1")
        run_pass(w, sp)
        seen.append((rstate(w, "node-1"), w.unschedulable("node-1")))
        n = w.node("node-1")
        del n["metadata"]["labels"][w.c.REMEDIATION_STATE_LABEL]
        n["metadata"]["annotations"].pop(w.c.REMEDIATION_ATTEMPTS_ANNOTATION, None)
        w.client.update(n)
        run_pass(w, sp)
        seen.append(rstate(w, "node-1"))
        return seen

    ref, port = both(script)
    assert ref == port == [(S.REMEDIATION_STATE_QUARANTINED, 2), S.REMEDIATION_STATE_RECOVERED,
                           (S.REMEDIATION_STATE_EXHAUSTED, (True, True), 1, 1),
                           (S.REMEDIATION_STATE_EXHAUSTED, True), None]


def test_budget_defers_drain_while_upgrade_holds_the_pool():
    def script(w):
        seeded(w)
        sp = spec(w, max_unavailable="25%", systemic_threshold="90%")
        w.relabel("node-2", UPGRADE_STATE_LABEL="drain-required")
        kill(w, "node-1")
        deferred = 0
        for _ in range(5):
            summary = run_pass(w, sp)
            deferred += summary.budget_deferred
            assert summary.disrupted_slices <= summary.budget_cap == 1
        held = (deferred > 0, rstate(w, "node-1"), w.unschedulable("node-1"))
        w.relabel("node-2", UPGRADE_STATE_LABEL="upgrade-done")
        run_pass(w, sp)
        return held, rstate(w, "node-1")

    assert both(script) == (((True, S.REMEDIATION_STATE_REVALIDATE, False), S.REMEDIATION_STATE_QUARANTINED),) * 2


def test_second_unhealthy_node_waits_for_the_first():
    def script(w):
        seeded(w)
        sp = spec(w, max_unavailable="25%", systemic_threshold="90%")
        for name in ("node-1", "node-2"):
            kill(w, name)
        for _ in range(5):
            assert run_pass(w, sp).disrupted_slices <= 1
        held = {n: rstate(w, n) for n in ("node-1", "node-2")}
        first = next(n for n, s in held.items() if s == S.REMEDIATION_STATE_QUARANTINED)
        heal(w, first)
        for _ in range(3):
            run_pass(w, sp)
        return held, rstate(w, "node-2" if first == "node-1" else "node-1")

    ref, port = both(script)
    assert ref == port
    assert set(ref[0].values()) == {S.REMEDIATION_STATE_QUARANTINED, S.REMEDIATION_STATE_REVALIDATE}
    assert ref[1] == S.REMEDIATION_STATE_QUARANTINED


def test_systemic_breaker_halts_remediation():
    def script(w):
        seeded(w)
        sp = spec(w, systemic_threshold="50%")
        w.create(workload_pod("train-1", "node-1"))
        for name in ("node-1", "node-2"):
            kill(w, name)
        summary = run_pass(w, sp)
        halted = (summary.breaker_open, summary.unhealthy, summary.breaker_threshold,
                  [(rstate(w, f"node-{i}"), repaired(w, f"node-{i}")[:2]) for i in (1, 2, 3, 4)],
                  w.pod("train-1", "default") is not None, len(w.events("SystemicNodeFailure")),
                  w.ctrl.breaker_opens_total)
        set_chips(w, "node-2", "8")
        summary = run_pass(w, sp)
        return halted, summary.breaker_open, rstate(w, "node-1")

    assert both(script) == (((True, 2, 2, [(None, (False, False))] * 4, True, 1, 1), False,
                             S.REMEDIATION_STATE_OBSERVED),) * 2


def test_breaker_never_opens_on_a_single_node():
    def script(w):
        seeded(w, n_nodes=1)
        kill(w, "node-1")
        return run_pass(w, spec(w, systemic_threshold="50%")).breaker_open, rstate(w, "node-1")

    assert both(script) == ((False, S.REMEDIATION_STATE_OBSERVED),) * 2


def test_interlock_maintenance_and_upgrade(caplog):
    def script(w):
        seeded(w)
        sp = spec(w, systemic_threshold="90%")
        w.relabel("node-1", MAINTENANCE_STATE_LABEL="pending")
        kill(w, "node-1")
        w.relabel("node-2", UPGRADE_STATE_LABEL="cordon-required")
        kill(w, "node-2")
        caplog.clear()
        with caplog.at_level(logging.INFO, w.side.logger + ".remediation"):
            for _ in range(3):
                summary = run_pass(w, sp)
        notes = [r for r in caplog.records if r.name == w.side.logger + ".remediation"
                 and "deferring to" in r.getMessage()]
        held = [(rstate(w, n), repaired(w, n)[1]) for n in ("node-1", "node-2")]
        w.relabel("node-1", MAINTENANCE_STATE_LABEL=None)
        run_pass(w, sp)
        return summary.skipped, held, len(notes), rstate(w, "node-1")

    assert both(script) == ((2, [(None, False)] * 2, 2, S.REMEDIATION_STATE_OBSERVED),) * 2


def test_skip_label_is_an_escape_hatch():
    def script(w):
        seeded(w).relabel("node-1", REMEDIATION_SKIP_LABEL="true")
        kill(w, "node-1")
        for _ in range(3):
            run_pass(w, spec(w, systemic_threshold="90%"))
        return rstate(w, "node-1"), w.unschedulable("node-1")

    assert both(script) == ((None, False),) * 2


def test_pdb_veto_defers_cordon_drain():
    def script(w):
        seeded(w)
        sp = spec(w, systemic_threshold="90%")
        w.create(workload_pod("train-1", "node-1", labels={"job": "train"}))
        w.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                  "metadata": {"name": "train-pdb", "namespace": "default"},
                  "spec": {"minAvailable": 1, "selector": {"matchLabels": {"job": "train"}}}})
        kill(w, "node-1")
        for _ in range(5):
            run_pass(w, sp)
        held = (rstate(w, "node-1"), w.unschedulable("node-1"), w.pod("train-1", "default") is not None,
                w.ctrl.drains_vetoed_total)
        w.client.delete("policy/v1", "PodDisruptionBudget", "train-pdb", "default")
        run_pass(w, sp)
        return held, rstate(w, "node-1"), w.pod("train-1", "default") is None

    ref, port = both(script)
    assert ref == port
    assert ref[0][:3] == (S.REMEDIATION_STATE_CORDON_DRAIN, True, True) and ref[0][3] > 0
    assert ref[1:] == (S.REMEDIATION_STATE_QUARANTINED, True)


def test_disable_strips_state_and_lifts_quarantine():
    def script(w):
        seeded(w)
        kill(w, "node-1")
        for _ in range(4):
            run_pass(w, spec(w, systemic_threshold="90%"))
        held = rstate(w, "node-1")
        summary = run_pass(w, w.side.cpt.RemediationSpec(enabled=False))
        meta = w.node("node-1")["metadata"]
        return (held, summary is not None and summary.active, rstate(w, "node-1"), repaired(w, "node-1"),
                w.c.REMEDIATION_ATTEMPTS_ANNOTATION in (meta.get("annotations") or {}))

    assert both(script) == ((S.REMEDIATION_STATE_QUARANTINED, False, None, LIFTED, False),) * 2


def test_breaker_ignores_interlocked_unhealthy_nodes():
    def script(w):
        seeded(w)
        for name in ("node-1", "node-2"):
            w.relabel(name, UPGRADE_STATE_LABEL="drain-required")
            kill(w, name)
        kill(w, "node-3")
        summary = run_pass(w, spec(w, systemic_threshold="50%"))
        return summary.unhealthy, summary.breaker_open, [rstate(w, f"node-{i}") for i in (1, 2, 3)]

    assert both(script) == ((3, False, [None, None, S.REMEDIATION_STATE_OBSERVED]),) * 2


def test_systemic_threshold_rounds_up():
    def script(w):
        seeded(w, n_nodes=5)
        sp = spec(w, systemic_threshold="50%", max_unavailable="100%")
        for name in ("node-1", "node-2"):
            kill(w, name)
        summary = run_pass(w, sp)
        first = (summary.breaker_threshold, summary.breaker_open)
        kill(w, "node-3")
        return first, run_pass(w, sp).breaker_open

    assert both(script) == (((3, False), True),) * 2


@pytest.mark.parametrize("app", ["my-agent", "user-job"])
def test_restart_operands_leaves_non_operand_pods_alone(app):
    def script(w):
        seeded(w)
        w.create(operand_pod("user-agent-node-1", "node-1", app=app))
        kill(w, "node-1")
        sp = spec(w, systemic_threshold="90%")
        run_pass(w, sp)
        run_pass(w, sp)
        return w.pod("plugin-node-1") is None, w.pod("user-agent-node-1") is not None

    assert both(script) == ((True, True),) * 2


@pytest.mark.parametrize("app", ["my-agent", "user-job"])
def test_non_operand_crashloop_is_not_a_health_signal(app):
    """A user pod crash-looping in the operator namespace is no operand
    signal: its app does not start with the operand prefix."""

    def script(w):
        seeded(w)
        w.create(operand_pod("user-agent-node-1", "node-1", app=app))
        p = w.pod("user-agent-node-1")
        p["status"]["containerStatuses"] = [{"ready": False, "state": {"waiting": {"reason": "CrashLoopBackOff"}}}]
        w.client.update(p)
        summary = run_pass(w, spec(w, systemic_threshold="90%"))
        return summary.unhealthy, rstate(w, "node-1")

    assert both(script) == ((0, None),) * 2


def test_breaker_ignores_already_quarantined_hosts():
    def script(w):
        seeded(w)
        sp = spec(w, systemic_threshold="50%", max_unavailable="100%")
        kill(w, "node-1")
        for _ in range(4):
            run_pass(w, sp)
        held = rstate(w, "node-1")
        kill(w, "node-2")
        summary = run_pass(w, sp)
        counts = (summary.unhealthy, summary.breaker_open)
        for _ in range(4):
            run_pass(w, sp)
        return held, counts, rstate(w, "node-2")

    assert both(script) == ((S.REMEDIATION_STATE_QUARANTINED, (2, False), S.REMEDIATION_STATE_QUARANTINED),) * 2


def test_unmanaged_pod_holds_drain_with_a_note(caplog):
    def script(w):
        seeded(w)
        w.create(workload_pod("naked", "node-1", owned=False))
        kill(w, "node-1")
        caplog.clear()
        with caplog.at_level(logging.INFO, w.side.logger + ".remediation"):
            for _ in range(5):
                run_pass(w, spec(w, systemic_threshold="90%"))
        notes = [r for r in caplog.records if r.name == w.side.logger + ".remediation"
                 and "unmanaged" in r.getMessage()]
        return rstate(w, "node-1"), w.pod("naked", "default") is not None, len(notes)

    assert both(script) == ((S.REMEDIATION_STATE_CORDON_DRAIN, True, 1),) * 2


def test_exhausted_entry_drains_workloads_too():
    def script(w):
        seeded(w)
        sp = spec(w, systemic_threshold="90%")
        kill(w, "node-1")
        for _ in range(4):
            run_pass(w, sp)
        held = rstate(w, "node-1")
        heal(w, "node-1")
        run_pass(w, sp)
        w.create(workload_pod("train-flap", "node-1"))
        kill(w, "node-1")
        run_pass(w, sp)
        return held, rstate(w, "node-1"), w.pod("train-flap", "default") is None

    assert both(script) == ((S.REMEDIATION_STATE_QUARANTINED, S.REMEDIATION_STATE_EXHAUSTED, True),) * 2


# --- the port's operand filter -------------------------------------------

def test_every_operand_app_starts_with_the_operand_prefix():
    """``consts.OPERAND_APP_PREFIX`` is the reference's ``tpu-`` rule under
    the port's names: every operand app, and every per-variant driver
    DaemonSet, starts with it, and no literal ``tpu-`` filter is left."""
    import inspect

    from tpu_operator_torch.workloads.topology import CARDS_PER_HOST

    apps = list(consts.OPERAND_APPS.values()) + [f"{consts.DRIVER_APP}-{v}" for v in CARDS_PER_HOST]
    assert consts.OPERAND_APP_PREFIX == "gpu-"
    assert all(a.startswith(consts.OPERAND_APP_PREFIX) for a in apps), apps
    assert all(ref.startswith("tpu-") for ref in consts.OPERAND_APPS)
    source = inspect.getsource(rem)
    assert 'startswith("tpu-")' not in source and source.count(".startswith(consts.OPERAND_APP_PREFIX)") == 2
    assert convert.operand_app_from_reference(OPERAND_APP) == "gpu-device-plugin-daemonset"


def test_restart_rung_deletes_gpu_operands_and_no_user_pod():
    """On the port alone: the restart rung deletes the node's ``gpu-*``
    operand pods (every app of ``OPERAND_APPS``) and leaves a ``user-job``
    pod in the operator namespace and the other nodes' operands."""
    w = seeded(World(SIDES["port"]))
    for i, app in enumerate(consts.OPERAND_APPS.values()):
        w.client.create({**operand_pod(f"op-{i}", "node-1"), "metadata": {
            "name": f"op-{i}", "namespace": NS, "labels": {"app": app}}})
    w.client.create({**operand_pod("user", "node-1"), "metadata": {
        "name": "user", "namespace": NS, "labels": {"app": "user-job"}}})
    kill(w, "node-1")
    sp = spec(w, systemic_threshold="90%")
    run_pass(w, sp)
    run_pass(w, sp)
    left = sorted(p["metadata"]["name"] for p in w.client.list("v1", "Pod", NS)
                  if p["spec"]["nodeName"] == "node-1")
    assert left == ["user"]
    assert all(w.pod(f"plugin-node-{i}") is not None for i in (2, 3, 4))


def test_reconciler_reports_systemic_condition(monkeypatch, pinned_clock):  # noqa: F811
    """``tests/test_remediation.py::test_reconciler_reports_systemic_condition``
    through both ClusterPolicy reconcilers, compared as
    ``tests/test_torch_reconciler.py`` sets out: a fleet wholly unhealthy
    opens the breaker, reported as ``status.remediation`` and a
    ``Degraded/SystemicNodeFailure`` condition; the fleet's recovery lifts
    both."""
    from tests.test_torch_reconciler import both as reconcile_both, pair_sides

    pair_sides(monkeypatch, pinned_clock)

    def script(w):
        for i in (1, 2):
            w.create(tpu_node(f"node-{i}", chips="0"))
        w.create_cr(edit=lambda cr: cr["spec"].update(remediation={
            "enabled": True, "backoffSeconds": 0, "systemicThreshold": "50%"}))
        r = w.reconciler()
        res = r.reconcile()
        status = w.cp()["status"]
        degraded = {c["type"]: c for c in status["conditions"]}["Degraded"]
        first = (res.requeue_after is not None, (status.get("remediation") or {}).get("unhealthy"),
                 (status.get("remediation") or {}).get("breakerOpen"), degraded["status"], degraded["reason"])
        for i in (1, 2):
            n = w.node(f"node-{i}")
            n["status"]["allocatable"][w.side.resource] = "8"
            w.client.update(n)
            w.create(make_validator_pod(f"node-{i}", True, NS))
        r.reconcile()
        r.reconcile()
        status = w.cp()["status"]
        return first, "remediation" in status, {c["type"]: c for c in status["conditions"]}["Degraded"]["reason"]

    ref, port = reconcile_both(script)
    assert ref == port
    assert port[0] == (True, 2, True, "True", "SystemicNodeFailure")
    assert port[1] is False and port[2] != "SystemicNodeFailure"
