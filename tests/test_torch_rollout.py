"""The port's health-gated rollout (``controllers/rollout.py``, whole, driven
by the ClusterPolicy and upgrade reconcilers) against the JAX package's, on
the 9 cases of ``tests/test_rollout.py`` and one of the port's own: both
sides pick the same canary for the same slice ids.

The pure cases run each side's function on the same ledger and CR in the
side's own terms (the driver's spec key and ledger kind, ``libtpu`` ↔
``driver``). The full-loop cases drive the real pair of reconcilers over
each side's ``FakeClient`` with the faithful-OnDelete kubelet simulator,
one script on both sides over paired worlds, compared as
``tests/test_torch_reconciler.py`` sets out (``both``): every node's
version label, rollback annotations and FSM labels, the Events, the CR's
``status.rollout`` and the ledger must agree, apart from the renames and
the clock stamps (held to their properties); a validator-perf reading is
held as its ratio to the side's healthy reading and the numbers inside the
evidence are masked, so the verdicts are compared, not the raw rates (the
port's fleet publishes the card's datasheet rates).
"""

import hashlib
import json

from tests.conftest import make_tpu_node
from tests.test_torch_reconciler import NS, SIDES, both, paired_clocks, pinned_clock  # noqa: F401  (autouse)
from tpu_operator import consts as ref_consts
from tpu_operator.api.v1.clusterpolicy_types import RolloutSpec as RefRolloutSpec
from tpu_operator.controllers import rollout as ref_ro
from tpu_operator.validator import metrics as ref_vm
from tpu_operator_torch import consts
from tpu_operator_torch.api.v1.clusterpolicy_types import RolloutSpec
from tpu_operator_torch.controllers import rollout as ro
from tpu_operator_torch.validator import metrics as vm

SLICE_ID = "ro-slice-a"
SLICE_NODES = ("ro-1", "ro-2")
SOLO_NODES = ("ro-3", "ro-4", "ro-5")
NODES = SLICE_NODES + SOLO_NODES  # 4 slice units
SLICE_UNITS = (SLICE_ID,) + SOLO_NODES
V_OLD = "1.0.0"
V_NEW = "2.0.0"
ROLLOUT_SPEC = {"enabled": True, "canary": 1, "waves": ["50%"], "observeSeconds": 0}
ACTIVE = (consts.UPGRADE_STATE_UPGRADE_REQUIRED,) + tuple(consts.UPGRADE_ACTIVE_STATES)

SPECS = {"reference": RefRolloutSpec, "port": RolloutSpec}


def pure(script):
    """``script(side)`` with each side's module, rollout spec and driver
    terms; the reference's result first."""
    return tuple(script(SIDES[name], SPECS[name]) for name in ("reference", "port"))


def cp_dict(side, version=None, rec=None, rollout=None):
    """A ClusterPolicy dict in the side's terms (``spec.libtpu`` and kind
    ``libtpu``, or ``spec.driver`` and kind ``driver``)."""
    cp = {"spec": {"rollout": rollout if rollout is not None else {"enabled": True},
                   side.driver: {} if version is None else {"version": version}}}
    if rec is not None:
        rec = dict(rec, kind=side.driver) if rec.get("kind") == "libtpu" else rec
        cp["metadata"] = {"annotations": {consts.ROLLOUT_STATE_ANNOTATION: json.dumps(rec)}}
    return cp


# ---------------------------------------------------------------------------
# pure units
# ---------------------------------------------------------------------------


def test_cohorts_are_deterministic_and_cover_every_slice():
    def script(side, Spec):
        spec = Spec.from_dict({"enabled": True, "canary": 2, "waves": ["25%", "50%"]})
        sids = [f"s{i}" for i in range(17)]
        a = side.ro.cohort_stages(sids, "v9", spec)
        assert a == side.ro.cohort_stages(list(reversed(sids)), "v9", spec)
        assert sorted(s for stage in a for s in stage) == sorted(sids)
        b = side.ro.cohort_stages(sids, "v10", spec)
        return a, b

    ref, port = pure(script)
    assert ref == port
    a, b = port
    assert len(a[0]) == 2 and (a != b or a[0] != b[0])


def test_both_sides_pick_the_same_canary():
    """Slice ids cross ``convert`` unchanged and the order is
    ``sha1(target:sid)`` on both sides: the same canary, wave and fleet for
    every target."""
    sids = [f"slice-{i}" for i in range(16)] + ["slice-card"] + [f"solo-{i}" for i in range(7)]
    spec = {"enabled": True, "canary": 1, "waves": ["25%"]}
    for target in ("550.144.03", "2.0.0", "v9"):
        ref, port = pure(lambda side, Spec: side.ro.cohort_stages(sids, target, Spec.from_dict(spec)))
        assert ref == port
        assert port[0] == [min(sids, key=lambda s: hashlib.sha1(f"{target}:{s}".encode()).hexdigest())]


def test_planned_stages_pin_begun_cohorts_against_mid_roll_joins():
    def script(side, Spec):
        spec = Spec.from_dict({"enabled": True, "canary": 1, "waves": ["50%"]})
        sids = [f"s{i}" for i in range(6)]
        rec = {"target": "v2", "stage": 0}
        plan = side.ro.planned_stages(rec, sids, spec)
        rec["cohorts"] = [list(plan[0])]
        key = lambda s: hashlib.sha1(f"v2:{s}".encode()).hexdigest()  # noqa: E731
        joiners = [n for n in (f"j{i}" for i in range(200)) if key(n) < key(plan[0][0])][:2]
        assert joiners, "no joiner hashed ahead; widen the search"
        plan2 = side.ro.planned_stages(rec, sids + joiners, spec)
        cp = cp_dict(side, "v2", dict(rec, kind="libtpu", state="rolling", previous="v1"))
        return plan, plan2, joiners, side.ro.admission_filter(cp, set(sids + joiners))

    ref, port = pure(script)
    assert ref == port
    plan, plan2, joiners, allowed = port
    assert plan2[0] == plan[0] and not set(joiners) & set(plan2[0])
    assert set(joiners) <= {s for stage in plan2 for s in stage}
    assert allowed == set(plan[0])


def test_admission_filter_fails_closed_before_and_across_restaging():
    def script(side, Spec):
        sids = {f"s{i}" for i in range(8)}
        rec = {"kind": "libtpu", "target": "2.0", "previous": "1.0", "stage": 0, "state": "rolling"}
        f = side.ro.admission_filter
        out = [f(cp_dict(side, "2.0"), {"a", "b"}), f(cp_dict(side), {"a"}), f(cp_dict(side, "2.0", rec), sids),
               f(cp_dict(side, "3.0", rec), sids), f(cp_dict(side, "1.0", dict(rec, state="rolled-back")), sids),
               f(cp_dict(side, "2.0", dict(rec, state="rolled-back")), sids)]
        return [sorted(x) if isinstance(x, set) else x for x in out]

    ref, port = pure(script)
    assert ref == port
    assert port[0] == [] and port[1] is None and len(port[2]) == 1
    assert port[3] == [] and port[4] is None and port[5] is None


def test_apply_override_pins_previous_version_only_while_rolled_back():
    def script(side, Spec):
        rec = {"kind": "libtpu", "target": "2.0", "previous": "1.0", "state": "rolled-back"}
        cp = cp_dict(side, "2.0", rec)
        raw = side.ro.apply_override(cp)
        cp2 = cp_dict(side, "3.0", rec)
        side.ro.apply_override(cp2)
        return raw[side.driver], cp["spec"][side.driver]["version"], cp2["spec"][side.driver]["version"]

    assert pure(script) == (("2.0", "1.0", "3.0"),) * 2


def test_validator_payload_canonical_flat_with_legacy_fallback():
    for mod in (ref_vm, vm):
        assert mod.payload_perf({"tflops": 812.5, "gbps": 700}) == {"tflops": 812.5, "gbps": 700.0}
        assert mod.payload_perf({"result": {"tflops": 90}})["tflops"] == 90.0
        assert mod.payload_perf({"result": "Succeeded"}) == {}
        assert mod.payload_perf("garbage") == {}


# ---------------------------------------------------------------------------
# full-loop matrix
# ---------------------------------------------------------------------------


def tpu_node(name, extra=None):
    node = make_tpu_node(name, extra_labels=extra)
    node["status"]["capacity"][ref_consts.TPU_RESOURCE] = "8"
    node["status"]["allocatable"][ref_consts.TPU_RESOURCE] = "8"
    return node


def build_rig(w, max_unavailable="50%", remediation=None):
    slice_extra = {ref_consts.TFD_SLICE_ID_LABEL: SLICE_ID, ref_consts.TFD_SLICE_HOSTS_LABEL: str(len(SLICE_NODES))}
    for name in SLICE_NODES:
        w.create(tpu_node(name, slice_extra))
    for name in SOLO_NODES:
        w.create(tpu_node(name))

    def edit(cr):
        cr["metadata"]["uid"] = "ro-uid"
        cr["spec"]["libtpu"]["version"] = V_OLD
        cr["spec"]["libtpu"]["upgradePolicy"] = {"autoUpgrade": True, "maxParallelUpgrades": 4,
                                                 "maxUnavailable": max_unavailable,
                                                 "drain": {"enable": True, "timeoutSeconds": 300}}
        cr["spec"]["rollout"] = dict(ROLLOUT_SPEC)
        if remediation:
            cr["spec"]["remediation"] = dict(remediation)

    w.create_cr(edit=edit)
    w.rec, w.upg = w.reconciler(), w.upgrader()
    return w


def pump(w, rounds=1, each=None, rec=None, upg=None):
    """One operator tick: CP pass, kubelet sweep, upgrade FSM pass."""
    for _ in range(rounds):
        (rec or w.rec).reconcile()
        w.side.testing.simulate_kubelet_nodes(w.client, NS, list(NODES))
        (upg or w.upg).reconcile()
        if each is not None:
            each()


def versions(w):
    return {n: w.version(n) for n in NODES}


def converge(w, rounds=8):
    pump(w, rounds=rounds)
    assert all(v == V_OLD for v in versions(w).values()), versions(w)


def canary_nodes(w):
    stages = w.side.ro.cohort_stages(SLICE_UNITS, V_NEW, SPECS[w.side.name].from_dict(ROLLOUT_SPEC))
    sid = stages[0][0]
    return stages, (SLICE_NODES if sid == SLICE_ID else (sid,))


def admitted(w):
    return {n for n in NODES if w.c.UPGRADE_PREVIOUS_VERSION_ANNOTATION in (
        w.node(n)["metadata"].get("annotations") or {})}


def settled_back(w):
    led = w.ledger()
    return (led is not None and led.get("state") == w.side.ro.STATE_ROLLED_BACK
            and all(v == V_OLD for v in versions(w).values())
            and not any(w.state(n) in ACTIVE for n in NODES))


def test_clean_roll_promotes_through_all_waves_to_complete():
    def script(w):
        build_rig(w)
        converge(w)
        w.set_version(V_NEW)
        ticks = 0
        for ticks in range(1, 61):
            pump(w)
            led = w.ledger()
            if led and led.get("state") == w.side.ro.STATE_COMPLETE and all(
                    v == V_NEW for v in versions(w).values()):
                break
        stats = w.rec.rollout.stats()
        rollout = w.cp()["status"]["rollout"]
        prev = {n: w.node(n)["metadata"]["annotations"].get(w.c.UPGRADE_PREVIOUS_VERSION_ANNOTATION) for n in NODES}
        return (ticks, w.ledger()["state"], versions(w), stats["promotions_total"], stats["rollbacks_total"],
                stats["pauses_total"], rollout["state"], rollout["target"], prev)

    ref, port = both(script)
    assert ref == port
    assert port[1:] == (ro.STATE_COMPLETE, {n: V_NEW for n in NODES}, 2, 0, 0, ro.STATE_COMPLETE, V_NEW,
                        {n: V_OLD for n in NODES})


def test_bad_canary_rolls_back_with_zero_wave2_admissions():
    def script(w):
        build_rig(w)
        converge(w)
        stages, canary = canary_nodes(w)
        assert len(stages) == 3
        dumps_before = set(w.side.flight.RECORDER.dump_paths_snapshot())
        w.side.testing.inject_bad_version(V_NEW, tflops_factor=0.5)
        w.set_version(V_NEW)
        for _ in range(60):
            pump(w)
            if settled_back(w):
                break
        led = w.ledger()
        new_dumps = [p for p in w.side.flight.RECORDER.dump_paths_snapshot()
                     if p not in dumps_before and "rollout-rollback" in p]
        assert new_dumps, "no rollout-rollback flight dump"
        with open(new_dumps[-1]) as f:
            dump = json.load(f)
        rollout = w.cp()["status"]["rollout"]
        return (led["state"], led["previous"], led["target"], any("TFLOPS" in ev for ev in led["evidence"]),
                versions(w), admitted(w) == set(canary), len(new_dumps), "TFLOPS" in dump["detail"],
                any(e.get("kind") == "rollout.rollback" for e in dump["events"]),
                "RolloutRolledBack" in {e["reason"] for e in w.events()}, rollout["state"], bool(rollout["evidence"]),
                sorted(canary))

    ref, port = both(script)
    assert ref == port
    assert port[:-1] == (ro.STATE_ROLLED_BACK, V_OLD, V_NEW, True, {n: V_OLD for n in NODES}, True, 1, True, True,
                         True, ro.STATE_ROLLED_BACK, True)


def test_rollback_respects_shared_budget_with_remediation_active():
    def script(w):
        build_rig(w, max_unavailable="2", remediation={
            "enabled": True, "maxAttempts": 4, "backoffSeconds": 0, "maxUnavailable": "2",
            "systemicThreshold": "75%"})
        converge(w)
        _, canary = canary_nodes(w)
        victim = next(n for n in SOLO_NODES if n not in canary)
        node = w.node(victim)
        node["status"]["allocatable"][w.side.resource] = "0"
        w.client.update_status(node)
        over_cap, quarantined = [], [False]

        def sample():
            disrupted = set()
            for n in NODES:
                labels = w.node(n)["metadata"].get("labels") or {}
                ustate = labels.get(w.c.UPGRADE_STATE_LABEL)
                if (ustate in w.c.UPGRADE_ACTIVE_STATES or ustate == w.c.UPGRADE_STATE_FAILED
                        or labels.get(w.c.REMEDIATION_STATE_LABEL) in w.c.REMEDIATION_DISRUPTED_STATES):
                    disrupted.add(SLICE_ID if n in SLICE_NODES else n)
            if len(disrupted) > 2:
                over_cap.append(sorted(disrupted))

        def sample_all():
            sample()
            if w.label(victim, w.c.REMEDIATION_STATE_LABEL) in w.c.REMEDIATION_DISRUPTED_STATES:
                quarantined[0] = True

        w.side.testing.inject_bad_version(V_NEW, tflops_factor=0.5)
        w.set_version(V_NEW)
        for _ in range(60):
            pump(w, each=sample_all)
            led = w.ledger()
            if led and led.get("state") == w.side.ro.STATE_ROLLED_BACK and quarantined[0]:
                break
        phase1 = (w.ledger()["state"], quarantined[0])
        node = w.node(victim)
        node["status"]["allocatable"][w.side.resource] = "8"
        w.client.update_status(node)
        for _ in range(60):
            pump(w, each=sample)
            if all(v == V_OLD for v in versions(w).values()) and not w.label(victim, w.c.REMEDIATION_STATE_LABEL):
                break
        return phase1, over_cap, versions(w), w.ledger()["state"]

    ref, port = both(script)
    assert ref == port
    assert port == ((ro.STATE_ROLLED_BACK, True), [], {n: V_OLD for n in NODES}, ro.STATE_ROLLED_BACK)


def test_operator_restart_mid_rollback_resumes_from_persisted_state():
    def script(w):
        build_rig(w)
        converge(w)
        w.side.testing.inject_bad_version(V_NEW, tflops_factor=0.5)
        w.set_version(V_NEW)
        for _ in range(60):
            pump(w)
            led = w.ledger()
            if led and led.get("state") == w.side.ro.STATE_ROLLED_BACK:
                break
        first = w.ledger()["state"]
        rec2, upg2 = w.reconciler(), w.upgrader()
        for _ in range(60):
            pump(w, rec=rec2, upg=upg2)
            if all(v == V_OLD for v in versions(w).values()) and not any(w.state(n) in ACTIVE for n in NODES):
                break
        _, canary = canary_nodes(w)
        return first, versions(w), w.ledger()["state"], admitted(w) == set(canary)

    ref, port = both(script)
    assert ref == port
    assert port == (ro.STATE_ROLLED_BACK, {n: V_OLD for n in NODES}, ro.STATE_ROLLED_BACK, True)


def test_ledger_without_kind_reads_as_a_driver_roll():
    """The defaults of ``rec.get("kind", ...)`` are the port's driver kind:
    a ledger without a kind whose target the user moved freezes admission,
    as a driver roll does, instead of reading as a layout roll that skips
    the version check."""
    rec = {"target": "2.0", "previous": "1.0", "stage": 0, "state": "rolling"}
    cp = {"spec": {"rollout": {"enabled": True}, "driver": {"version": "3.0"}},
          "metadata": {"annotations": {consts.ROLLOUT_STATE_ANNOTATION: json.dumps(rec)}}}
    assert ro.admission_filter(cp, {f"s{i}" for i in range(8)}) == set()
    cp["spec"]["driver"]["version"] = "2.0"
    assert len(ro.admission_filter(cp, {f"s{i}" for i in range(8)})) == 1


def test_operand_health_reads_the_ports_prefix():
    """Crash-loop evidence comes from operand pods: the reference's
    ``tpu-*`` driver pod and the port's ``gpu-*`` one alike (``convert``
    maps the app), never a user pod, and on the port never a pod under the
    reference's prefix."""

    def crashing(name, app, node):
        return {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": NS, "labels": {"app": app}},
                "spec": {"nodeName": node}, "status": {"phase": "Running", "containerStatuses": [
                    {"ready": False, "state": {"waiting": {"reason": "CrashLoopBackOff"}}}]}}

    def script(w):
        w.create(crashing("driver-ro-1", "tpu-libtpu-daemonset-v5e", "ro-1"))
        w.create(crashing("train-ro-2", "train", "ro-2"))
        crash, validators = w.side.ro.RolloutController(w.client, NS)._operand_health()
        return crash, sorted(validators)

    ref, port = both(script)
    assert ref == port == ({"ro-1": ["driver-ro-1"]}, [])
    from tests.test_torch_reconciler import World

    w = World(SIDES["port"])
    w.client.create(crashing("stray-ro-3", "tpu-libtpu-daemonset-v5e", "ro-3"))
    assert ro.RolloutController(w.client, NS)._operand_health()[0] == {}


def test_bad_roll_after_a_finished_one_admits_only_its_canary():
    """The port's one deliberate difference: after a finished roll every
    node keeps the previous-version annotation that roll wrote, and the
    reference's ``rollback_admission_filter`` reads any such annotation as
    "admitted in this roll", so in the tick that decides the rollback its
    upgrade reconciler admits slices outside the canary. The port reads
    the annotation only when it names the restored previous version: a bad
    roll after a clean one admits its canary alone, on the same world
    where the reference admits more."""
    v_bad = "3.0.0"

    def script(w):
        build_rig(w)
        converge(w)
        w.set_version(V_NEW)
        for _ in range(60):
            pump(w)
            led = w.ledger()
            if led and led.get("state") == w.side.ro.STATE_COMPLETE and all(
                    v == V_NEW for v in versions(w).values()):
                break
        w.side.testing.inject_bad_version(v_bad, tflops_factor=0.5)
        w.set_version(v_bad)
        for _ in range(60):
            pump(w)
            led = w.ledger()
            if led and led.get("state") == w.side.ro.STATE_ROLLED_BACK and all(
                    v == V_NEW for v in versions(w).values()) and not any(w.state(n) in ACTIVE for n in NODES):
                break
        led = w.ledger()
        canary = {m for sid in led["cohorts"][0] for m in (SLICE_NODES if sid == SLICE_ID else (sid,))}
        stamped = {n for n in NODES if (w.node(n)["metadata"].get("annotations") or {}).get(
            w.c.UPGRADE_PREVIOUS_VERSION_ANNOTATION) != V_OLD}
        return led["state"], versions(w), canary, stamped

    from tests.test_torch_reconciler import World

    ref = script(World(SIDES["reference"]))
    port = script(World(SIDES["port"]))
    assert port[:2] == ref[:2] == (ro.STATE_ROLLED_BACK, {n: V_NEW for n in NODES})
    assert port[2] == ref[2] and port[3] == port[2]
    assert ref[3] > ref[2]
