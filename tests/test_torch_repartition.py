"""The port's live slice re-partition roll (``controllers/repartition.py``)
against the JAX package's, on the 9 cases of ``tests/test_repartition.py``,
with the three-consumer budget they share with the upgrade FSM and
remediation.

Each case runs one script on both sides over paired worlds, as
``tests/test_torch_upgrade.py`` sets out (``World``, ``both``). A layout
name is opaque to the controller, so each TPU layout the reference rolls
is paired with a layout of the card's slice manager (``LAYOUTS``:
``balanced-2x2`` is ``all-1x2``, ``old-layout`` is ``all-1x1``), and the
reference's slice-config label crosses through that table when the worlds
are compared. Tolerance: exact equality of every node's labels,
annotations, taints and ``unschedulable``, of the pods left, of every
eviction and deletion and of the Events, apart from the renames and the
layout pairs.
"""

from types import SimpleNamespace

from tests.test_torch_remediation import operand_pod
from tests.test_torch_upgrade import NS, SIDES, VARIANTS, World, both, pinned_clock  # noqa: F401  (autouse fixture)
from tpu_operator import consts as ref_consts
from tpu_operator.kube.testing import make_tpu_node, make_validator_pod
from tpu_operator_torch import consts, convert

SLICE_ID = "rp-slice-a"
# the reference's TPU layouts -> the card's slice-manager layouts
LAYOUTS = {"balanced-2x2": "all-1x2", "old-layout": "all-1x1"}


def _layouts_to_port(obj):
    obj = convert.object_from_reference(obj, VARIANTS)
    labels = obj["metadata"].get("labels") or {}
    if labels.get(consts.SLICE_CONFIG_LABEL) in LAYOUTS:
        labels[consts.SLICE_CONFIG_LABEL] = LAYOUTS[labels[consts.SLICE_CONFIG_LABEL]]
    return obj


def _layout_message(text):
    text = SIDES["reference"].message(text)
    for old, new in LAYOUTS.items():
        text = text.replace(repr(old), repr(new))
    return text


ROLL_SIDES = {
    "reference": SimpleNamespace(**{**vars(SIDES["reference"]), "to_port": _layouts_to_port,
                                    "message": _layout_message, "layout": lambda name: name}),
    "port": SimpleNamespace(**{**vars(SIDES["port"]), "layout": LAYOUTS.get}),
}


def sm_spec(w, default="balanced-2x2", max_unavailable="1"):
    cpt = w.side.cpt
    return cpt.SliceManagerSpec(config=cpt.DevicePluginConfig(name="layouts", default=w.side.layout(default)),
                                max_unavailable=max_unavailable)


def tpu_node(name, extra=None):
    node = make_tpu_node(name, extra_labels=extra)
    node["status"]["capacity"]["google.com/tpu"] = "8"
    node["status"]["allocatable"]["google.com/tpu"] = "8"
    return node


def seeded(w):
    """A 2-host slice plus two single-host slices (3 slice units)."""
    extra = {ref_consts.TFD_SLICE_ID_LABEL: SLICE_ID, ref_consts.TFD_SLICE_HOSTS_LABEL: "2"}
    for name in ("rp-1", "rp-2"):
        w.create(tpu_node(name, extra))
    for name in ("solo-1", "solo-2"):
        w.create(tpu_node(name))
    w.ctrl = w.side.rp.SliceRepartitionController(w.client)
    return w


def nodes(w):
    return w.client.list("v1", "Node")


def patch(w, name, **labels):
    """Labels named by ``consts`` attribute; a layout value through the side's table."""
    out = {}
    for attr, value in labels.items():
        key = getattr(w.c, attr)
        out[key] = w.side.layout(value) if key == w.c.SLICE_CONFIG_LABEL else value
    w.client.patch_labels("v1", "Node", name, labels=out)


def rolling(w, name):
    return w.label(name, w.c.REPARTITION_STATE_LABEL) == w.c.REPARTITION_STATE_ROLLING


def apply_layout(w, name):
    """Play the node's slice manager: layout applied, success."""
    w.client.patch_labels("v1", "Node", name, labels={w.c.SLICE_CONFIG_STATE_LABEL: w.side.sliceman.STATE_SUCCESS})


ALL = ("rp-1", "rp-2", "solo-1", "solo-2")


def test_roll_is_slice_by_slice_under_the_cap():
    def script(w):
        seeded(w)
        sp = sm_spec(w)
        seen = set()
        for round_ in range(10):
            summary = w.ctrl.reconcile(nodes(w), sp, NS)
            assert summary.disrupted_slices <= summary.budget_cap == 1
            now = {n for n in ALL if rolling(w, n)}
            seen |= now
            assert now & {"rp-1", "rp-2"} in (set(), {"rp-1", "rp-2"})
            for name in now:
                apply_layout(w, name)
            if not summary.active and round_ > 0:
                break
        final = [(w.label(n, w.c.SLICE_CONFIG_LABEL), w.label(n, w.c.SLICE_CONFIG_STATE_LABEL), rolling(w, n))
                 for n in ALL]
        return seen, final, w.ctrl.rolls_completed_total, w.ctrl.budget_deferred_total > 0

    ref, port = both(script, sides=ROLL_SIDES)
    assert ref[0] == port[0] == set(ALL) and ref[2:] == port[2:] == (4, True)
    assert ref[1] == [("balanced-2x2", "success", False)] * 4
    assert port[1] == [("all-1x2", "success", False)] * 4


def test_stale_success_from_previous_layout_is_not_done():
    def script(w):
        seeded(w)
        patch(w, "solo-1", SLICE_CONFIG_LABEL="old-layout", SLICE_CONFIG_STATE_LABEL=w.side.sliceman.STATE_SUCCESS)
        w.ctrl.reconcile(nodes(w), sm_spec(w, max_unavailable="4"), NS)
        return (w.label("solo-1", w.c.SLICE_CONFIG_LABEL), w.label("solo-1", w.c.SLICE_CONFIG_STATE_LABEL),
                rolling(w, "solo-1"))

    assert both(script, sides=ROLL_SIDES) == (("balanced-2x2", "pending", True), ("all-1x2", "pending", True))


def test_no_desired_layout_is_free_and_releases_abandoned_holds():
    def script(w):
        seeded(w)
        patch(w, "solo-1", REPARTITION_STATE_LABEL=w.c.REPARTITION_STATE_ROLLING)
        summary = w.ctrl.reconcile(nodes(w), w.side.cpt.SliceManagerSpec(), NS)
        return summary.active, summary.desired, rolling(w, "solo-1")

    assert both(script, sides=ROLL_SIDES) == ((False, "", False),) * 2


def test_partial_admission_resumes_without_new_budget():
    def script(w):
        seeded(w)
        patch(w, "rp-1", SLICE_CONFIG_LABEL="balanced-2x2", SLICE_CONFIG_STATE_LABEL="pending",
              REPARTITION_STATE_LABEL=w.c.REPARTITION_STATE_ROLLING)
        patch(w, "solo-1", REMEDIATION_STATE_LABEL=w.c.REMEDIATION_STATE_QUARANTINED)
        summary = w.ctrl.reconcile(nodes(w), sm_spec(w), NS)
        return rolling(w, "rp-2"), summary.admitted_slices, rolling(w, "solo-2")

    assert both(script, sides=ROLL_SIDES) == ((True, 0, False),) * 2


def test_repartition_defers_to_upgrade_and_remediation_holds():
    def script(w):
        seeded(w)
        patch(w, "solo-1", UPGRADE_STATE_LABEL="drain-required")
        sp = sm_spec(w)
        summary = w.ctrl.reconcile(nodes(w), sp, NS)
        first = (summary.admitted_slices, summary.deferred_slices > 0, summary.disrupted_slices, summary.budget_cap)
        patch(w, "solo-1", UPGRADE_STATE_LABEL="upgrade-done")
        return first, w.ctrl.reconcile(nodes(w), sp, NS).admitted_slices

    assert both(script, sides=ROLL_SIDES) == (((0, True, 1, 1), 1),) * 2


def test_repartition_counts_same_pass_remediation_writes():
    def script(w):
        seeded(w)
        sp = sm_spec(w)
        summary = w.ctrl.reconcile(nodes(w), sp, NS, extra_disrupted={"solo-1"})
        first = (summary.admitted_slices, summary.deferred_slices > 0, summary.disrupted_slices, summary.budget_cap,
                 [rolling(w, n) for n in ("rp-1", "rp-2", "solo-2")])
        return first, w.ctrl.reconcile(nodes(w), sp, NS, extra_disrupted=set()).admitted_slices

    assert both(script, sides=ROLL_SIDES) == (((0, True, 1, 1, [False] * 3), 1),) * 2


def test_upgrade_budget_counts_repartition_slices():
    def script(w):
        us_ = w.side.us
        seeded(w)
        patch(w, "solo-1", REPARTITION_STATE_LABEL=w.c.REPARTITION_STATE_ROLLING)
        all_nodes = nodes(w)
        state = us_.ClusterUpgradeState()
        for n in all_nodes:
            state.node_states.setdefault(us_.STATE_UPGRADE_REQUIRED, []).append(
                us_.NodeUpgradeState(node=n, state=us_.STATE_UPGRADE_REQUIRED))
        state.slices = w.side.ss.group_slices(all_nodes)
        for sid, info in state.slices.items():
            for member in info.member_nodes:
                state.slice_of[member] = sid
        pol = w.side.cpt.UpgradePolicySpec(auto_upgrade=True, max_parallel_upgrades=8, max_unavailable=1)
        budget = us_.slice_budget(state, pol)
        pol2 = w.side.cpt.UpgradePolicySpec(auto_upgrade=True, max_parallel_upgrades=8, max_unavailable=2)
        return budget.repartition_sids, "solo-1" in budget.pending_sids, budget.admit, us_.slice_budget(
            state, pol2).admit

    assert both(script, sides=ROLL_SIDES) == (({"solo-1"}, False, 0, 1),) * 2


def test_slice_status_degrades_honestly_while_rolling():
    def script(w):
        seeded(w)
        for name in ("rp-1", "rp-2"):
            patch(w, name, SLICE_READY_LABEL="true")
        patch(w, "rp-2", REPARTITION_STATE_LABEL=w.c.REPARTITION_STATE_ROLLING)
        summary = w.side.ss.aggregate(w.client, NS, nodes(w), validated=set(ALL))
        info = summary.slices[SLICE_ID]
        return (info.repartitioning_hosts, info.ready, [w.label(n, w.c.SLICE_READY_LABEL) for n in ("rp-1", "rp-2")],
                summary.slices["solo-1"].ready)

    assert both(script, sides=ROLL_SIDES) == ((["rp-2"], False, ["false", "false"], True),) * 2


def test_remediation_defers_and_skips_under_repartition():
    def script(w):
        seeded(w)
        for name in ALL:
            w.create(operand_pod(f"plugin-{name}", name))
            w.create(make_validator_pod(name, True, NS))
        for name in ("rp-1", "rp-2"):
            patch(w, name, REPARTITION_STATE_LABEL=w.c.REPARTITION_STATE_ROLLING)
            n = w.node(name)
            n["status"]["allocatable"][w.side.resource] = "0"
            w.client.update(n)
        ctrl = w.side.rem.NodeRemediationController(w.client)
        sp = w.side.cpt.RemediationSpec(enabled=True, max_attempts=3, backoff_seconds=0, max_unavailable="1",
                                        systemic_threshold="90%")
        summary = ctrl.reconcile(nodes(w), sp, NS)
        return summary.skipped, [w.label(n, w.c.REMEDIATION_STATE_LABEL) for n in ("rp-1", "rp-2")], \
            summary.disrupted_slices

    assert both(script, sides=ROLL_SIDES) == ((2, [None, None], 1),) * 2


def test_layouts_are_the_card_slice_managers():
    """Each paired layout is one the port's slice manager applies: on an
    eight-card host it tiles every card (``chip_smoke.py`` phase 8 writes
    the same layouts)."""
    from tpu_operator_torch.sliceman.slice_manager import compute_partitions, resolve_shape

    configs = {name: [{"devices": "all", "partitioned": True, "layout": {"shape": name[4:]}}]
               for name in LAYOUTS.values()}
    chips = [{"index": i, "nvlink_domain": 0} for i in range(8)]
    for layout in LAYOUTS.values():
        part = compute_partitions("1x8", "h100-sxm", resolve_shape(configs[layout], "1x8"), chips)
        assert sorted(c for sub in part["subslices"] for c in sub["chips"]) == list(range(8)), layout
        assert {sub["shape"] for sub in part["subslices"]} == {layout[4:]}
