"""The port's state machine (``controllers/state_manager.py`` with
``object_controls.py`` and its own ``assets/``) against the JAX package's.

Each case runs one script on both sides over paired worlds built from one
table: a reference TPU node of generation v5e is an H100 SXM node, v5p an
H100 PCIe node, a CPU node a CPU node (``WORLD``, ``VARIANTS``). The
reference reads its repo's ``assets/`` and sample CR; the port reads its
package's ``assets/`` and the same CR through
``convert.clusterpolicy_from_reference``. What each side wrote is compared
through ``convert``: node labels through ``object_from_reference`` with
``VARIANTS``, object names through the pairing of the two asset trees
document by document (``ASSET_NAMES``) and, for DaemonSets, through
``object_from_reference``. Tolerance: exact equality, apart from those
renames and the hash annotation (the rendered objects carry different
names, so their hashes differ by design; each side's hash is held to its
properties: deterministic, moved by a spec edit, unmoved by a no-op pass).

The first 17 cases are those of ``tests/test_state_machine.py``; the rest
are the ``ClusterPolicyController`` half of ``tests/test_render_cache.py``.
Its slice-memo case needs the reconciler, which this package has not
ported; its counterpart here holds the controller's own part of that key,
the node store version the label scan consumed.
"""

import copy
import logging
import os
from types import SimpleNamespace

import pytest
import yaml

from tests.conftest import make_cpu_node as ref_cpu_node, make_tpu_node
from tpu_operator import consts as ref_consts
from tpu_operator.controllers import object_controls as ref_oc, resource_manager as ref_rm
from tpu_operator.controllers import state_manager as ref_sm
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube.cache import CachedClient as RefCachedClient
from tpu_operator.kube.frozen import FrozenObjectError as RefFrozen
from tpu_operator_torch import consts, convert
from tpu_operator_torch.api.v1.clusterpolicy_types import State
from tpu_operator_torch.controllers import object_controls as oc, resource_manager as rm, state_manager as sm
from tpu_operator_torch.kube.cache import CachedClient
from tpu_operator_torch.kube.client import FakeClient
from tpu_operator_torch.kube.frozen import FrozenObjectError
from tpu_operator_torch.kube.testing import make_cpu_node, make_gpu_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ASSETS = os.path.join(REPO, "assets")
SAMPLE_CR = os.path.join(REPO, "config", "samples", "v1_clusterpolicy.yaml")
NS = "tpu-operator"
CPV = "tpu.k8s.io/v1"
UID = "test-uid-1234"

# reference generation -> the port's card variant
VARIANTS = {"v5e": "h100-sxm", "v5p": "h100-pcie", "v4": "h100-nvl"}
# one table builds both worlds: kind -> (reference node, port node)
NODE_KINDS = {
    "v5e": (lambda name, **kw: make_tpu_node(name, **kw),
            lambda name, **kw: make_gpu_node(name, **kw)),
    "v5p": (lambda name, **kw: make_tpu_node(name, accelerator="tpu-v5p-slice", topology="2x2x1", **kw),
            lambda name, **kw: make_gpu_node(name, variant="h100-pcie", product="NVIDIA-H100-PCIe", **kw)),
    "v4": (lambda name, **kw: make_tpu_node(name, accelerator="tpu-v4-podslice", **kw),
           lambda name, **kw: make_gpu_node(name, variant="h100-nvl", product="NVIDIA-H100-NVL", **kw)),
    "cpu": (lambda name, **kw: ref_cpu_node(name), lambda name, **kw: make_cpu_node(name)),
}
WORLD = [("tpu-node-1", "v5e"), ("tpu-node-2", "v5p"), ("cpu-node-1", "cpu")]


def ref_cr():
    with open(SAMPLE_CR) as f:
        obj = yaml.safe_load(f)
    obj["metadata"]["uid"] = UID
    return obj


def _asset_names():
    """(kind, reference name) -> the port's name, pairing the two asset
    trees document by document."""
    names = {}
    for state in ref_sm.STATE_ORDER:
        _, ref_controls = ref_rm.add_resources_controls(os.path.join(REF_ASSETS, state))
        _, controls = rm.add_resources_controls(os.path.join(sm.PACKAGE_ASSETS_DIR, state))
        for (_, a), (_, b) in zip(ref_controls, controls):
            names[(a["kind"], a["metadata"]["name"])] = b["metadata"]["name"]
    return names


ASSET_NAMES = _asset_names()


def _ref_name(kind, name):
    if kind == "DaemonSet":
        return convert.object_from_reference(
            {"kind": kind, "metadata": {"name": name, "labels": {"app": name}}}, VARIANTS)["metadata"]["name"]
    return ASSET_NAMES.get((kind, name), name)


SIDES = {
    "reference": SimpleNamespace(
        name="reference", consts=ref_consts, sm=ref_sm, oc=ref_oc, FakeClient=RefFakeClient,
        CachedClient=RefCachedClient, Frozen=RefFrozen, assets=REF_ASSETS, cr=ref_cr, node=0,
        obj=lambda o: convert.object_from_reference(o, VARIANTS), name_of=_ref_name,
        gen=lambda g: g, gen_out=lambda g: VARIANTS.get(g, g), driver_ds="tpu-libtpu-daemonset", plugin_ds="tpu-device-plugin-daemonset",
        driver_spec="libtpu", toolkit_ds="tpu-runtime-daemonset", exporter_ds="tpu-metrics-exporter",
        vm_ds="tpu-vm-manager-daemonset", vfio_ds="tpu-vfio-manager-daemonset", tfd_ds="tpu-feature-discovery",
        nfd_label=ref_consts.NFD_TPU_PCI_LABEL, rule_label=ref_consts.NFD_RULE_TPU_PCI_LABEL,
        skip_msg="no TPU nodes; skipping",
        logger="tpu-operator.controls"),
    "port": SimpleNamespace(
        name="port", consts=consts, sm=sm, oc=oc, FakeClient=FakeClient, CachedClient=CachedClient,
        Frozen=FrozenObjectError, assets=sm.PACKAGE_ASSETS_DIR,
        cr=lambda: convert.clusterpolicy_from_reference(ref_cr()), node=1, obj=copy.deepcopy,
        name_of=lambda kind, name: name, gen=VARIANTS.get, gen_out=lambda g: g, driver_ds="gpu-driver-daemonset",
        plugin_ds="gpu-device-plugin-daemonset", driver_spec="driver", toolkit_ds="gpu-toolkit-daemonset",
        exporter_ds="gpu-metrics-exporter", vm_ds="gpu-vm-manager-daemonset", vfio_ds="gpu-vfio-manager-daemonset",
        tfd_ds="gpu-feature-discovery", nfd_label=consts.NFD_GPU_PCI_LABEL, rule_label=consts.NFD_RULE_GPU_PCI_LABEL,
        skip_msg="no GPU nodes; skipping",
        logger="gpu-operator.controls"),
}


def nodes(side, world=WORLD, extra_labels=None):
    return [NODE_KINDS[kind][side.node](name, **({"extra_labels": extra_labels} if extra_labels and kind != "cpu"
                                                   else {})) for name, kind in world]


def make_ctrl(side, world=WORLD, cr_edit=None, node_objs=None, init=True):
    client = side.FakeClient(
        [{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}]
        + (node_objs if node_objs is not None else nodes(side, world))
    )
    cr = side.cr()
    if cr_edit:
        cr_edit(side, cr)
    client.create(cr)
    c = side.sm.ClusterPolicyController(client, assets_dir=side.assets)
    if init:
        reinit(c)
    return c


def reinit(c):
    c.init(c.client.get(CPV, "ClusterPolicy", "cluster-policy"))


def both(script, monkeypatch=None, *args):
    """``script`` on each side; the reference's result first."""
    if monkeypatch is not None:
        monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    return script(SIDES["reference"], *args), script(SIDES["port"], *args)


def run_all_states(c, side):
    """Step every state, marking each DaemonSet scheduled and (OnDelete)
    running pods at the template hash after each step, as the reference's
    test does."""
    statuses = {}
    c.idx = 0
    while not c.last():
        name = c.state_names[c.idx]
        statuses[name] = c.step()
        for ds in c.client.list("apps/v1", "DaemonSet", NS):
            if not ds.get("status"):
                ds["status"] = {"desiredNumberScheduled": 2, "numberUnavailable": 0, "updatedNumberScheduled": 2}
                c.client.update_status(ds)
            if ds["spec"].get("updateStrategy", {}).get("type") == "OnDelete":
                app = ds["spec"]["selector"]["matchLabels"]["app"]
                h = ds["spec"]["template"]["metadata"].get("annotations", {}).get(
                    side.consts.LAST_APPLIED_HASH_ANNOTATION)
                for i in range(2):
                    pod = {"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": f"{app}-{i}", "namespace": NS, "labels": {"app": app},
                                        "annotations": {side.consts.LAST_APPLIED_HASH_ANNOTATION: h}},
                           "status": {"phase": "Running"}}
                    existing = c.client.get_or_none("v1", "Pod", pod["metadata"]["name"], NS)
                    if existing is None:
                        c.client.create(pod)
                    elif existing["metadata"].get("annotations", {}).get(
                            side.consts.LAST_APPLIED_HASH_ANNOTATION) != h:
                        pod["metadata"]["resourceVersion"] = existing["metadata"]["resourceVersion"]
                        c.client.update(pod)
    return statuses


def operator_labels(side, client, name, before):
    """The labels the operator wrote on a node, as the port names them."""
    node = side.obj(client.get("v1", "Node", name))
    start = side.obj({"kind": "Node", "metadata": {"labels": dict(before)}})["metadata"]["labels"]
    return {k: v for k, v in node["metadata"]["labels"].items() if start.get(k) != v}


def written(side, client):
    """{(kind, port name)} of every object the state machine wrote."""
    skip = ("Namespace", "Node", "ClusterPolicy", "Pod", "Event")
    return sorted((o["kind"], side.name_of(o["kind"], o["metadata"]["name"]))
                  for o in client.all_objects() if o["kind"] not in skip)


def ds_projection(side, ds):
    """A DaemonSet as the port names it, without its hashes and images."""
    d = side.obj(ds)
    spec = d["spec"]["template"]["spec"]
    return {
        "name": d["metadata"]["name"],
        "namespace": d["metadata"].get("namespace"),
        "app": d["metadata"]["labels"].get("app"),
        "selector": d["spec"]["selector"],
        "template_labels": d["spec"]["template"]["metadata"].get("labels"),
        "strategy": d["spec"].get("updateStrategy"),
        "node_selector": spec.get("nodeSelector"),
        "tolerations": [convert.clusterpolicy_from_reference({"t": t})["t"] if side.name == "reference" else t
                        for t in spec.get("tolerations", [])],
        "inits": [c["name"] for c in spec.get("initContainers", [])],
        "containers": len(spec.get("containers", [])),
        "owner": [(r["kind"], r["name"], r["uid"]) for r in d["metadata"].get("ownerReferences", [])],
    }


def env_of(container):
    return {e["name"]: e.get("value") for e in container.get("env", [])}


# ---------------------------------------------------------------------------
# tests/test_state_machine.py
# ---------------------------------------------------------------------------


def test_init_labels_tpu_nodes(monkeypatch):
    def script(side):
        before = {name: dict(n["metadata"]["labels"]) for (name, _), n in zip(WORLD, nodes(side))}
        c = make_ctrl(side)
        labels = {name: operator_labels(side, c.client, name, before[name]) for name, _ in WORLD}
        return labels, c.has_tpu_nodes, sorted(side.gen_out(g) for g in c.tpu_generations), c.runtime

    ref, port = both(script, monkeypatch)
    assert ref == port
    labels = port[0]["tpu-node-1"]
    assert labels[consts.TPU_PRESENT_LABEL] == "true"
    assert labels[consts.DEPLOY_LABEL_PREFIX + "driver"] == "true"
    assert labels[consts.GENERATION_LABEL] == "h100-sxm"
    assert consts.DEPLOY_LABEL_PREFIX + "vm-manager" not in labels
    assert port[0]["cpu-node-1"] == {}
    assert port[1:] == (True, ["h100-pcie", "h100-sxm"], "containerd")


def test_non_gke_nfd_detection(monkeypatch):
    """A node without feature discovery's labels is detected by NFD's PCI
    label or the NodeFeatureRule label; it has no variant."""

    def script(side):
        a, b = nodes(side, [("bare-metal-1", "cpu"), ("bare-metal-2", "cpu")])
        a["metadata"]["labels"][side.nfd_label] = "true"
        b["metadata"]["labels"][side.rule_label] = "true"
        objs = [a, b, nodes(side, [("cpu-node-1", "cpu")])[0]]
        before = {n["metadata"]["name"]: dict(n["metadata"]["labels"]) for n in objs}
        c = make_ctrl(side, node_objs=objs)
        out = {name: operator_labels(side, c.client, name, labels) for name, labels in before.items()}
        return out, c.has_tpu_nodes, c.tpu_node_count

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert port[0]["bare-metal-1"][consts.DEPLOY_LABEL_PREFIX + "driver"] == "true"
    assert consts.GENERATION_LABEL not in port[0]["bare-metal-2"]
    assert port[0]["cpu-node-1"] == {} and port[1:] == (True, 2)


def test_all_18_states_load(monkeypatch):
    ref, port = both(lambda side: make_ctrl(side).state_names, monkeypatch)
    assert ref == port == sm.STATE_ORDER == ref_sm.STATE_ORDER
    assert len(port) == 18 and sm.SANDBOX_STATES == ref_sm.SANDBOX_STATES
    assert sm._PARALLEL_AFTER_PREREQS == ref_sm._PARALLEL_AFTER_PREREQS


def test_full_step_through_all_states(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_all_states(c, side)
        statuses = run_all_states(c, side)
        ds = c.client.get("apps/v1", "DaemonSet", side.plugin_ds, NS)
        return statuses, written(side, c.client), ds_projection(side, ds), ds

    ref, port = both(script, monkeypatch)
    assert ref[:3] == port[:3]
    for name, st in port[0].items():
        assert st in (State.READY, State.DISABLED), f"{name}: {st}"
    ds = port[3]
    ctr = ds["spec"]["template"]["spec"]["containers"][0]
    assert ctr["image"] == "gcr.io/tpu-operator/gpu-device-plugin:0.9.0"
    env = env_of(ctr)
    assert (env["SLICE_STRATEGY"], env["CDI_ENABLED"], env["DRIVER_ROOT"]) == ("single", "true", consts.DRIVER_ROOT)
    assert "TPU_RESOURCE" not in env
    init = ds["spec"]["template"]["spec"]["initContainers"][0]
    assert init["image"] == "gcr.io/tpu-operator/gpu-operator-validator:0.9.0"
    assert ds["metadata"]["namespace"] == NS
    assert ds["metadata"]["ownerReferences"][0]["kind"] == "ClusterPolicy"


@pytest.mark.parametrize("sandbox", [False, True])
def test_sandbox_states_disabled_by_default(monkeypatch, sandbox):
    """Sandbox states stay disabled by default; with sandbox workloads on
    and no vm-passthrough node their DaemonSets exist and are vacuously
    ready (the reference's ``test_sandbox_enabled_container_nodes_still_ready``
    is the ``True`` case)."""

    def edit(side, cr):
        cr["spec"]["sandboxWorkloads"]["enabled"] = sandbox

    def script(side):
        c = make_ctrl(side, world=WORLD[:1] if sandbox else WORLD, cr_edit=edit)
        run_all_states(c, side)
        statuses = run_all_states(c, side)
        present = [c.client.get_or_none("apps/v1", "DaemonSet", n, NS) is not None
                   for n in (side.vm_ds, side.vfio_ds)]
        return statuses, present

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert port[1] == [sandbox, sandbox]
    assert all(st in (State.READY, State.DISABLED) for st in port[0].values())


def test_hash_idempotency(monkeypatch):
    """A second pass churns no object on either side."""

    def script(side):
        c = make_ctrl(side)
        run_all_states(c, side)

        def versions():
            return {(o["kind"], o["metadata"].get("namespace", ""), side.name_of(o["kind"], o["metadata"]["name"])):
                    o["metadata"]["resourceVersion"] for o in c.client.all_objects()}

        before = versions()
        run_all_states(c, side)
        after = versions()
        return sorted(k for k in before if k in after and before[k] != after[k])

    assert both(script, monkeypatch) == ([], [])


def test_disable_operand_deletes_daemonset(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_all_states(c, side)
        had = c.client.get_or_none("apps/v1", "DaemonSet", side.exporter_ds, NS) is not None
        cr = c.client.get(CPV, "ClusterPolicy", "cluster-policy")
        cr["spec"]["metricsExporter"]["enabled"] = False
        c.client.update(cr)
        reinit(c)
        statuses = run_all_states(c, side)
        return had, c.client.get_or_none("apps/v1", "DaemonSet", side.exporter_ds, NS), statuses

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert port[:2] == (True, None)


def test_libtpu_generation_fanout(monkeypatch):
    """One driver DaemonSet per variant present, each with its own app
    identity and node selector, the base swept; a variant leaving sweeps
    its DaemonSet."""

    def edit(side, cr):
        cr["spec"][side.driver_spec]["generationConfigs"] = {
            side.gen("v5e"): "2025.1.0-v5e", side.gen("v5p"): "2025.1.0-v5p"}

    def script(side):
        c = make_ctrl(side, cr_edit=edit)
        run_all_states(c, side)
        out = [sorted(ds_projection(side, d).items()) for d in sorted(
            c.client.list("apps/v1", "DaemonSet", NS), key=lambda d: side.name_of("DaemonSet", d["metadata"]["name"]))
            if d["metadata"]["name"].startswith(side.driver_ds)]
        images = sorted(ctr["image"] for d in c.client.list("apps/v1", "DaemonSet", NS)
                        if d["metadata"]["name"].startswith(side.driver_ds)
                        for ctr in d["spec"]["template"]["spec"]["containers"])
        c.client.delete("v1", "Node", "tpu-node-2")
        reinit(c)
        run_all_states(c, side)
        left = sorted(side.name_of("DaemonSet", d["metadata"]["name"])
                      for d in c.client.list("apps/v1", "DaemonSet", NS)
                      if d["metadata"]["name"].startswith(side.driver_ds))
        return out, left, images

    ref, port = both(script, monkeypatch)
    assert ref[:2] == port[:2]
    assert [dict(p)["name"] for p in port[0]] == ["gpu-driver-daemonset-h100-pcie", "gpu-driver-daemonset-h100-sxm"]
    assert dict(port[0][1])["node_selector"][consts.GENERATION_LABEL] == "h100-sxm"
    assert port[1] == ["gpu-driver-daemonset-h100-sxm"]
    assert port[2] == ["gcr.io/tpu-operator/gpu-driver-installer:2025.1.0-v5e",
                       "gcr.io/tpu-operator/gpu-driver-installer:2025.1.0-v5p"]


def test_ondelete_readiness_uses_pod_hash(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_all_states(c, side)
        ds = c.client.get("apps/v1", "DaemonSet", side.driver_ds, NS)
        want = ds["spec"]["template"]["metadata"]["annotations"][side.consts.LAST_APPLIED_HASH_ANNOTATION]
        ds["status"] = {"desiredNumberScheduled": 2, "numberUnavailable": 0}
        c.client.update_status(ds)
        ds = c.client.get("apps/v1", "DaemonSet", side.driver_ds, NS)
        for pod in c.client.list("v1", "Pod", NS):
            c.client.delete("v1", "Pod", pod["metadata"]["name"], NS)

        def mk_pod(name, h):
            return {"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": name, "namespace": NS, "labels": {"app": side.driver_ds},
                                 "annotations": {side.consts.LAST_APPLIED_HASH_ANNOTATION: h}},
                    "status": {"phase": "Running"}}

        c.client.create(mk_pod("driver-1", want))
        c.client.create(mk_pod("driver-2", "stale-hash"))
        stale_ready = side.oc.is_daemonset_ready(c, ds)
        stale = c.client.get("v1", "Pod", "driver-2", NS)
        stale["metadata"]["annotations"][side.consts.LAST_APPLIED_HASH_ANNOTATION] = want
        c.client.update(stale)
        return stale_ready, side.oc.is_daemonset_ready(c, ds)

    assert both(script, monkeypatch) == ((False, True), (False, True))


def test_compute_hash_deterministic():
    obj = {"kind": "DaemonSet", "metadata": {"labels": {"a": "1"}, "annotations": {"x": "y"}},
           "spec": {"template": {"spec": {"containers": [{"name": "c"}]}}}}
    obj2 = {"spec": {"template": {"spec": {"containers": [{"name": "c"}]}}},
            "metadata": {"annotations": {"x": "y"}, "labels": {"a": "1"}}, "kind": "DaemonSet"}
    obj3 = copy.deepcopy(obj)
    obj3["metadata"]["annotations"][consts.LAST_APPLIED_HASH_ANNOTATION] = "zzz"
    hashes = [mod.compute_hash(copy.deepcopy(o)) for mod in (ref_oc, oc) for o in (obj, obj2, obj3)]
    assert len(set(hashes)) == 1


def test_workload_config_vm_passthrough(monkeypatch):
    def edit(side, cr):
        cr["spec"]["sandboxWorkloads"]["enabled"] = True

    def script(side):
        node = nodes(side, [("vm-node", "v5e")], extra_labels={consts.WORKLOAD_CONFIG_LABEL: "vm-passthrough"})
        before = dict(node[0]["metadata"]["labels"])
        c = make_ctrl(side, cr_edit=edit, node_objs=node)
        return operator_labels(side, c.client, "vm-node", before)

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert port[consts.DEPLOY_LABEL_PREFIX + "vfio-manager"] == "true"
    assert consts.DEPLOY_LABEL_PREFIX + "driver" not in port


def test_no_tpu_nodes_all_ready(monkeypatch):
    def script(side):
        c = make_ctrl(side, world=[("cpu-only", "cpu")])
        statuses = []
        while not c.last():
            statuses.append(c.step())
        return c.has_tpu_nodes, statuses, c.client.list("apps/v1", "DaemonSet", NS)

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert port[0] is False and port[2] == [] and set(port[1]) <= {State.READY, State.DISABLED}


def test_missing_namespace_env_raises(monkeypatch):
    monkeypatch.delenv(consts.OPERATOR_NAMESPACE_ENV, raising=False)
    for side in SIDES.values():
        c = make_ctrl(side, world=[], init=False)
        with pytest.raises(RuntimeError, match="OPERATOR_NAMESPACE"):
            reinit(c)


def test_state_dag_waves_cover_every_state_exactly_once():
    waves = sm.state_waves(sm.STATE_ORDER)
    assert waves == ref_sm.state_waves(ref_sm.STATE_ORDER)
    assert sm.STATE_DAG == ref_sm.STATE_DAG
    assert sorted(s for w in waves for s in w) == sorted(sm.STATE_ORDER)
    assert waves[0] == ["pre-requisites"] and len(waves[1]) > 1
    wave_of = {s: i for i, wave in enumerate(waves) for s in wave}
    for state, deps in sm.STATE_DAG.items():
        assert all(wave_of[d] < wave_of[state] for d in deps), state
    chain = [s for s in sm.STATE_ORDER if s in sm.SANDBOX_STATES]
    assert all(wave_of[a] < wave_of[b] for a, b in zip(chain, chain[1:]))


def test_state_waves_subset_preserves_order():
    subset = ["pre-requisites", "state-libtpu", "state-vm-manager"]
    waves = sm.state_waves(subset)
    assert waves == ref_sm.state_waves(subset)
    wave_of = {s: i for i, wave in enumerate(waves) for s in wave}
    assert wave_of["pre-requisites"] < wave_of["state-libtpu"]


def test_run_states_outcomes_in_state_order_and_isolated(monkeypatch):
    """One raising state comes back as its exception; its wave-mates still
    deploy; outcomes in STATE_ORDER."""

    def script(side):
        c = make_ctrl(side)
        real = c.run_state

        def boom(state):
            if state == "state-metricsd":
                raise RuntimeError("busted asset")
            return real(state)

        c.run_state = boom
        results = c.run_states()
        outcomes = [(s, type(o).__name__ if isinstance(o, Exception) else o) for s, o in results]
        return outcomes, c.client.get_or_none("apps/v1", "DaemonSet", side.tfd_ds, NS) is not None, c.last()

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert [s for s, _ in port[0]] == sm.STATE_ORDER
    assert dict(port[0])["state-metricsd"] == "RuntimeError" and port[1:] == (True, True)


# ---------------------------------------------------------------------------
# tests/test_render_cache.py, the ClusterPolicyController half
# ---------------------------------------------------------------------------


def run_states(c):
    c.idx = 0
    statuses = {}
    while not c.last():
        name = c.state_names[c.idx]
        statuses[name] = c.step()
    return statuses


def _cache_stats(c):
    st = c.render_cache.stats()
    return {"renders": c.render_cache.renders_total, "entries": len(c.render_cache),
            "invalidations": st["invalidations"], "last_pass": st["last_pass"]}


def test_steady_state_pass_renders_nothing(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_states(c)
        first = c.render_cache.renders_total
        fp = c.render_cache.fingerprint
        reinit(c)
        run_states(c)
        st = c.render_cache.stats()
        return (first, _cache_stats(c), st["fingerprint"] == fp == c.render_cache.fingerprint,
                bool(st["render_ms_by_state"]))

    ref, port = both(script, monkeypatch)
    assert ref == port
    first, stats, fp_stable, attributed = port
    assert first > 0 and stats["renders"] == first and fp_stable and attributed
    assert stats["last_pass"]["misses"] == 0 and stats["last_pass"]["hit_rate"] == 1.0
    assert stats["invalidations"] == 0


def test_steady_state_still_idempotent_and_converged(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_states(c)

        def versions():
            return {(o["kind"], o["metadata"]["name"]): o["metadata"]["resourceVersion"]
                    for o in c.client.all_objects()}

        before = versions()
        reinit(c)
        run_states(c)
        after = versions()
        return sorted(k for k in before if k in after and before[k] != after[k])

    assert both(script, monkeypatch) == ([], [])


def test_cache_hit_still_repairs_external_drift(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_states(c)
        ds = c.client.get("apps/v1", "DaemonSet", side.plugin_ds, NS)
        ds["metadata"]["annotations"][side.consts.LAST_APPLIED_HASH_ANNOTATION] = "tampered"
        ds["spec"]["template"]["spec"]["containers"][0]["image"] = "evil:latest"
        c.client.update(ds)
        renders = c.render_cache.renders_total
        reinit(c)
        run_states(c)
        repaired = c.client.get("apps/v1", "DaemonSet", side.plugin_ds, NS)
        return c.render_cache.renders_total - renders, repaired["spec"]["template"]["spec"]["containers"][0]["image"]

    ref, port = both(script, monkeypatch)
    assert ref[0] == port[0] == 0
    assert (ref[1], port[1]) == ("gcr.io/tpu-operator/tpu-device-plugin:0.9.0",
                                 "gcr.io/tpu-operator/gpu-device-plugin:0.9.0")


def test_spec_edit_invalidates_and_rerenders(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_states(c)
        first, fp = c.render_cache.renders_total, c.render_cache.fingerprint
        cr = c.client.get(CPV, "ClusterPolicy", "cluster-policy")
        cr["spec"]["devicePlugin"]["env"] = [{"name": "RENDER_CACHE_TEST", "value": "1"}]
        c.client.update(cr)
        reinit(c)
        moved = c.render_cache.fingerprint != fp
        run_states(c)
        ds = c.client.get("apps/v1", "DaemonSet", side.plugin_ds, NS)
        env = env_of(ds["spec"]["template"]["spec"]["containers"][0])
        return moved, c.render_cache.stats()["invalidations"], c.render_cache.renders_total - first, env[
            "RENDER_CACHE_TEST"]

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert port[0] and port[1] == 1 and port[2] > 0 and port[3] == "1"


def test_new_generation_renders_exactly_one_entry(monkeypatch):
    def edit(side, cr):
        cr["spec"][side.driver_spec]["generationConfigs"] = {
            side.gen("v5e"): "2025.1.0-v5e", side.gen("v5p"): "2025.1.0-v5p"}

    def script(side):
        c = make_ctrl(side, cr_edit=edit)
        run_states(c)
        first, entries, fp = c.render_cache.renders_total, len(c.render_cache), c.render_cache.fingerprint
        c.client.create(nodes(side, [("tpu-node-3", "v4")])[0])
        reinit(c)
        gens = sorted(side.gen_out(g) for g in c.tpu_generations)
        moved = c.render_cache.fingerprint != fp
        run_states(c)
        return (gens, moved, c.render_cache.renders_total - first, c.render_cache.stats()["invalidations"],
                len(c.render_cache) - entries,
                c.client.get_or_none("apps/v1", "DaemonSet", f"{side.driver_ds}-{side.gen('v4')}", NS) is not None)

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert port == (["h100-nvl", "h100-pcie", "h100-sxm"], True, 1, 0, 1, True)


def test_removed_generation_drops_entry_without_rerender(monkeypatch):
    def edit(side, cr):
        cr["spec"][side.driver_spec]["generationConfigs"] = {side.gen("v5e"): "2025.1.0-v5e"}

    def script(side):
        c = make_ctrl(side, cr_edit=edit)
        run_states(c)
        first, entries = c.render_cache.renders_total, len(c.render_cache)
        c.client.delete("v1", "Node", "tpu-node-2")
        reinit(c)
        run_states(c)
        return (c.render_cache.renders_total - first, len(c.render_cache) - entries,
                c.client.get_or_none("apps/v1", "DaemonSet", f"{side.driver_ds}-{side.gen('v5p')}", NS))

    assert both(script, monkeypatch) == ((0, -1, None), (0, -1, None))


def test_runtime_change_invalidates(monkeypatch):
    """A runtime flip re-renders the world; the toolkit's containerd
    drop-in directory goes with containerd (the reference's
    ``CONTAINER_RUNTIME``)."""

    def script(side):
        c = make_ctrl(side)
        run_states(c)
        first, was = c.render_cache.renders_total, c.runtime
        for name in ("tpu-node-1", "tpu-node-2"):
            node = c.client.get("v1", "Node", name)
            node["status"]["nodeInfo"]["containerRuntimeVersion"] = "cri-o://1.28"
            c.client.update_status(node)
        reinit(c)
        now = c.runtime
        run_states(c)
        ds = c.client.get("apps/v1", "DaemonSet", side.toolkit_ds, NS)
        return (was, now, c.render_cache.stats()["invalidations"], c.render_cache.renders_total > first,
                env_of(ds["spec"]["template"]["spec"]["containers"][0]))

    ref, port = both(script, monkeypatch)
    assert ref[:4] == port[:4] == ("containerd", "crio", 1, True)
    assert ref[4]["CONTAINER_RUNTIME"] == "crio"
    assert "CONTAINERD_CONF_DIR" not in port[4] and port[4]["CDI_SPEC_PATH"] == consts.CDI_SPEC_PATH


def test_cr_recreate_invalidates_via_uid(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_states(c)
        first = c.render_cache.renders_total
        c.client.delete(CPV, "ClusterPolicy", "cluster-policy")
        cr = side.cr()
        cr["metadata"]["uid"] = "render-cache-uid-2"
        c.client.create(cr)
        reinit(c)
        run_states(c)
        ds = c.client.get("apps/v1", "DaemonSet", side.plugin_ds, NS)
        return (c.render_cache.stats()["invalidations"], c.render_cache.renders_total > first,
                ds["metadata"]["ownerReferences"][0]["uid"])

    assert both(script, monkeypatch) == ((1, True, "render-cache-uid-2"),) * 2


def test_cached_manifests_reject_mutation(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_states(c)
        manifest, content_hash = c.render_cache.lookup(("state-device-plugin", "DaemonSet", side.plugin_ds, ""))
        raised = []
        for mutate in (lambda: manifest["metadata"].__setitem__("labels", {}),
                       lambda: manifest["spec"]["template"]["spec"]["containers"].append({}),
                       lambda: manifest["spec"]["template"]["metadata"].__delitem__("annotations")):
            with pytest.raises(side.Frozen):
                mutate()
            raised.append(True)
        return bool(content_hash), raised

    assert both(script, monkeypatch) == ((True, [True] * 3),) * 2


def test_no_tpu_skip_logs_once_per_transition(monkeypatch, caplog):
    def script(side):
        c = make_ctrl(side, world=[("cpu-only", "cpu")])

        def skips():
            return [r.getMessage() for r in caplog.records
                    if r.levelno == logging.INFO and side.skip_msg in r.getMessage()]

        caplog.clear()
        with caplog.at_level(logging.INFO, logger=side.logger):
            run_states(c)
            reinit(c)
            run_states(c)
        first = skips()
        caplog.clear()
        c.client.create(nodes(side, [("tpu-node-1", "v5e")])[0])
        reinit(c)
        run_states(c)
        c.client.delete("v1", "Node", "tpu-node-1")
        reinit(c)
        with caplog.at_level(logging.INFO, logger=side.logger):
            run_states(c)
        again = skips()
        return (sorted(side.name_of("DaemonSet", m.rsplit(" ", 1)[1]) for m in first), len(first) == len(set(first)),
                len(again))

    ref, port = both(script, monkeypatch)
    assert ref == port
    assert port[0] and port[1] and port[2] == len(port[0])


def test_label_world_key_tracks_the_listed_node_version(monkeypatch):
    """Over a ``CachedClient``: a settled pass memoizes the label world
    under the node store version its list was taken at; a node event moves
    the store past it and the next pass rescans."""

    def script(side):
        inner = make_ctrl(side, init=False).client
        cached = side.CachedClient(inner, namespace=NS)
        assert cached.start_informers() is True
        try:
            c = side.sm.ClusterPolicyController(cached, assets_dir=side.assets)
            reinit(c)  # labels the nodes: the pass wrote, so it is not memoized
            first = c._label_world is not None
            reinit(c)
            settled = (c._label_world is not None, c._nodes_cache_version == cached.store_version("v1", "Node"))
            node = inner.get("v1", "Node", "tpu-node-1")
            node["metadata"]["labels"]["tpu.k8s.io/chip.failed"] = "true"
            inner.update(node)
            moved = c._nodes_cache_version != cached.store_version("v1", "Node")
            reinit(c)
            return first, settled, moved, c._nodes_cache_version == cached.store_version("v1", "Node")
        finally:
            cached.stop()

    ref, port = both(script, monkeypatch)
    assert ref == port == (False, (True, True), True, True)


def test_delete_daemonsets_like_served_from_snapshot(monkeypatch):
    def script(side):
        c = make_ctrl(side)
        run_states(c)

        class CountingClient:
            def __init__(self, inner):
                self._inner = inner
                self.ds_lists = 0

            def list(self, api_version, kind, namespace="", *a, **kw):
                if kind == "DaemonSet":
                    self.ds_lists += 1
                return self._inner.list(api_version, kind, namespace, *a, **kw)

            def __getattr__(self, name):
                return getattr(self._inner, name)

        counting = CountingClient(c.client)
        c.client = counting
        c.begin_pass()
        for base in (side.vm_ds, side.vfio_ds):
            side.oc._delete_daemonsets_like(c, base)
        return counting.ds_lists, c.end_pass()["daemonsets_memoized"]

    assert both(script, monkeypatch) == ((1, 1), (1, 1))
