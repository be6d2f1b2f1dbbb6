"""The port's per-operand DaemonSet rendering through a whole reconcile
(``ClusterPolicyReconciler`` over the port's ``assets/``) against the JAX
package's, on the 25 cases of ``tests/test_daemonset_common.py``: the
``OPERANDS`` table (14 operands) and its ten named cases.

Each case runs one script on both packages (``both``): each side on its own
``FakeClient`` with its own sample ClusterPolicy (the reference's
``config/samples/v1_clusterpolicy.yaml``, edited once, then given to the
port through ``convert.clusterpolicy_from_reference``) and one card node
named ``n1`` (the reference's ``make_tpu_node``, the port's
``make_gpu_node``). The script reads the rendered DaemonSet and returns its
outcomes in the port's names: a reference name becomes the port's through
``NAMES`` (operand apps through ``consts.OPERAND_APPS``, ``libtpu`` →
``driver``, ``runtime`` → ``toolkit``, ``jax`` → ``cuda``, the images through the
CR's ``VALUE_RENAMES``, the workload
pods' ``JAX_WORKLOAD_*`` → ``CUDA_WORKLOAD_*``, the trusted CA's bundle
variable → ``SSL_CERT_FILE``). Tolerance: exact equality of the outcomes
under that rename, and each outcome is the one the reference's case
asserts.

``tests/test_torch_object_controls.py`` already holds the transforms one
asset at a time (``_render_daemonset`` on the RICH policy); these cases
drive the whole reconcile, as the reference's do.
"""

import os
from types import SimpleNamespace

import pytest
import yaml

from tpu_operator import consts as ref_consts
from tpu_operator.controllers import clusterpolicy_controller as ref_cpc
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube.testing import make_tpu_node
from tpu_operator.validator import workload_pods as ref_wp
from tpu_operator_torch import consts, convert
from tpu_operator_torch.api.v1.clusterpolicy_types import ENV_VAR_RENAMES, VALUE_RENAMES
from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
from tpu_operator_torch.kube.client import FakeClient
from tpu_operator_torch.kube.testing import make_gpu_node
from tpu_operator_torch.validator import workload_pods as wp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"

# spec key in the reference's CR -> (reference DaemonSet, component, sandbox?)
OPERANDS = {
    "libtpu": ("tpu-libtpu-daemonset", "COMPONENT_LIBTPU", False),
    "runtime": ("tpu-runtime-daemonset", "COMPONENT_RUNTIME", False),
    "devicePlugin": ("tpu-device-plugin-daemonset", "COMPONENT_DEVICE_PLUGIN", False),
    "metricsd": ("tpu-metricsd", "COMPONENT_METRICSD", False),
    "metricsExporter": ("tpu-metrics-exporter", "COMPONENT_METRICS_EXPORTER", False),
    "nodeStatusExporter": ("tpu-node-status-exporter", "COMPONENT_NODE_STATUS_EXPORTER", False),
    "tfd": ("tpu-feature-discovery", "COMPONENT_TFD", False),
    "maintenanceHandler": ("tpu-maintenance-handler", "COMPONENT_MAINTENANCE_HANDLER", False),
    "sliceManager": ("tpu-slice-manager", "COMPONENT_SLICE_MANAGER", False),
    "vfioManager": ("tpu-vfio-manager-daemonset", "COMPONENT_VFIO_MANAGER", True),
    "sandboxDevicePlugin": ("tpu-sandbox-device-plugin-daemonset", "COMPONENT_SANDBOX_DEVICE_PLUGIN", True),
    "vmManager": ("tpu-vm-manager-daemonset", "COMPONENT_VM_MANAGER", True),
    "vmDeviceManager": ("tpu-vm-device-manager", "COMPONENT_VM_DEVICE_MANAGER", True),
    "kataManager": ("tpu-kata-manager-daemonset", "COMPONENT_KATA_MANAGER", True),
}
# the port's constant for each reference constant whose name differs
PORT_CONSTS = {"COMPONENT_LIBTPU": "COMPONENT_DRIVER", "LIBTPU_REPO_CONFIG_DIR": "DRIVER_REPO_CONFIG_DIR",
               "LIBTPU_CERT_CONFIG_DIR": "DRIVER_CERT_CONFIG_DIR"}

# a reference name -> the port's (anything not listed is the same on both)
NAMES = {
    **VALUE_RENAMES,
    **consts.OPERAND_APPS,
    **convert.INIT_CONTAINERS,
    **ENV_VAR_RENAMES,
    "google.com/tpu": consts.GPU_RESOURCE,
    "libtpu-ctr": "driver-ctr",
    "libtpu-repo-config": "driver-repo-config",
    "libtpu-cert-config": "driver-cert-config",
    "tpu-operator-trusted-ca": "gpu-operator-trusted-ca",
    "TRUSTED_CA_BUNDLE": "SSL_CERT_FILE",
    "JAX_WORKLOAD_IMAGE": "CUDA_WORKLOAD_IMAGE",
    "JAX_WORKLOAD_PULL_POLICY": "CUDA_WORKLOAD_PULL_POLICY",
    "JAX_WORKLOAD_PULL_SECRETS": "CUDA_WORKLOAD_PULL_SECRETS",
    "tpu-validator": "gpu-validator",
}


def port_text(text):
    """A reference string in the port's names: every ``NAMES`` key in it
    replaced, longest first, where it stands as a whole word."""
    import re

    for old in sorted(NAMES, key=len, reverse=True):
        text = re.sub(rf"(?<![\w-]){re.escape(old)}(?![\w-])", NAMES[old], text)
    return text


def _ref_node(name, vm_node):
    extra = {ref_consts.WORKLOAD_CONFIG_LABEL: ref_consts.WORKLOAD_VM_PASSTHROUGH} if vm_node else None
    return make_tpu_node(name, extra_labels=extra)


def _port_node(name, vm_node):
    extra = {consts.WORKLOAD_CONFIG_LABEL: consts.WORKLOAD_VM_PASSTHROUGH} if vm_node else None
    return make_gpu_node(name, extra_labels=extra)


SIDES = {
    "reference": SimpleNamespace(
        name="reference", client=RefFakeClient, node=_ref_node, cpc=ref_cpc, consts=ref_consts,
        assets=os.path.join(REPO, "assets"), cr=lambda cr: cr, n=lambda name: name, port=port_text,
        const=lambda name: getattr(ref_consts, name), workload_pod=ref_wp.jax_workload_pod),
    "port": SimpleNamespace(
        name="port", client=FakeClient, node=_port_node, cpc=cpc, consts=consts,
        assets=os.path.join(REPO, "tpu_operator_torch", "assets"), cr=convert.clusterpolicy_from_reference,
        n=port_text, port=lambda name: name, const=lambda name: getattr(consts, PORT_CONSTS.get(name, name)),
        workload_pod=wp.cuda_workload_pod),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)


def both(script, *args):
    """``script(side, *args)`` on each package; the outcomes (in the port's
    names) must agree. Returns the port's."""
    out = {name: script(side, *args) for name, side in SIDES.items()}
    assert out["reference"] == out["port"], out
    return out["port"]


def load_cr():
    with open(os.path.join(REPO, "config", "samples", "v1_clusterpolicy.yaml")) as f:
        cr = yaml.safe_load(f)
    cr["metadata"]["uid"] = "uid-cp"
    return cr


def reconcile_with(side, cr, vm_node=False):
    client = side.client()
    client.create(side.cr(cr))
    client.create(side.node("n1", vm_node))
    side.cpc.ClusterPolicyReconciler(client, assets_dir=side.assets).reconcile()
    return client


def get_ds(side, client, ref_name):
    name = side.n(ref_name)
    for ds in client.list("apps/v1", "DaemonSet", NS):
        if ds["metadata"]["name"].startswith(name):
            return ds
    raise AssertionError(f"{name} not found in {[d['metadata']['name'] for d in client.list('apps/v1', 'DaemonSet', NS)]}")


def containers(ds):
    return ds["spec"]["template"]["spec"]["containers"]


def env_of(c):
    return {e["name"]: e.get("value") for e in c.get("env", [])}


@pytest.mark.parametrize("spec_key", sorted(OPERANDS))
def test_daemonset_common(spec_key):
    """Image resolution, pull policy and secrets, the env merge, the
    tolerations, the priority class and the deploy-label nodeSelector, per
    operand, from each side's own asset."""
    ds_name, component, sandbox = OPERANDS[spec_key]

    def script(side):
        cr = load_cr()
        sub = cr["spec"].setdefault(spec_key, {})
        sub.update({"repository": "registry.example/custom", "version": "9.9.9", "imagePullPolicy": "Always",
                    "imagePullSecrets": ["pull-secret-a"], "env": [{"name": "EXTRA_ENV", "value": "extra-value"}]})
        sub["enabled"] = True
        if sandbox:
            cr["spec"]["sandboxWorkloads"]["enabled"] = True
        client = reconcile_with(side, cr, vm_node=sandbox)
        ds = get_ds(side, client, ds_name)
        pod_spec = ds["spec"]["template"]["spec"]
        mains = [c for c in containers(ds) if c["image"].startswith("registry.example/custom/")]
        return {
            "custom mains": len(mains),
            "tags": sorted({c["image"].rsplit(":", 1)[-1] for c in mains}),
            "pull": sorted({c["imagePullPolicy"] for c in mains}),
            "secret": {"name": "pull-secret-a"} in pod_spec.get("imagePullSecrets", []),
            "extra env": "EXTRA_ENV" in [e["name"] for c in containers(ds) for e in c.get("env", [])],
            "priority": pod_spec["priorityClassName"],
            "tolerates the card": side.n("google.com/tpu") in [t.get("key") for t in pod_spec.get("tolerations", [])],
            "deploy selector": (pod_spec.get("nodeSelector") or {}).get(
                side.consts.DEPLOY_LABEL_PREFIX + side.const(component)),
            "hash": side.consts.LAST_APPLIED_HASH_ANNOTATION in ds["spec"]["template"]["metadata"].get(
                "annotations", {}),
        }

    out = both(script)
    assert out["custom mains"] >= 1
    assert out["tags"] == ["9.9.9"] and out["pull"] == ["Always"]
    assert out["secret"] and out["extra env"] and out["tolerates the card"] and out["hash"]
    assert out["priority"] == "system-node-critical"
    assert out["deploy selector"] == "true"


def test_image_digest_pinning():
    """sha256 versions render with '@'."""

    def script(side):
        cr = load_cr()
        cr["spec"]["devicePlugin"]["version"] = "sha256:" + "0123456789abcdef" * 4
        ds = get_ds(side, reconcile_with(side, cr), "tpu-device-plugin-daemonset")
        return [side.port(c["image"].split("/")[-1]) for c in containers(ds)]

    images = both(script)
    assert any("@sha256:" in i for i in images), images


def test_image_env_fallback(monkeypatch):
    """Empty repository/version falls back to the per-component environment
    variable (``TPU_DEVICE_PLUGIN_IMAGE``, the port's
    ``GPU_DEVICE_PLUGIN_IMAGE``)."""

    def script(side):
        cr = load_cr()
        cr["spec"]["devicePlugin"].pop("repository")
        cr["spec"]["devicePlugin"].pop("version")
        with monkeypatch.context() as m:
            m.setenv(side.n("TPU_DEVICE_PLUGIN_IMAGE"), "env-registry/env-plugin:7.7.7")
            ds = get_ds(side, reconcile_with(side, cr), "tpu-device-plugin-daemonset")
        return [c["image"] for c in containers(ds)]

    assert "env-registry/env-plugin:7.7.7" in both(script)


def test_validator_init_containers_use_validator_image():
    """Operand validation initContainers resolve to the validator image."""

    def script(side):
        cr = load_cr()
        cr["spec"]["validator"].update({"repository": "registry.example/val", "version": "3.3.3"})
        ds = get_ds(side, reconcile_with(side, cr), "tpu-device-plugin-daemonset")
        inits = ds["spec"]["template"]["spec"].get("initContainers", [])
        return [(side.port(c["name"]), side.port(c["image"])) for c in inits if "validation" in c["name"]]

    val_inits = both(script)
    assert val_inits
    for _, image in val_inits:
        assert image == "registry.example/val/gpu-operator-validator:3.3.3"


def test_proxy_and_trusted_ca_injection():
    """The cluster-wide proxy env and the trusted-CA bundle reach every
    driver container, and no other operand's."""

    def script(side):
        cr = load_cr()
        cr["spec"].setdefault("operator", {})["proxy"] = {
            "httpsProxy": "https://proxy.corp:3128", "noProxy": "10.0.0.0/8,.googleapis.com",
            "trustedCaConfigMap": "corp-ca-bundle"}
        client = reconcile_with(side, cr)
        ds = get_ds(side, client, "tpu-libtpu-daemonset")
        pod_spec = ds["spec"]["template"]["spec"]
        ca = side.n("tpu-operator-trusted-ca")
        rows = []
        for c in pod_spec.get("initContainers", []) + pod_spec["containers"]:
            env = env_of(c)
            mounts = {m["name"]: m["mountPath"] for m in c.get("volumeMounts", [])}
            rows.append((side.port(c["name"]), env.get("HTTPS_PROXY"), env.get("https_proxy"), env.get("NO_PROXY"),
                         "HTTP_PROXY" in env, mounts.get(ca) == side.consts.TRUSTED_CA_MOUNT_DIR,
                         (env.get(side.n("TRUSTED_CA_BUNDLE")) or "").endswith("ca-bundle.crt")))
        vols = {v["name"]: v for v in pod_spec.get("volumes", [])}
        plugin = get_ds(side, client, "tpu-device-plugin-daemonset")
        plugin_env = [e["name"] for c in containers(plugin) for e in c.get("env", [])]
        return rows, vols[ca]["configMap"]["name"], "HTTPS_PROXY" in plugin_env

    rows, ca_map, plugin_proxy = both(script)
    assert rows
    for _, https, https_lower, no_proxy, http_set, ca_mounted, bundle in rows:
        assert https == https_lower == "https://proxy.corp:3128"
        assert no_proxy == "10.0.0.0/8,.googleapis.com"
        assert not http_set and ca_mounted and bundle
    assert ca_map == "corp-ca-bundle"
    assert not plugin_proxy


def test_libtpu_repo_and_cert_config_mounts():
    """The custom artifact-source and CA-cert ConfigMaps mount into the
    driver's installer container."""

    def script(side):
        cr = load_cr()
        cr["spec"]["libtpu"]["repoConfig"] = {"configMapName": "libtpu-mirror"}
        cr["spec"]["libtpu"]["certConfig"] = {"name": "libtpu-certs"}
        ds = get_ds(side, reconcile_with(side, cr), "tpu-libtpu-daemonset")
        main = next(c for c in containers(ds) if c["name"] == side.n("libtpu-ctr"))
        mounts = {side.port(m["name"]): m["mountPath"] for m in main.get("volumeMounts", [])}
        vols = {side.port(v["name"]): v["configMap"]["name"]
                for v in ds["spec"]["template"]["spec"]["volumes"] if "configMap" in v}
        return {
            "repo mount": mounts["driver-repo-config"] == side.const("LIBTPU_REPO_CONFIG_DIR"),
            "cert mount": mounts["driver-cert-config"] == side.const("LIBTPU_CERT_CONFIG_DIR"),
            "repo map": vols["driver-repo-config"],
            "cert map": vols["driver-cert-config"],
        }

    out = both(script)
    assert out == {"repo mount": True, "cert mount": True, "repo map": "libtpu-mirror", "cert map": "libtpu-certs"}


def _validator_inits(side, cr):
    ds = get_ds(side, reconcile_with(side, cr), "tpu-operator-validator")
    return ds["spec"]["template"]["spec"]["initContainers"]


def test_membw_validation_opt_in():
    """``validator.membw.enabled`` appends the bandwidth initContainer right
    after the CUDA check; off by default."""

    def script(side):
        off = [side.port(c["name"]) for c in _validator_inits(side, load_cr())]
        cr = load_cr()
        cr["spec"]["validator"]["membw"] = {"enabled": True,
                                            "env": [{"name": "MEMBW_MIN_UTILIZATION", "value": "0.4"}]}
        inits = _validator_inits(side, cr)
        names = [side.port(c["name"]) for c in inits]
        membw = inits[names.index("membw-validation")]
        return off, names, [side.port(a) for a in membw["args"]], env_of(membw).get("MEMBW_MIN_UTILIZATION")

    off, names, args, util = both(script)
    assert "membw-validation" not in off
    assert names.index("membw-validation") == names.index("cuda-validation") + 1
    assert args == ["gpu-validator --component membw"]
    assert util == "0.4"


def test_libtpu_manager_drain_env_injected():
    """``upgradePolicy.drain`` lands on the driver-manager initContainer as
    the driver manager's env set."""

    def script(side):
        cr = load_cr()
        cr["spec"].setdefault("libtpu", {})["upgradePolicy"] = {
            "autoUpgrade": True,
            "drain": {"enable": True, "force": True, "podSelector": "drain=me", "timeoutSeconds": 120}}
        ds = get_ds(side, reconcile_with(side, cr), "tpu-libtpu-daemonset")
        mgr = next(c for c in ds["spec"]["template"]["spec"]["initContainers"]
                   if c["name"] == side.n("libtpu-manager"))
        env = env_of(mgr)
        return {k: env.get(k) for k in ("ENABLE_AUTO_DRAIN", "DRAIN_USE_FORCE", "DRAIN_POD_SELECTOR_LABEL",
                                        "DRAIN_TIMEOUT_SECONDS")}

    assert both(script) == {"ENABLE_AUTO_DRAIN": "true", "DRAIN_USE_FORCE": "true",
                            "DRAIN_POD_SELECTOR_LABEL": "drain=me", "DRAIN_TIMEOUT_SECONDS": "120"}


def test_workload_pod_image_env_injected():
    """The CUDA and plugin checks carry the validator image and its pull
    credentials for the workload pods they spawn; the driver check does
    not."""

    def script(side):
        cr = load_cr()
        cr["spec"]["validator"] = {"repository": "registry.example/v", "version": "1.2.3",
                                   "imagePullPolicy": "Always", "imagePullSecrets": ["sec-a", "sec-b"]}
        inits = {side.port(c["name"]): c for c in _validator_inits(side, cr)}
        out = {}
        for name in ("cuda-validation", "plugin-validation"):
            out[name] = {side.port(k): side.port(v) for k, v in env_of(inits[name]).items()
                         if side.port(k).startswith("CUDA_WORKLOAD_")}
        out["driver-validation"] = side.n("JAX_WORKLOAD_IMAGE") in env_of(inits["driver-validation"])
        return out

    out = both(script)
    for name in ("cuda-validation", "plugin-validation"):
        assert out[name] == {"CUDA_WORKLOAD_IMAGE": "registry.example/v/gpu-operator-validator:1.2.3",
                             "CUDA_WORKLOAD_PULL_POLICY": "Always", "CUDA_WORKLOAD_PULL_SECRETS": "sec-a,sec-b"}
    assert out["driver-validation"] is False


def test_workload_pod_spec_honors_pull_env(monkeypatch):
    """The workload pod takes its image, pull policy and secrets from the
    variables the validator DaemonSet sets."""

    def script(side):
        with monkeypatch.context() as m:
            m.setenv(side.n("JAX_WORKLOAD_IMAGE"), "r.example/v:9")
            m.setenv(side.n("JAX_WORKLOAD_PULL_POLICY"), "Always")
            m.setenv(side.n("JAX_WORKLOAD_PULL_SECRETS"), "s1,s2")
            pod = side.workload_pod("node-a", "ns1")
        ctr = pod["spec"]["containers"][0]
        return ctr["image"], ctr["imagePullPolicy"], pod["spec"]["imagePullSecrets"]

    assert both(script) == ("r.example/v:9", "Always", [{"name": "s1"}, {"name": "s2"}])


def test_daemonsets_labels_cannot_override_selector_keys():
    """``daemonsets.labels`` must not override ``app`` or
    ``app.kubernetes.io/part-of``: a DaemonSet's pod selector is immutable
    and an override would orphan its pods (the port's guard:
    ``controllers/object_controls.py``, ``_apply_common_daemonset_config``)."""

    def script(side):
        cr = load_cr()
        cr["spec"]["daemonsets"] = {"labels": {"app": "evil", "team": "ml", "app.kubernetes.io/part-of": "x"}}
        ds = get_ds(side, reconcile_with(side, cr), "tpu-device-plugin-daemonset")
        labels = ds["spec"]["template"]["metadata"]["labels"]
        return labels["team"], side.port(labels["app"]), side.port(labels.get("app.kubernetes.io/part-of", ""))

    team, app, part_of = both(script)
    assert team == "ml"
    assert app == "gpu-device-plugin-daemonset" and app != "evil"
    assert part_of != "x"


DIAGNOSTICS = ("membw", "ringattn", "ici", "pipeline", "moe", "flashattn")


def test_ringattn_validation_opt_in():
    """``validator.ringattn.enabled`` appends the context-parallel probe;
    off by default; the order CUDA → membw → ringattn → ici → pipeline →
    moe → flashattn when all are on."""

    def script(side):
        off = [side.port(c["name"]) for c in _validator_inits(side, load_cr())]
        cr = load_cr()
        v = cr["spec"]["validator"]
        v["membw"] = {"enabled": True}
        v["ringattn"] = {"enabled": True, "env": [{"name": "RINGATTN_SEQ_LEN", "value": "4096"}]}
        for comp in ("ici", "pipeline", "moe", "flashattn"):
            v[comp] = {"enabled": True}
        inits = _validator_inits(side, cr)
        names = [side.port(c["name"]) for c in inits]
        args = {n: [side.port(a) for a in c["args"]] for n, c in zip(names, inits)
                if n.split("-")[0] in DIAGNOSTICS}
        return off, names, args, env_of(inits[names.index("ringattn-validation")]).get("RINGATTN_SEQ_LEN")

    off, names, args, seq = both(script)
    assert "ringattn-validation" not in off
    i = names.index("cuda-validation")
    assert names[i + 1:i + 7] == [f"{c}-validation" for c in DIAGNOSTICS]
    assert sorted(args) == sorted(f"{c}-validation" for c in DIAGNOSTICS)
    for comp in DIAGNOSTICS:
        assert args[f"{comp}-validation"] == [f"gpu-validator --component {comp}"]
    assert seq == "4096"
