"""The port's object controls (``controllers/object_controls.py``) against
the JAX package's: each operand's ``transform_*`` on its own asset, the
validator's optional diagnostics, and every environment variable a
transform sets, checked as one the port's operand reads.

Both sides render their own asset DaemonSet (``assets/<state>/`` and
``tpu_operator_torch/assets/<state>/``) under one ClusterPolicy that turns
every transform's options on (``RICH``, given to the port through
``convert.clusterpolicy_from_reference``). The rendered DaemonSets must
agree, container by container, on the container layout (names paired by
the two assets, position by position), image tags and pull policies, args,
resources, probes, volumes (the driver's and the proxy's mounts renamed,
``VOLUMES``), tolerations (``google.com/tpu`` as ``nvidia.com/gpu``),
update strategy, priority class and pull secrets; and on the environment
each transform sets, name for name through ``ENV``, the table of what the
port sets for each of the reference's variables (``None``: not set, because
no operand of the port reads it; the module docstring of
``object_controls`` says why) plus ``PORT_ONLY``. Tolerance: exact
equality apart from those renames.
"""

import copy
import json
import os
import re
from types import SimpleNamespace

import pytest
import yaml

from tpu_operator.api.v1.clusterpolicy_types import clusterpolicy_from_obj as ref_decode
from tpu_operator.controllers import object_controls as ref_oc
from tpu_operator_torch import consts, convert
from tpu_operator_torch.api.v1.clusterpolicy_types import clusterpolicy_from_obj
from tpu_operator_torch.controllers import object_controls as oc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tpu_operator_torch")
NS = "tpu-operator"

# reference app -> (state directory, the port's operand sources that read its env)
OPERANDS = {
    "tpu-libtpu-daemonset": ("state-libtpu", ["operands/driver_installer.py", "operands/driver_manager.py"]),
    "tpu-runtime-daemonset": ("state-runtime", ["operands/runtime_wire.py"]),
    "tpu-device-plugin-daemonset": ("state-device-plugin", ["plugin/server.py"]),
    "tpu-operator-validator": ("state-operator-validation", ["validator/main.py", "validator/workload_pods.py"]),
    "tpu-metricsd": ("state-metricsd", ["metricsd/daemon.py"]),
    "tpu-metrics-exporter": ("state-metrics-exporter", ["exporter/exporter.py"]),
    "tpu-node-status-exporter": ("state-node-status-exporter", ["validator/main.py"]),
    "tpu-feature-discovery": ("tpu-feature-discovery", ["discovery/tfd.py"]),
    "tpu-slice-manager": ("state-slice-manager", ["sliceman/slice_manager.py"]),
    # no port of the handler yet: its variables are the reference operand's
    "tpu-maintenance-handler": ("state-maintenance-handler", ["../tpu_operator/operands/maintenance.py"]),
    "tpu-vm-manager-daemonset": ("state-vm-manager", ["operands/vm_manager.py"]),
    "tpu-vm-device-manager": ("state-vm-device-manager", ["operands/vm_manager.py"]),
    "tpu-sandbox-validator": ("state-sandbox-validation", ["validator/main.py"]),
    "tpu-vfio-manager-daemonset": ("state-vfio-manager", ["operands/vfio_manager.py"]),
    "tpu-sandbox-device-plugin-daemonset": ("state-sandbox-device-plugin", ["plugin/manager.py"]),
    "tpu-kata-manager-daemonset": ("state-kata-manager", ["operands/vm_manager.py"]),
}

# the reference's variables a transform sets -> the port's (None: not set)
ENV = {
    "LIBTPU_INSTALL_DIR": "DRIVER_ROOT",
    "RUNTIME_INSTALL_DIR": None,
    "CONTAINER_RUNTIME": "CONTAINERD_CONF_DIR",
    "CDI_ENABLED": "CDI_ENABLED",
    "CDI_DEFAULT": None,
    "TPU_RESOURCE": None,
    "CONFIG_FILE_DIR": None,
    "DEFAULT_CONFIG": None,
    "DIRECT_STORAGE_ENABLED": None,
    "JAX_WORKLOAD_IMAGE": "CUDA_WORKLOAD_IMAGE",
    "JAX_WORKLOAD_PULL_POLICY": "CUDA_WORKLOAD_PULL_POLICY",
    "JAX_WORKLOAD_PULL_SECRETS": "CUDA_WORKLOAD_PULL_SECRETS",
    "WITH_REBOOT": None,
    "DEFAULT_SLICE_CONFIG": None,
    "SLICE_STRATEGY": "SLICE_STRATEGY",
    "TRUSTED_CA_BUNDLE": "SSL_CERT_FILE",
}
# (reference app, container) -> variables only the port sets
PORT_ONLY = {
    ("tpu-runtime-daemonset", "gpu-toolkit-ctr"): {"DRIVER_ROOT", "CDI_SPEC_PATH"},
    ("tpu-device-plugin-daemonset", "gpu-device-plugin"): {"DRIVER_ROOT"},
    ("tpu-metrics-exporter", "gpu-metrics-exporter"): {"METRICS_CONFIG_FILE"},
}
# per transform, the reference's variables the port does not set on that operand
DROPPED_HERE = {("tpu-feature-discovery", "SLICE_STRATEGY"), ("tpu-runtime-daemonset", "CDI_ENABLED")}
VOLUMES = {"libtpu-install-dir": "driver-install-dir", "libtpu-repo-config": "driver-repo-config",
           "libtpu-cert-config": "driver-cert-config", "tpu-operator-trusted-ca": "gpu-operator-trusted-ca"}
CONFIG_MAPS = {"tpu-runtime-entrypoint": "gpu-toolkit-entrypoint"}
# read by libraries, not by the operand's own code
LIBRARY_ENV = {"HTTPS_PROXY", "HTTP_PROXY", "NO_PROXY", "https_proxy", "http_proxy", "no_proxy", "SSL_CERT_FILE"}
USER_ENV = {"USER_SET", "COMPONENT_SET"}

RICH = {
    "operator": {"proxy": {"httpsProxy": "http://proxy:3128", "httpProxy": "http://proxy:3128",
                           "noProxy": "10.0.0.0/8", "trustedCaConfigMap": "ca-cm"}},
    "daemonsets": {"tolerations": [{"key": "dedicated", "operator": "Exists", "effect": "NoSchedule"}],
                   "labels": {"team": "ml"}},
    "libtpu": {"env": [{"name": "USER_SET", "value": "1"}], "args": ["--verbose"],
               "resources": {"limits": {"memory": "1Gi"}}, "repoConfig": {"configMapName": "repo-cm"},
               "certConfig": {"name": "cert-cm"}, "startupProbe": {"failureThreshold": 120},
               "upgradePolicy": {"autoUpgrade": True, "drain": {"enable": True, "force": True,
                                                                "podSelector": "app=train", "timeoutSeconds": 120}}},
    "runtime": {"env": [{"name": "USER_SET", "value": "1"}]},
    "devicePlugin": {"env": [{"name": "USER_SET", "value": "1"}], "args": ["--fail-on-init-error"],
                     "config": {"name": "plugin-cm", "default": "any"}},
    "directStorage": {"enabled": True},
    "metricsd": {"hostPort": 5556, "sampleOnChip": True},
    "metricsExporter": {"metricsConfig": {"name": "metrics-cm"}},
    "sliceManager": {"config": {"name": "slice-cm", "default": "all-1x1"}, "chipClientsConfig": {"name": "cc"}},
    "maintenanceHandler": {"enabled": True, "pollIntervalSeconds": 5, "forceEvict": True, "evictWorkloads": False},
    "vmDeviceManager": {"config": {"name": "vmd-cm", "default": "default"}},
    "sandboxDevicePlugin": {"args": ["--verbose"]},
    "validator": {"imagePullSecrets": ["pull-secret"], "env": [{"name": "USER_SET", "value": "1"}],
                  "plugin": {"env": [{"name": "COMPONENT_SET", "value": "p"}]},
                  "jax": {"env": [{"name": "COMPONENT_SET", "value": "j"}]},
                  "membw": {"enabled": True}, "flashattn": {"enabled": True}, "ici": {"enabled": True}},
}


def _merge(base, extra):
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)


def ref_cr(extra=RICH):
    with open(os.path.join(REPO, "config", "samples", "v1_clusterpolicy.yaml")) as f:
        cr = yaml.safe_load(f)
    cr["metadata"]["uid"] = "uid-1"
    _merge(cr["spec"], extra)
    return cr


def ctrl(port: bool, extra=RICH):
    cr = ref_cr(extra)
    if port:
        cr = convert.clusterpolicy_from_reference(cr)
    decode = clusterpolicy_from_obj if port else ref_decode
    return SimpleNamespace(cp=decode(cr), cp_obj=cr, namespace=NS, runtime="containerd", openshift=False)


def asset_ds(port: bool, state: str):
    root = PORT if port else REPO
    with open(os.path.join(root, "assets", state, "0500_daemonset.yaml" if state != "state-metricsd"
                           else "0400_daemonset.yaml")) as f:
        return yaml.safe_load(f)


def render(port: bool, ref_app: str, extra=RICH):
    state = OPERANDS[ref_app][0]
    mod = oc if port else ref_oc
    asset = asset_ds(port, state)
    return asset, mod._render_daemonset(ctrl(port, extra), asset)


def containers(ds):
    spec = ds["spec"]["template"]["spec"]
    return [("init", c) for c in spec.get("initContainers", [])] + [("main", c) for c in spec.get("containers", [])]


def container_names(ref_app):
    """The reference's container names -> the port's, paired by the two
    assets position by position, plus the containers transforms add."""
    state = OPERANDS[ref_app][0]
    names = {a["name"]: b["name"] for (_, a), (_, b) in zip(containers(asset_ds(False, state)),
                                                            containers(asset_ds(True, state)))}
    names["tpu-metricsd-sampler"] = "gpu-metricsd-sampler"
    return names


def set_env(asset, ds):
    """{container name: {variable: value}} the transform set (the rendered
    env minus the asset's own; a diagnostic cloned from the CUDA check
    starts from that check's env)."""
    before = {c["name"]: {e["name"]: e.get("value", e.get("valueFrom")) for e in c.get("env", [])}
              for _, c in containers(asset)}
    base = before.get("cuda-validation", before.get("jax-validation", {}))
    out = {}
    for _, c in containers(ds):
        had = before.get(c["name"], base if c["name"].endswith("-validation") else {})
        out[c["name"]] = {e["name"]: e.get("value") for e in c.get("env", [])
                          if had.get(e["name"]) != e.get("value", e.get("valueFrom"))}
    return out


def shape(ds, names, tolerations, text=lambda s: s):
    out = []
    for where, c in containers(ds):
        out.append((where, names.get(c["name"], c["name"]), c.get("image", "").rsplit(":", 1)[-1],
                    c.get("imagePullPolicy"), c.get("resources"), text(json.dumps(c.get("startupProbe"))),
                    sorted(VOLUMES.get(m["name"], m["name"]) for m in c.get("volumeMounts", []))))
    spec = ds["spec"]["template"]["spec"]
    vols = sorted((VOLUMES.get(v["name"], v["name"]),
                   CONFIG_MAPS.get((v.get("configMap") or {}).get("name"), (v.get("configMap") or {}).get("name")))
                  for v in spec.get("volumes", []))
    return (out, vols, tolerations(spec.get("tolerations")), ds["spec"].get("updateStrategy"),
            spec.get("priorityClassName"), spec.get("imagePullSecrets"))


def _ref_text(text):
    """A reference shell command as the port words it: the status files and
    the driver's smoke program."""
    return convert._status_files(text, True).replace("tpu-smoke", "gpu_smoke")


def _ref_tolerations(tols):
    return convert.clusterpolicy_from_reference({"t": tols})["t"]


def test_every_transform_is_registered_under_the_port_app():
    assert set(oc.TRANSFORMS) == {consts.OPERAND_APPS[app] for app in ref_oc.TRANSFORMS}
    assert set(ref_oc.TRANSFORMS) == set(OPERANDS)
    assert set(oc.CONTROLS) == set(ref_oc.CONTROLS)


@pytest.mark.parametrize("ref_app", sorted(OPERANDS))
def test_transform_on_its_asset(ref_app):
    names = container_names(ref_app)
    ref_asset, ref_ds = render(False, ref_app)
    port_asset, port_ds = render(True, ref_app)
    assert shape(port_ds, {}, lambda t: t) == shape(ref_ds, names, _ref_tolerations, _ref_text)
    assert (convert.object_from_reference(ref_ds)["spec"]["template"]["metadata"]["labels"]
            == port_ds["spec"]["template"]["metadata"]["labels"])
    ref_args = [(names.get(c["name"], c["name"]), c.get("args")) for _, c in containers(ref_ds)]
    port_args = [(c["name"], c.get("args")) for _, c in containers(port_ds)]
    word = re.compile(r"tpu-validator|--component (libtpu|runtime|jax)\b|TPU|uninstall_libtpu")
    fix = {"tpu-validator": "gpu-validator", "--component libtpu": "--component driver",
           "--component runtime": "--component toolkit", "--component jax": "--component cuda", "TPU": "GPU",
           "uninstall_libtpu": "uninstall_driver"}
    ref_args = [(n, [word.sub(lambda m: fix[m.group(0)], convert._status_files(a, True)) for a in args]
                 if args else args) for n, args in ref_args]
    assert port_args == ref_args
    # the environment, name for name through ENV
    ref_env, port_env = set_env(ref_asset, ref_ds), set_env(port_asset, port_ds)
    want = {}
    for name, env in ref_env.items():
        mapped = {ENV.get(k, k) for k in env if (ref_app, k) not in DROPPED_HERE} - {None}
        port_name = names.get(name, name)
        want[port_name] = mapped | PORT_ONLY.get((ref_app, port_name), set())
    got = {name: set(env) for name, env in port_env.items()}
    if ref_app == "tpu-runtime-daemonset":
        # the asset already names the port's variables; the transform sets them again
        got["gpu-toolkit-ctr"] |= {"DRIVER_ROOT", "CDI_SPEC_PATH"}
    assert got == want


def _reads(ref_app):
    text = ""
    for rel in OPERANDS[ref_app][1]:
        with open(os.path.normpath(os.path.join(PORT, rel))) as f:
            text += f.read()
    return text


@pytest.mark.parametrize("ref_app", sorted(OPERANDS))
def test_transform_env_is_read_by_its_operand(ref_app):
    """Every variable a transform sets is one its operand reads (by name,
    in its source), a library's (the proxy and OpenSSL's CA bundle) or the
    CR's own user env."""
    port_asset, port_ds = render(True, ref_app)
    source = _reads(ref_app)
    for name, env in set_env(port_asset, port_ds).items():
        for var in env:
            if var in LIBRARY_ENV or var in USER_ENV:
                continue
            assert f'"{var}"' in source or f"'{var}'" in source, (ref_app, name, var)


def test_transform_values_the_operands_read():
    """The port's values where the reference's carry a TPU path or name."""
    env = {c["name"]: {e["name"]: e.get("value") for e in c.get("env", [])}
           for _, ds in (render(True, app) for app in OPERANDS) for _, c in containers(ds)}
    assert env["driver-ctr"]["DRIVER_ROOT"] == consts.DRIVER_ROOT
    assert env["driver-manager"]["DRAIN_USE_FORCE"] == "true"
    assert env["driver-manager"]["DRAIN_TIMEOUT_SECONDS"] == "120"
    assert env["gpu-toolkit-ctr"]["CONTAINERD_CONF_DIR"] == "/etc/containerd/conf.d"
    assert env["gpu-slice-manager"]["CDI_SPEC_PATH"] == consts.CDI_SPEC_PATH
    assert env["gpu-metrics-exporter"]["METRICS_CONFIG_FILE"] == "/etc/gpu-metrics/metrics.csv"
    assert env["gpu-metrics-exporter"]["METRICSD_ENDPOINT"] == "localhost:5556"
    assert env["cuda-validation"]["CUDA_WORKLOAD_PULL_SECRETS"] == "pull-secret"
    assert env["cuda-validation"]["COMPONENT_SET"] == "j" and env["plugin-validation"]["COMPONENT_SET"] == "p"
    assert env["driver-ctr"]["SSL_CERT_FILE"] == consts.TRUSTED_CA_MOUNT_DIR + "/ca-bundle.crt"


@pytest.mark.parametrize("enabled", [("membw", "flashattn", "ici"), ("moe",), ("pipeline", "ringattn", "membw")])
def test_validator_optional_diagnostics_order(enabled):
    """The diagnostics land after ``cuda-validation`` (the reference's
    ``jax-validation``) in one fixed order, whatever the CR enables, each
    running its component."""
    extra = {"validator": {name: {"enabled": True} for name in enabled}}
    _, ref_ds = render(False, "tpu-operator-validator", extra)
    _, port_ds = render(True, "tpu-operator-validator", extra)
    mapped = convert.object_from_reference(ref_ds)["spec"]["template"]["spec"]["initContainers"]
    inits = port_ds["spec"]["template"]["spec"]["initContainers"]
    assert [c["name"] for c in inits] == [c["name"] for c in mapped]
    diag = [c["name"] for c in inits][[c["name"] for c in inits].index("cuda-validation") + 1:]
    diag = [n for n in diag if n != "plugin-validation"]
    assert diag == [f"{n}-validation" for n in oc.OPTIONAL_DIAGNOSTICS if n in enabled]
    assert all(c["args"] == [f"gpu-validator --component {c['name'][:-len('-validation')]}"]
               for c in inits if c["name"] in diag)


def test_driver_variant_daemonset_renders_the_variant():
    """The per-variant driver DaemonSet: its name, app, selector and node
    selector, and the variant's version, as the reference's per-generation
    one through ``convert`` (``v5e`` as ``h100-sxm``)."""
    extra = dict(RICH, libtpu=dict(RICH["libtpu"], generationConfigs={"v5e": "2025.1.0-v5e"}))
    port_extra = dict(RICH, libtpu=dict(RICH["libtpu"], generationConfigs={"h100-sxm": "2025.1.0-v5e"}))
    ref = ref_oc._render_generation_daemonset(ctrl(False, extra), asset_ds(False, "state-libtpu"), "v5e")
    port = oc._render_variant_daemonset(ctrl(True, port_extra), asset_ds(True, "state-libtpu"), "h100-sxm")
    mapped = convert.object_from_reference(ref, {"v5e": "h100-sxm"})
    for path in (("metadata", "name"), ("metadata", "labels"), ("spec", "selector")):
        a, b = mapped, port
        for p in path:
            a, b = a[p], b[p]
        assert a == b, path
    assert mapped["spec"]["template"]["spec"]["nodeSelector"] == port["spec"]["template"]["spec"]["nodeSelector"]
    image = [c for _, c in containers(port) if c["name"] == "driver-ctr"][0]["image"]
    assert image.endswith(":2025.1.0-v5e") and port["metadata"]["name"] == "gpu-driver-daemonset-h100-sxm"
