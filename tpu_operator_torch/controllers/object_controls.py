"""Per-kind object controls and per-operand transforms.

The port's copy of ``tpu_operator/controllers/object_controls.py``. Each
control is ``fn(n, state_name, obj) -> State`` where ``n`` is the
``ClusterPolicyController``. Controls fill the operator namespace and the
owner reference, run the operand's ``transform_*`` (keyed by the asset's
``app`` label, a name of ``consts.OPERAND_APPS``), annotate a content hash
and apply only on drift (``apply_with_hash``), and report readiness. The
render memo (``_render_memo``) serves each control's frozen, pre-hashed
manifest from the render cache while the desired-state fingerprint holds.

Adaptations to the card:

* the reference's per-generation libtpu fan-out is a per-variant driver
  fan-out: with ``spec.driver.generationConfigs`` set, one
  ``gpu-driver-daemonset-<variant>`` a variant present in the cluster
  (``h100-sxm``, ``h100-pcie``, ``h100-nvl``), selecting its nodes by
  ``consts.GENERATION_LABEL``, with the same sweep of stale ones;
* each transform sets only the environment its operand in this package
  reads, under the name it reads. The driver installer, the toolkit
  wiring, the device plugin and the slice manager read ``DRIVER_ROOT``
  (the reference's ``LIBTPU_INSTALL_DIR``); the toolkit and the slice
  manager read ``CDI_SPEC_PATH`` (``consts.CDI_SPEC_PATH``); the toolkit
  reads ``CONTAINERD_CONF_DIR``, set while the runtime is containerd (the
  reference's ``CONTAINER_RUNTIME``); the exporter reads
  ``METRICS_CONFIG_FILE`` (the custom metrics ConfigMap's ``metrics.csv``)
  and the validator's workload pods ``CUDA_WORKLOAD_IMAGE``,
  ``_PULL_POLICY`` and ``_PULL_SECRETS`` (the reference's ``JAX_…``). The
  proxy's CA bundle is named by ``SSL_CERT_FILE``, which OpenSSL reads.
  Not set, because no operand here reads them: the driver's
  ``TPU_GENERATION`` (the variant is in the DaemonSet's ``nodeSelector``
  and image tag), the toolkit's ``RUNTIME_INSTALL_DIR``, ``CDI_ENABLED``
  and ``CDI_DEFAULT`` (the toolkit always writes the CDI spec), the device
  plugin's ``TPU_RESOURCE`` (it advertises ``nvidia.com/gpu``),
  ``DIRECT_STORAGE_ENABLED`` and its custom config's directory (the config
  is still mounted at ``/config``), feature discovery's ``SLICE_STRATEGY``
  and the slice manager's ``WITH_REBOOT`` and ``DEFAULT_SLICE_CONFIG``.
  The maintenance handler's ``POLL_INTERVAL_S``, ``FORCE_EVICT`` and
  ``EVICT_WORKLOADS`` are the reference's operand's, which this package
  has not ported yet;
* the validator's init containers are ``driver-``, ``toolkit-``,
  ``plugin-`` and ``cuda-validation``, and its optional diagnostics are
  cloned from ``cuda-validation`` and run ``gpu-validator --component X``.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
from time import perf_counter
from typing import Any, Callable, Dict, List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.api.v1.clusterpolicy_types import State
from tpu_operator_torch.kube.frozen import freeze
from tpu_operator_torch.obs import trace
from tpu_operator_torch.obs.logonce import LogOnce

log = logging.getLogger("gpu-operator.controls")

Obj = Dict[str, Any]

PLACEHOLDER = "FILLED BY THE OPERATOR"
DEFAULT_RUNTIME_CLASS = "nvidia"  # the asset's RuntimeClass that spec.operator.runtimeClass renames
CONTAINERD_CONF_DIR = "/etc/containerd/conf.d"
METRICS_CONFIG_DIR = "/etc/gpu-metrics"
METRICS_CONFIG_KEY = "metrics.csv"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def compute_hash(obj: Obj) -> str:
    """Deterministic content hash of an object's labels, annotations
    (without the hash annotation itself), spec, data, rules and handler.
    Transforms must be deterministic or the hash churns."""
    meta = obj.get("metadata", {})
    core = {
        "labels": meta.get("labels", {}),
        "annotations": {
            k: v
            for k, v in (meta.get("annotations", {}) or {}).items()
            if k != consts.LAST_APPLIED_HASH_ANNOTATION
        },
        "spec": obj.get("spec", {}),
        "data": obj.get("data", {}),
        "rules": obj.get("rules", []),
        "handler": obj.get("handler", ""),
    }
    blob = json.dumps(core, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def set_owner_reference(n, obj: Obj) -> None:
    """Owner the object to the ClusterPolicy so cluster GC cleans up."""
    meta = n.cp_obj.get("metadata", {})
    uid = meta.get("uid")
    if not uid:
        return
    obj.setdefault("metadata", {})["ownerReferences"] = [
        {
            "apiVersion": consts.API_VERSION,
            "kind": consts.CLUSTER_POLICY_KIND,
            "name": meta.get("name", ""),
            "uid": uid,
            "controller": True,
            "blockOwnerDeletion": True,
        }
    ]


_CLUSTER_SCOPED = ("ClusterRole", "ClusterRoleBinding", "RuntimeClass", "PriorityClass", "PodSecurityPolicy")


def _fill_namespace(n, obj: Obj) -> None:
    meta = obj.setdefault("metadata", {})
    if meta.get("namespace") == PLACEHOLDER or ("namespace" in meta and not meta["namespace"]):
        meta["namespace"] = n.namespace
    if obj.get("kind") in _CLUSTER_SCOPED:
        meta.pop("namespace", None)
    for subject in obj.get("subjects", []) or []:
        if subject.get("namespace") == PLACEHOLDER or not subject.get("namespace"):
            if subject.get("kind") == "ServiceAccount":
                subject["namespace"] = n.namespace


def apply_with_hash(n, obj: Obj, precomputed_hash: Optional[str] = None) -> str:
    """Hash-gated server-side apply; returns the hash.

    At steady state it costs no request: the stored object's hash
    annotation matches and nothing is sent. Drift or absence costs one
    forced, pruning apply. With ``precomputed_hash`` (the render-cache
    path) ``obj`` is a pre-annotated, possibly frozen manifest and is never
    mutated here. Every intended object registers in the pass's apply-set
    (``n.applyset``), on the no-op branch too, so a later pass that stops
    intending it prunes it."""
    if precomputed_hash is None:
        h = compute_hash(obj)
        obj.setdefault("metadata", {}).setdefault("annotations", {})[consts.LAST_APPLIED_HASH_ANNOTATION] = h
    else:
        h = precomputed_hash
    av, kind = obj["apiVersion"], obj["kind"]
    meta = obj["metadata"]
    aps = getattr(n, "applyset", None)
    if aps is not None:
        aps.seen(av, kind, meta.get("namespace", ""), meta["name"])
    existing = n.client.get_or_none(av, kind, meta["name"], meta.get("namespace", ""))
    if existing is not None:
        old_hash = (existing.get("metadata", {}).get("annotations", {}) or {}).get(
            consts.LAST_APPLIED_HASH_ANNOTATION
        )
        if old_hash == h:
            return h
    with trace.span("apply.object", kind=kind, name=meta["name"]):
        _submit_apply(n, obj)
    return h


def _submit_apply(n, obj: Obj) -> Obj:
    """One manifest apply, through the controller's apply lane when it has
    one (sibling manifests of a DAG wave group-commit), else inline."""
    lane = getattr(n, "apply_lane", None)
    if lane is not None:
        return lane.submit(
            (obj.get("kind", ""), obj["metadata"].get("namespace", ""), obj["metadata"].get("name", "")),
            obj,
        ).result()
    return n.client.apply_ssa(obj, force=True, prune=True)


def _render_memo(n, state_name: str, obj: Obj, render: Callable[[Obj], Obj], generation: Optional[str] = None):
    """Memoized render-transform-hash: ``(rendered, hash)``, where
    ``rendered`` may be a shared frozen view. A cache hit skips the copy,
    the transforms and the hash; a miss renders, hashes, annotates and
    stores the frozen result. Controllers without a ``render_cache``
    render every time."""
    cache = getattr(n, "render_cache", None)
    key = (state_name, obj.get("kind", ""), obj.get("metadata", {}).get("name", ""), generation or "")
    if cache is not None:
        hit = cache.lookup(key)
        if hit is not None:
            trace.instant("render.cache_hit", state=state_name, key=key[1:3])
            return hit
    t0 = perf_counter()
    with trace.span(
        "render.manifest", state=state_name, kind=key[1], name=key[2], cache="miss" if cache is not None else "bypass"
    ):
        rendered = render(obj)
        h = compute_hash(rendered)
    render_s = perf_counter() - t0
    rendered.setdefault("metadata", {}).setdefault("annotations", {})[consts.LAST_APPLIED_HASH_ANNOTATION] = h
    metrics = getattr(n, "metrics", None)
    if metrics is not None and getattr(metrics, "state_render_ms_hist", None):
        metrics.state_render_ms_hist.labels(state=state_name).observe(render_s * 1000.0)
    if cache is not None:
        rendered = freeze(rendered)
        cache.store(key, rendered, h, state_name, render_s, generation=generation)
    return rendered, h


def _render_generic(n, obj: Obj) -> Obj:
    obj = copy.deepcopy(obj)
    _fill_namespace(n, obj)
    set_owner_reference(n, obj)
    return obj


def _generic_apply(n, state_name: str, obj: Obj) -> str:
    rendered, h = _render_memo(n, state_name, obj, lambda o: _render_generic(n, o))
    apply_with_hash(n, rendered, precomputed_hash=h)
    return State.READY


# ---------------------------------------------------------------------------
# simple kind controls
# ---------------------------------------------------------------------------


def service_account(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def role(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def role_binding(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def cluster_role(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def cluster_role_binding(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def config_map(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def service(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def service_monitor(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def prometheus_rule(n, state_name: str, obj: Obj) -> str:
    """Alerting rules. A cluster without the prometheus-operator CRDs
    answers 404 or "no matches for kind": that alone is a graceful skip
    (after one retry, which recreates a rule deleted mid-read); any other
    failure is NotReady."""
    from tpu_operator_torch.kube.client import NotFoundError

    def _looks_absent(e: Exception) -> bool:
        return isinstance(e, NotFoundError) or (
            "could not find the requested resource" in str(e) or "no matches for kind" in str(e)
        )

    try:
        return _generic_apply(n, state_name, obj)
    except Exception as e:
        if _looks_absent(e):
            try:
                return _generic_apply(n, state_name, obj)
            except Exception as e2:
                if _looks_absent(e2):
                    log.warning(
                        "PrometheusRule %s skipped (monitoring CRDs absent): %s", obj["metadata"].get("name"), e2
                    )
                    return State.READY
                e = e2
        log.error("PrometheusRule %s apply failed: %s", obj["metadata"].get("name"), e)
        return State.NOT_READY


def runtime_class(n, state_name: str, obj: Obj) -> str:
    """RuntimeClasses; the default one (``nvidia``) is renamed to
    ``spec.operator.runtimeClass``."""

    def render(o: Obj) -> Obj:
        o = copy.deepcopy(o)
        if o["metadata"]["name"] == DEFAULT_RUNTIME_CLASS:
            o["metadata"]["name"] = n.cp.spec.operator.runtime_class
        _fill_namespace(n, o)
        set_owner_reference(n, o)
        return o

    rendered, h = _render_memo(n, state_name, obj, render)
    apply_with_hash(n, rendered, precomputed_hash=h)
    return State.READY


def priority_class(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def pod_security_policy(n, state_name: str, obj: Obj) -> str:
    """PSP only when ``spec.psp`` is enabled; else any stored one goes."""
    if not n.cp.spec.psp.is_enabled():
        n.client.delete_if_exists(obj["apiVersion"], obj["kind"], obj["metadata"]["name"])
        return State.READY
    return _generic_apply(n, state_name, obj)


def security_context_constraints(n, state_name: str, obj: Obj) -> str:
    if not n.openshift:
        return State.READY
    return _generic_apply(n, state_name, obj)


def pod(n, state_name: str, obj: Obj) -> str:
    return _generic_apply(n, state_name, obj)


def deployment(n, state_name: str, obj: Obj) -> str:
    rendered, h = _render_memo(n, state_name, obj, lambda o: _render_generic(n, o))
    apply_with_hash(n, rendered, precomputed_hash=h)
    live = n.client.get_or_none(rendered["apiVersion"], "Deployment", rendered["metadata"]["name"], n.namespace)
    return State.READY if live and is_deployment_ready(live) else State.NOT_READY


# ---------------------------------------------------------------------------
# the DaemonSet control
# ---------------------------------------------------------------------------

# operand app -> transform
TRANSFORMS: Dict[str, Callable] = {}


def _register(ref_app: str):
    """Register a transform under the port's name of the reference's
    operand app (``consts.OPERAND_APPS``)."""
    app = consts.OPERAND_APPS[ref_app]

    def deco(fn):
        TRANSFORMS[app] = fn
        return fn

    return deco


def daemonset(n, state_name: str, obj: Obj) -> str:
    """A disabled state deletes its operand; without GPU nodes there is
    nothing to do; the driver with ``generationConfigs`` fans out per
    variant; else render, apply and read readiness."""
    name = obj["metadata"]["name"]
    if not n.is_state_enabled(state_name):
        _delete_daemonsets_like(n, name)
        return State.DISABLED
    if not n.has_tpu_nodes:
        _log_no_gpu_skip(n, name)
        return State.READY
    if name == consts.DRIVER_APP and n.cp.spec.driver.generation_configs:
        return _driver_variant_daemonsets(n, state_name, obj)
    ds, h = _render_memo(n, state_name, obj, lambda o: _render_daemonset(n, o))
    apply_with_hash(n, ds, precomputed_hash=h)
    live = n.client.get_or_none("apps/v1", "DaemonSet", ds["metadata"]["name"], n.namespace)
    if live is None:
        return State.NOT_READY
    return State.READY if is_daemonset_ready(n, live) else State.NOT_READY


def _log_no_gpu_skip(n, name: str) -> None:
    """The skip is logged at INFO once per DaemonSet per no-GPU stretch
    (the controller's ``LogOnce`` is cleared when GPU nodes appear)."""
    logged = getattr(n, "no_tpu_skip_logged", None)
    if isinstance(logged, LogOnce):
        logged.log(log, name, "no GPU nodes; skipping DaemonSet %s", name)
        return
    log.info("no GPU nodes; skipping DaemonSet %s", name)


def _render_daemonset(n, obj: Obj) -> Obj:
    ds = copy.deepcopy(obj)
    _pre_process_daemonset(n, ds)
    set_owner_reference(n, ds)
    return ds


def _render_variant_daemonset(n, obj: Obj, variant: str) -> Obj:
    """The driver DaemonSet of one card variant: its own name, ``app``
    identity and selector (identical selectors across DaemonSets are
    invalid, and OnDelete readiness must see only this variant's pods),
    and a nodeSelector on the variant label."""
    base_name = obj["metadata"]["name"]
    base_app = obj["metadata"]["labels"].get("app", base_name)
    ds = copy.deepcopy(obj)
    ds["metadata"]["name"] = f"{base_name}-{variant}"
    labels = ds["metadata"].setdefault("labels", {})
    labels[consts.GENERATION_LABEL] = variant
    variant_app = f"{base_app}-{variant}"
    labels["app"] = variant_app
    ds["spec"]["selector"]["matchLabels"]["app"] = variant_app
    tmpl = ds["spec"]["template"]
    tmpl["metadata"].setdefault("labels", {})["app"] = variant_app
    tmpl["spec"].setdefault("nodeSelector", {})[consts.GENERATION_LABEL] = variant
    _pre_process_daemonset(n, ds, generation=variant, transform_key=base_app)
    set_owner_reference(n, ds)
    return ds


def _driver_variant_daemonsets(n, state_name: str, obj: Obj) -> str:
    """One driver DaemonSet per card variant present, each render memoized
    apart, then the sweep of stale variants and the un-suffixed base."""
    base_name = obj["metadata"]["name"]
    wanted = set()
    overall = State.READY
    for variant in sorted(n.tpu_generations):
        ds, h = _render_memo(
            n, state_name, obj, lambda o, v=variant: _render_variant_daemonset(n, o, v), generation=variant
        )
        apply_with_hash(n, ds, precomputed_hash=h)
        wanted.add(ds["metadata"]["name"])
        live = n.client.get_or_none("apps/v1", "DaemonSet", ds["metadata"]["name"], n.namespace)
        if live is None or not is_daemonset_ready(n, live):
            overall = State.NOT_READY
    _delete_daemonsets_like(n, base_name, keep=wanted)
    return overall


def _delete_daemonsets_like(n, base_name: str, keep: Optional[set] = None) -> None:
    """Sweep DaemonSets named ``base_name`` or ``base_name-*``, listed from
    the pass's snapshot when one is open (one LIST for every sweep of the
    pass)."""
    keep = keep or set()
    snap = getattr(n, "snapshot", None)
    daemonsets = snap.daemonsets() if snap is not None else n.client.list("apps/v1", "DaemonSet", n.namespace)
    for ds in daemonsets:
        name = ds["metadata"]["name"]
        if (name == base_name or name.startswith(base_name + "-")) and name not in keep:
            n.client.delete_if_exists("apps/v1", "DaemonSet", name, n.namespace)


def _pre_process_daemonset(n, ds: Obj, generation: Optional[str] = None, transform_key: Optional[str] = None) -> None:
    """Common config, the operand's transform, the validator image on the
    ``*-validation`` init containers, and the operand hash stamped into the
    pod template (OnDelete readiness compares running pods against it)."""
    _fill_namespace(n, ds)
    _apply_common_daemonset_config(n, ds)
    transform = TRANSFORMS.get(transform_key or ds["metadata"]["labels"].get("app"))
    if transform:
        transform(n, ds, generation=generation)
    _transform_validation_init_containers(n, ds)
    h = compute_hash(ds)
    ds["spec"]["template"]["metadata"].setdefault("annotations", {})[consts.LAST_APPLIED_HASH_ANNOTATION] = h


def _apply_common_daemonset_config(n, ds: Obj) -> None:
    """``spec.daemonsets``: pod labels and annotations (never ``app`` or
    ``app.kubernetes.io/part-of``: selectors are immutable), tolerations,
    priority class and update strategy; and every operand tolerates the
    remediation quarantine taint."""
    dspec = n.cp.spec.daemonsets
    tmpl = ds["spec"]["template"]
    pod_spec = tmpl["spec"]
    if dspec.labels:
        tmpl["metadata"].setdefault("labels", {}).update(
            {k: v for k, v in dspec.labels.items() if k not in ("app", "app.kubernetes.io/part-of")}
        )
    if dspec.annotations:
        tmpl["metadata"].setdefault("annotations", {}).update(dspec.annotations)
    if dspec.tolerations:
        existing = pod_spec.setdefault("tolerations", [])
        for tol in dspec.tolerations:
            if tol not in existing:
                existing.append(tol)
    repair_tol = {"key": consts.REPAIR_TAINT_KEY, "operator": "Exists", "effect": "NoSchedule"}
    tolerations = pod_spec.setdefault("tolerations", [])
    if repair_tol not in tolerations:
        tolerations.append(repair_tol)
    if dspec.priority_class_name:
        pod_spec["priorityClassName"] = dspec.priority_class_name
    strategy = ds["spec"].get("updateStrategy", {}).get("type")
    if dspec.update_strategy == "OnDelete" and strategy != "OnDelete":
        ds["spec"]["updateStrategy"] = {"type": "OnDelete"}
    elif dspec.rolling_update and strategy == "RollingUpdate":
        ds["spec"]["updateStrategy"] = {
            "type": "RollingUpdate",
            "rollingUpdate": {"maxUnavailable": dspec.rolling_update.max_unavailable},
        }


def _set_container_env(container: Obj, name: str, value: str) -> None:
    """Merge one env var (a ``valueFrom`` is replaced by the value)."""
    env = container.setdefault("env", [])
    for e in env:
        if e.get("name") == name:
            e.pop("valueFrom", None)
            e["value"] = value
            return
    env.append({"name": name, "value": value})


def _merge_env(container: Obj, env_vars) -> None:
    for e in env_vars or []:
        _set_container_env(container, e.name, e.value)


def _main_container(ds: Obj, name_hint: str = "") -> Obj:
    containers = ds["spec"]["template"]["spec"]["containers"]
    if name_hint:
        for c in containers:
            if c["name"] == name_hint:
                return c
    return containers[0]


def _all_containers(ds: Obj) -> List[Obj]:
    spec = ds["spec"]["template"]["spec"]
    return list(spec.get("initContainers", [])) + list(spec.get("containers", []))


def _apply_operand_image(n, ds: Obj, spec, main: str = "") -> Obj:
    """Fill the operand image into every placeholder container; returns
    the main container."""
    image = spec.image_path()
    for c in _all_containers(ds):
        if c.get("image") == PLACEHOLDER:
            c["image"] = image
            c["imagePullPolicy"] = spec.pull_policy()
    if spec.image_pull_secrets:
        ds["spec"]["template"]["spec"]["imagePullSecrets"] = [{"name": s} for s in spec.image_pull_secrets]
    return _main_container(ds, main)


def _apply_resources(container: Obj, spec) -> None:
    res = getattr(spec, "resources", None)
    if res:
        container["resources"] = {k: v for k, v in (("limits", res.limits), ("requests", res.requests)) if v}


def _mount_config_map(ds: Obj, container: Obj, cm_name: str, volume_name: str, mount_path: str) -> None:
    """Idempotently mount a ConfigMap volume read-only into one container."""
    vols = ds["spec"]["template"]["spec"].setdefault("volumes", [])
    if not any(v.get("name") == volume_name for v in vols):
        vols.append({"name": volume_name, "configMap": {"name": cm_name}})
    mounts = container.setdefault("volumeMounts", [])
    if not any(m.get("name") == volume_name for m in mounts):
        mounts.append({"name": volume_name, "mountPath": mount_path, "readOnly": True})


def _apply_proxy(n, ds: Obj) -> None:
    """Cluster-wide proxy env (both spellings) and the trusted-CA bundle
    into every container of a network-reaching operand."""
    proxy = n.cp.spec.operator.proxy
    if proxy is None:
        return
    env_pairs = [("HTTPS_PROXY", proxy.https_proxy), ("HTTP_PROXY", proxy.http_proxy), ("NO_PROXY", proxy.no_proxy)]
    for c in _all_containers(ds):
        for name, value in env_pairs:
            if value:
                _set_container_env(c, name, value)
                _set_container_env(c, name.lower(), value)
    if proxy.trusted_ca_config_map:
        for c in _all_containers(ds):
            _mount_config_map(ds, c, proxy.trusted_ca_config_map, "gpu-operator-trusted-ca", consts.TRUSTED_CA_MOUNT_DIR)
            _set_container_env(c, "SSL_CERT_FILE", consts.TRUSTED_CA_MOUNT_DIR + "/ca-bundle.crt")


def _transform_validation_init_containers(n, ds: Obj) -> None:
    """Point ``*-validation`` init containers at the validator image."""
    vspec = n.cp.spec.validator
    image = vspec.image_path()
    for c in ds["spec"]["template"]["spec"].get("initContainers", []):
        if c["name"].endswith("-validation"):
            if image:
                c["image"] = image
                c["imagePullPolicy"] = vspec.pull_policy()
            _merge_env(c, vspec.env)


# ---------------------------------------------------------------------------
# per-operand transforms
# ---------------------------------------------------------------------------


@_register("tpu-libtpu-daemonset")
def transform_driver(n, ds: Obj, generation: Optional[str] = None) -> None:
    """The driver installer: image (a variant's version from
    ``generationConfigs``), env, args, resources, probes, the driver root,
    the artifact-source and CA mounts, the proxy, the driver manager's
    drain knobs and the rolling-update override."""
    spec = n.cp.spec.driver
    if generation and spec.generation_configs.get(generation):
        spec = copy.deepcopy(spec)
        spec.version = spec.generation_configs[generation]
    main = _apply_operand_image(n, ds, spec, "driver-ctr")
    _merge_env(main, spec.env)
    if spec.args:
        main["args"] = list(spec.args)
    _apply_resources(main, spec)
    _set_container_env(main, "DRIVER_ROOT", spec.install_dir)
    if spec.startup_probe:
        main["startupProbe"] = {**main.get("startupProbe", {}), **spec.startup_probe}
    if spec.liveness_probe:
        main["livenessProbe"] = spec.liveness_probe
    if spec.readiness_probe:
        main["readinessProbe"] = spec.readiness_probe
    if spec.repo_config.get("configMapName"):
        _mount_config_map(ds, main, spec.repo_config["configMapName"], "driver-repo-config", consts.DRIVER_REPO_CONFIG_DIR)
    if spec.cert_config.get("name"):
        _mount_config_map(ds, main, spec.cert_config["name"], "driver-cert-config", consts.DRIVER_CERT_CONFIG_DIR)
    _apply_proxy(n, ds)
    mgr = next(
        (c for c in ds["spec"]["template"]["spec"].get("initContainers", []) if c["name"] == "driver-manager"), None
    )
    if mgr is not None:
        mgr["image"] = spec.image_path()
        pol = spec.upgrade_policy
        drain = pol.drain if pol else None
        if drain:
            if drain.enable is not None:
                _set_container_env(mgr, "ENABLE_AUTO_DRAIN", "true" if drain.enable else "false")
            if drain.force:
                _set_container_env(mgr, "DRAIN_USE_FORCE", "true")
            if drain.pod_selector:
                _set_container_env(mgr, "DRAIN_POD_SELECTOR_LABEL", drain.pod_selector)
            if drain.timeout_seconds:
                _set_container_env(mgr, "DRAIN_TIMEOUT_SECONDS", str(drain.timeout_seconds))
    if spec.rolling_update and ds["spec"]["updateStrategy"]["type"] == "RollingUpdate":
        ds["spec"]["updateStrategy"]["rollingUpdate"] = {"maxUnavailable": spec.rolling_update.max_unavailable}


@_register("tpu-runtime-daemonset")
def transform_toolkit(n, ds: Obj, generation: Optional[str] = None) -> None:
    """The toolkit wiring: the driver root it reads libraries from, the CDI
    spec it writes, and containerd's drop-in directory while the runtime is
    containerd."""
    spec = n.cp.spec.toolkit
    main = _apply_operand_image(n, ds, spec, "gpu-toolkit-ctr")
    _merge_env(main, spec.env)
    _set_container_env(main, "DRIVER_ROOT", n.cp.spec.driver.install_dir)
    _set_container_env(main, "CDI_SPEC_PATH", consts.CDI_SPEC_PATH)
    if (n.runtime or "containerd") == "containerd":
        _set_container_env(main, "CONTAINERD_CONF_DIR", CONTAINERD_CONF_DIR)


@_register("tpu-device-plugin-daemonset")
def transform_device_plugin(n, ds: Obj, generation: Optional[str] = None) -> None:
    """The device plugin: slice strategy, CDI, the driver root, and a custom
    config ConfigMap mounted at ``/config``."""
    spec = n.cp.spec.device_plugin
    main = _apply_operand_image(n, ds, spec, "gpu-device-plugin")
    _merge_env(main, spec.env)
    if spec.args:
        main["args"] = list(spec.args)
    _apply_resources(main, spec)
    _set_container_env(main, "SLICE_STRATEGY", n.cp.spec.slice.strategy or "single")
    _set_container_env(main, "CDI_ENABLED", str(n.cp.spec.cdi.is_enabled()).lower())
    _set_container_env(main, "DRIVER_ROOT", n.cp.spec.driver.install_dir)
    if spec.config and spec.config.name:
        _mount_named_config(ds, main, spec.config.name, "/config")


def _mount_named_config(ds: Obj, container: Obj, cm_name: str, mount_path: str) -> None:
    """A custom ConfigMap as the ``custom-config`` volume at ``mount_path``."""
    vols = ds["spec"]["template"]["spec"].setdefault("volumes", [])
    vols.append({"name": "custom-config", "configMap": {"name": cm_name}})
    container.setdefault("volumeMounts", []).append({"name": "custom-config", "mountPath": mount_path})


# the validator's optional diagnostics, cloned after cuda-validation in this order
OPTIONAL_DIAGNOSTICS = ("membw", "ringattn", "ici", "pipeline", "moe", "flashattn")


@_register("tpu-operator-validator")
def transform_validator(n, ds: Obj, generation: Optional[str] = None) -> None:
    """The validator: image, env and resources; the optional diagnostics
    cloned from ``cuda-validation`` (the card is already proven free) in
    ``OPTIONAL_DIAGNOSTICS`` order; each init container's component env;
    and the workload pods' image and pull credentials on
    ``plugin-validation`` and ``cuda-validation``."""
    spec = n.cp.spec.validator
    main = _apply_operand_image(n, ds, spec, consts.VALIDATOR_APP)
    _merge_env(main, spec.env)
    _apply_resources(main, spec)
    inits = ds["spec"]["template"]["spec"].setdefault("initContainers", [])
    diag_ctr_names = tuple(f"{name}-validation" for name in OPTIONAL_DIAGNOSTICS)
    for comp_name in OPTIONAL_DIAGNOSTICS:
        ctr_name = f"{comp_name}-validation"
        if (getattr(spec, comp_name) or {}).get("enabled") and not any(c["name"] == ctr_name for c in inits):
            cuda_idx = next((i for i, c in enumerate(inits) if c["name"] == "cuda-validation"), None)
            if cuda_idx is not None:
                ctr = copy.deepcopy(inits[cuda_idx])
                ctr["name"] = ctr_name
                ctr["args"] = [f"gpu-validator --component {comp_name}"]
                insert_at = cuda_idx + 1
                while insert_at < len(inits) and inits[insert_at]["name"] in diag_ctr_names:
                    insert_at += 1
                inits.insert(insert_at, ctr)
    component_specs = {
        "plugin-validation": spec.plugin,
        "cuda-validation": spec.cuda,
        "driver-validation": spec.driver,
        "toolkit-validation": spec.toolkit,
        **{f"{name}-validation": getattr(spec, name) for name in OPTIONAL_DIAGNOSTICS},
    }
    for c in inits:
        for e in (component_specs.get(c["name"]) or {}).get("env", []) or []:
            _set_container_env(c, e["name"], e["value"])
        if c["name"] in ("plugin-validation", "cuda-validation"):
            image = spec.image_path()
            if image:
                _set_container_env(c, "CUDA_WORKLOAD_IMAGE", image)
                _set_container_env(c, "CUDA_WORKLOAD_PULL_POLICY", spec.pull_policy())
            if spec.image_pull_secrets:
                _set_container_env(c, "CUDA_WORKLOAD_PULL_SECRETS", ",".join(spec.image_pull_secrets))


@_register("tpu-metricsd")
def transform_metricsd(n, ds: Obj, generation: Optional[str] = None) -> None:
    """The metrics daemon: its port, and with ``sampleOnChip`` the
    card-owning sampler as a sidecar whose side file the hostengine
    merges."""
    spec = n.cp.spec.metricsd
    main = _apply_operand_image(n, ds, spec, "gpu-metricsd")
    _merge_env(main, spec.env)
    if spec.host_port and spec.host_port != 5555:
        for port in main.get("ports", []):
            if port.get("name") == "metricsd":
                port["hostPort"] = spec.host_port
                port["containerPort"] = spec.host_port
        _set_container_env(main, "METRICSD_PORT", str(spec.host_port))
    if spec.sample_on_chip:
        pod_spec = ds["spec"]["template"]["spec"]
        if not any(c.get("name") == "gpu-metricsd-sampler" for c in pod_spec.get("containers", [])):
            pod_spec["containers"].append(
                {
                    "name": "gpu-metricsd-sampler",
                    "image": main["image"],
                    "imagePullPolicy": main.get("imagePullPolicy", "IfNotPresent"),
                    "command": ["gpu-metricsd"],
                    "args": ["--sampler-only"],
                    "securityContext": {"privileged": True},
                    "volumeMounts": [
                        {"name": "run-tpu", "mountPath": "/run/tpu"},
                        {"name": "dev", "mountPath": "/dev"},
                    ],
                }
            )


@_register("tpu-metrics-exporter")
def transform_metrics_exporter(n, ds: Obj, generation: Optional[str] = None) -> None:
    """The exporter: through the metrics daemon when it runs, and a custom
    metrics ConfigMap (key ``metrics.csv``) as its metrics config."""
    spec = n.cp.spec.metrics_exporter
    main = _apply_operand_image(n, ds, spec, "gpu-metrics-exporter")
    _merge_env(main, spec.env)
    _apply_resources(main, spec)
    if n.cp.spec.metricsd.is_enabled():
        _set_container_env(main, "METRICSD_ENDPOINT", f"localhost:{n.cp.spec.metricsd.host_port}")
    if spec.metrics_config and spec.metrics_config.name:
        _mount_named_config(ds, main, spec.metrics_config.name, METRICS_CONFIG_DIR)
        _set_container_env(main, "METRICS_CONFIG_FILE", f"{METRICS_CONFIG_DIR}/{METRICS_CONFIG_KEY}")


@_register("tpu-node-status-exporter")
def transform_node_status_exporter(n, ds: Obj, generation: Optional[str] = None) -> None:
    spec = n.cp.spec.node_status_exporter
    main = _apply_operand_image(n, ds, spec, "gpu-node-status-exporter")
    _merge_env(main, spec.env)


@_register("tpu-feature-discovery")
def transform_tfd(n, ds: Obj, generation: Optional[str] = None) -> None:
    spec = n.cp.spec.tfd
    main = _apply_operand_image(n, ds, spec, "gpu-feature-discovery")
    _merge_env(main, spec.env)
    _apply_resources(main, spec)


@_register("tpu-slice-manager")
def transform_slice_manager(n, ds: Obj, generation: Optional[str] = None) -> None:
    """The slice manager: the CDI spec it rewrites (with CDI on), and the
    custom slice-config and chip-clients ConfigMaps."""
    spec = n.cp.spec.slice_manager
    main = _apply_operand_image(n, ds, spec, "gpu-slice-manager")
    _merge_env(main, spec.env)
    if n.cp.spec.cdi.is_enabled():
        _set_container_env(main, "CDI_SPEC_PATH", consts.CDI_SPEC_PATH)
    if spec.config and spec.config.name:
        for vol in ds["spec"]["template"]["spec"]["volumes"]:
            if vol["name"] == "slice-config":
                vol["configMap"]["name"] = spec.config.name
    if spec.chip_clients_config and spec.chip_clients_config.name:
        for vol in ds["spec"]["template"]["spec"]["volumes"]:
            if vol["name"] == "chip-clients":
                vol["configMap"]["name"] = spec.chip_clients_config.name


@_register("tpu-maintenance-handler")
def transform_maintenance_handler(n, ds: Obj, generation: Optional[str] = None) -> None:
    spec = n.cp.spec.maintenance_handler
    main = _apply_operand_image(n, ds, spec, "gpu-maintenance-handler")
    _merge_env(main, spec.env)
    _apply_resources(main, spec)
    if spec.poll_interval_seconds:
        _set_container_env(main, "POLL_INTERVAL_S", str(spec.poll_interval_seconds))
    if spec.force_evict is not None:
        _set_container_env(main, "FORCE_EVICT", "true" if spec.force_evict else "false")
    if spec.evict_workloads is not None:
        _set_container_env(main, "EVICT_WORKLOADS", "true" if spec.evict_workloads else "false")


@_register("tpu-vm-manager-daemonset")
def transform_vm_manager(n, ds: Obj, generation: Optional[str] = None) -> None:
    spec = n.cp.spec.vm_manager
    main = _apply_operand_image(n, ds, spec, "gpu-vm-manager")
    _merge_env(main, spec.env)


@_register("tpu-vm-device-manager")
def transform_vm_device_manager(n, ds: Obj, generation: Optional[str] = None) -> None:
    spec = n.cp.spec.vm_device_manager
    main = _apply_operand_image(n, ds, spec, "gpu-vm-device-manager")
    _merge_env(main, spec.env)
    if spec.config and spec.config.name:
        for vol in ds["spec"]["template"]["spec"]["volumes"]:
            if vol["name"] == "vm-device-config":
                vol["configMap"]["name"] = spec.config.name
        if spec.config.default:
            _set_container_env(main, "DEFAULT_VM_DEVICE_CONFIG", spec.config.default)


@_register("tpu-sandbox-validator")
def transform_sandbox_validator(n, ds: Obj, generation: Optional[str] = None) -> None:
    _apply_operand_image(n, ds, n.cp.spec.validator, "gpu-sandbox-validator")


@_register("tpu-vfio-manager-daemonset")
def transform_vfio_manager(n, ds: Obj, generation: Optional[str] = None) -> None:
    spec = n.cp.spec.vfio_manager
    main = _apply_operand_image(n, ds, spec, "gpu-vfio-manager")
    _merge_env(main, spec.env)


@_register("tpu-sandbox-device-plugin-daemonset")
def transform_sandbox_device_plugin(n, ds: Obj, generation: Optional[str] = None) -> None:
    spec = n.cp.spec.sandbox_device_plugin
    main = _apply_operand_image(n, ds, spec, "gpu-sandbox-device-plugin")
    _merge_env(main, spec.env)
    if spec.args:
        main["args"] = list(spec.args)


@_register("tpu-kata-manager-daemonset")
def transform_kata_manager(n, ds: Obj, generation: Optional[str] = None) -> None:
    spec = n.cp.spec.kata_manager
    main = _apply_operand_image(n, ds, spec, "gpu-kata-manager")
    _merge_env(main, spec.env)


# ---------------------------------------------------------------------------
# readiness
# ---------------------------------------------------------------------------


def _nodes_wanting(n, ds: Obj) -> int:
    """How many nodes match the DaemonSet's nodeSelector, from the pass's
    snapshot when one is open."""
    selector = ds.get("spec", {}).get("template", {}).get("spec", {}).get("nodeSelector", {}) or {}
    snap = getattr(n, "snapshot", None)
    if snap is not None:
        return snap.count_nodes_matching(selector)
    count = 0
    for node in n.client.list("v1", "Node"):
        labels = node.get("metadata", {}).get("labels", {}) or {}
        if all(labels.get(k) == v for k, v in selector.items()):
            count += 1
    return count


def is_daemonset_ready(n, ds: Obj) -> bool:
    """Nothing scheduled: ready iff no node wants the operand. Else no pod
    unavailable, and for OnDelete every pod Running at the template's
    operand hash; for RollingUpdate every pod updated."""
    status = ds.get("status", {}) or {}
    desired = status.get("desiredNumberScheduled", 0)
    if desired == 0:
        return _nodes_wanting(n, ds) == 0
    if status.get("numberUnavailable", 0) != 0:
        return False
    strategy = ds.get("spec", {}).get("updateStrategy", {}).get("type")
    if strategy == "OnDelete":
        want = ds["spec"]["template"]["metadata"].get("annotations", {}).get(consts.LAST_APPLIED_HASH_ANNOTATION)
        app = ds["spec"]["selector"]["matchLabels"].get("app")
        snap = getattr(n, "snapshot", None)
        if snap is not None:
            pods = snap.pods_by_app(app)
        else:
            pods = n.client.list("v1", "Pod", n.namespace, label_selector={"app": app})
        if len(pods) < desired:
            return False
        for p in pods:
            got = (p["metadata"].get("annotations", {}) or {}).get(consts.LAST_APPLIED_HASH_ANNOTATION)
            if want and got != want:
                return False
            if p.get("status", {}).get("phase") != "Running":
                return False
        return True
    return status.get("updatedNumberScheduled", desired) >= desired


def is_deployment_ready(dep: Obj) -> bool:
    status = dep.get("status", {}) or {}
    return status.get("availableReplicas", 0) >= dep.get("spec", {}).get("replicas", 1)


def is_pod_ready(pod_obj: Obj) -> bool:
    return pod_obj.get("status", {}).get("phase") in ("Running", "Succeeded")


CONTROLS = {
    "service_account": service_account,
    "role": role,
    "role_binding": role_binding,
    "cluster_role": cluster_role,
    "cluster_role_binding": cluster_role_binding,
    "config_map": config_map,
    "service": service,
    "service_monitor": service_monitor,
    "prometheus_rule": prometheus_rule,
    "runtime_class": runtime_class,
    "priority_class": priority_class,
    "pod_security_policy": pod_security_policy,
    "security_context_constraints": security_context_constraints,
    "pod": pod,
    "daemonset": daemonset,
    "deployment": deployment,
}
