"""OLM ClusterServiceVersion generation for the port's bundle.

The port's copy of ``tpu_operator/cfg/csvgen.py``, whole. The CSV is
generated from the sources the rest of the port's install tree treats as
truth: the sample ClusterPolicy (``deploy/config/samples``), the operator
Deployment (``deploy/config/manager``) and the RBAC rules
(``deploy/config/rbac``), so bundle, kustomize base and chart cannot drift
apart. ``gpuop-cfg generate csv`` prints it; ``gpuop-cfg validate csv``
checks the on-disk CSV is fresh and its images pinned.

What the port decides here:

* The CSV names the port: ``gpu-operator.v<ver>``, with ``replaces`` and
  ``skips`` edges ``gpu-operator.v<x>`` and the builder ``gpuop-cfg``.
* ``config_dir`` defaults to the package's own ``deploy/config`` as an
  absolute path (``DEFAULT_CONFIG_DIR``), never to ``config`` under the
  working directory: run from the repo root, that is the JAX package's
  kustomize base.
* The checks are the reference's, in its order: alm-examples JSON, the
  ClusterPolicy examples through the port's ``validate_clusterpolicy_obj``,
  the owned CRD, pinned images in ``relatedImages`` and in the
  Deployment's containers, then version and freshness.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from tpu_operator_torch import consts

OPERATOR_VERSION = consts.VERSION
PACKAGE = "gpu-operator"  # the OLM package and the CSV's name stem
CSV_PREFIX = f"{PACKAGE}.v"
BUILDER = "gpuop-cfg"
REGENERATE = f"{BUILDER} release bundle"  # what writes a release's CSV and the head mirror
DEPLOY_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "deploy")
DEFAULT_CONFIG_DIR = os.path.join(DEPLOY_DIR, "config")

DESCRIPTION = """\
The GPU Operator manages the software needed to provision NVIDIA GPU nodes
in a Kubernetes cluster: the driver, the container toolkit, the GPU device
plugin, GPU feature discovery, NVLink-domain partitioning, metrics export,
and an end-to-end PyTorch/CUDA validation harness, all driven by a single
cluster-scoped ClusterPolicy resource reconciled through an ordered state
machine.
"""


def _load_yaml(path: str):
    import yaml

    with open(path) as f:
        return list(yaml.safe_load_all(f))


def build_csv(
    config_dir: str = DEFAULT_CONFIG_DIR,
    version: str = OPERATOR_VERSION,
    replaces: str = "",
    skips: List[str] = (),
) -> Dict[str, Any]:
    sample = _load_yaml(os.path.join(config_dir, "samples", "v1_clusterpolicy.yaml"))[0]
    deployment = _load_yaml(os.path.join(config_dir, "manager", "manager.yaml"))[0]
    rbac_docs = _load_yaml(os.path.join(config_dir, "rbac", "role.yaml"))
    cluster_rules: List[dict] = []
    for doc in rbac_docs:
        if doc and doc.get("kind") == "ClusterRole":
            cluster_rules.extend(doc.get("rules", []))

    dep_spec = deployment["spec"]
    service_account = dep_spec["template"]["spec"]["serviceAccountName"]
    operator_image = dep_spec["template"]["spec"]["containers"][0]["image"]

    related = [{"name": PACKAGE, "image": operator_image}]
    for key, sub in sorted(sample.get("spec", {}).items()):
        if not isinstance(sub, dict) or "image" not in sub:
            continue
        repo, img, ver = sub.get("repository", ""), sub["image"], sub.get("version", "")
        # always emit the entry, even when repository/version are missing:
        # an incomplete ref renders untagged and validate_csv's unpinned
        # check flags it
        ref = f"{repo}/{img}" if repo else img
        if ver:
            sep = "@" if ver.startswith("sha256:") else ":"
            ref = f"{ref}{sep}{ver}"
        related.append({"name": img, "image": ref})

    spec_extra: Dict[str, Any] = {}
    if replaces:
        spec_extra["replaces"] = f"{CSV_PREFIX}{replaces.lstrip('v')}"
    if skips:
        spec_extra["skips"] = [f"{CSV_PREFIX}{s.lstrip('v')}" for s in skips]

    return {
        "apiVersion": "operators.coreos.com/v1alpha1",
        "kind": "ClusterServiceVersion",
        "metadata": {
            "name": f"{CSV_PREFIX}{version}",
            "namespace": "placeholder",
            "annotations": {
                "alm-examples": json.dumps([sample], indent=2),
                "operators.operatorframework.io/builder": BUILDER,
                "operators.operatorframework.io/project_layout": "python",
                "capabilities": "Deep Insights",
                "categories": "AI/Machine Learning, OpenShift Optional",
                "description": "Automates provisioning of NVIDIA GPU nodes.",
                "provider": "tpu-operator authors",
            },
        },
        "spec": {
            "displayName": "GPU Operator",
            "description": DESCRIPTION,
            "version": version,
            "maturity": "alpha",
            "provider": {"name": "tpu-operator authors"},
            "keywords": ["gpu", "cuda", "pytorch", "device plugin", "accelerator"],
            "maintainers": [{"name": "tpu-operator authors"}],
            "links": [],
            "minKubeVersion": "1.24.0",
            "installModes": [
                {"type": "OwnNamespace", "supported": True},
                {"type": "SingleNamespace", "supported": True},
                {"type": "MultiNamespace", "supported": False},
                {"type": "AllNamespaces", "supported": False},
            ],
            "customresourcedefinitions": {
                "owned": [
                    {
                        "name": consts.CRD_NAME,
                        "kind": "ClusterPolicy",
                        "version": "v1",
                        "displayName": "ClusterPolicy",
                        "description": "Desired state of the GPU software "
                        "stack on every GPU node.",
                    }
                ]
            },
            "install": {
                "strategy": "deployment",
                "spec": {
                    "clusterPermissions": [
                        {"serviceAccountName": service_account, "rules": cluster_rules}
                    ],
                    "deployments": [
                        {"name": deployment["metadata"]["name"], "spec": dep_spec}
                    ],
                },
            },
            "relatedImages": related,
            **spec_extra,
        },
    }


def render_csv_yaml(config_dir: str = DEFAULT_CONFIG_DIR) -> str:
    import yaml

    return yaml.safe_dump(build_csv(config_dir), sort_keys=False, width=100)


def _unpinned(image: str) -> bool:
    return ":" not in image.rsplit("/", 1)[-1] and "@" not in image


def validate_csv(
    path: str, config_dir: str = DEFAULT_CONFIG_DIR, check_fresh: bool = True
) -> List[str]:
    """Problems list (empty = valid): decodability, alm-examples validity,
    owned-CRD consistency, image pinning, freshness against the generator
    (``check_fresh=False`` for an older release bundle, a frozen snapshot
    of older sources)."""
    import yaml

    from tpu_operator_torch.cfg.main import validate_clusterpolicy_obj

    problems: List[str] = []
    try:
        with open(path) as f:
            csv = yaml.safe_load(f)
    except (OSError, yaml.YAMLError) as e:
        return [f"cannot read {path}: {e}"]
    if not isinstance(csv, dict) or csv.get("kind") != "ClusterServiceVersion":
        return [f"{path}: not a ClusterServiceVersion"]

    alm = csv.get("metadata", {}).get("annotations", {}).get("alm-examples", "[]")
    try:
        examples = json.loads(alm)
    except json.JSONDecodeError as e:
        examples = []
        problems.append(f"alm-examples not valid JSON: {e}")
    if not isinstance(examples, list) or not all(isinstance(e, dict) for e in examples):
        problems.append("alm-examples is not a list of objects")
        examples = [e for e in examples if isinstance(e, dict)] if isinstance(examples, list) else []
    cps = [e for e in examples if e.get("kind") == "ClusterPolicy"]
    if not cps:
        problems.append("alm-examples has no ClusterPolicy example")
    for example in cps:
        problems.extend(validate_clusterpolicy_obj(example))

    owned = csv.get("spec", {}).get("customresourcedefinitions", {}).get("owned", [])
    names = {(o.get("name"), o.get("version"), o.get("kind")) for o in owned}
    if (consts.CRD_NAME, "v1", "ClusterPolicy") not in names:
        problems.append(
            f"owned CRDs {sorted(names)} missing "
            f"({consts.CRD_NAME!r}, 'v1', 'ClusterPolicy')"
        )

    for entry in csv.get("spec", {}).get("relatedImages", []):
        image = entry.get("image", "")
        if _unpinned(image):
            problems.append(f"relatedImage {entry.get('name')}: {image!r} unpinned")
    for dep in csv.get("spec", {}).get("install", {}).get("spec", {}).get("deployments", []):
        if not isinstance(dep, dict):
            problems.append(f"install.spec.deployments entry not an object: {dep!r}")
            continue
        pod_spec = ((dep.get("spec") or {}).get("template", {}) or {}).get("spec", {}) or {}
        containers = pod_spec.get("containers")
        if not containers:
            problems.append(f"deployment {dep.get('name', '?')}: no pod template containers")
            continue
        for ctr in containers:
            image = ctr.get("image", "")
            if _unpinned(image):
                problems.append(f"deployment container {ctr.get('name', '?')}: {image!r} unpinned")

    # freshness against the generator, at the CSV's own version and graph
    # position so a versioned release bundle validates too
    if check_fresh and os.path.isdir(config_dir):
        spec = csv.get("spec", {})
        version = str(spec.get("version", OPERATOR_VERSION))
        if version != OPERATOR_VERSION:
            problems.append(
                f"{path}: version {version} != current {OPERATOR_VERSION}; "
                f"run '{REGENERATE}'"
            )
        replaces = str(spec.get("replaces", "")).removeprefix(CSV_PREFIX)
        skips = [s.removeprefix(CSV_PREFIX) for s in spec.get("skips", [])]
        if csv != build_csv(config_dir, version=version, replaces=replaces, skips=skips):
            problems.append(
                f"{path} is stale; regenerate with '{REGENERATE}' "
                "(it keeps the replaces edge)"
            )
    return problems
