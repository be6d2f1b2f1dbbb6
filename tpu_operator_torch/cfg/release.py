"""OLM release engineering for the port: versioned bundles and the
upgrade graph's lint.

The port's copy of ``tpu_operator/cfg/release.py``, whole:

* ``cut_release(version, replaces)`` writes ``<bundle>/v<version>/``
  (manifests: the CSV and the CRD; metadata: annotations) and refreshes
  the top-level ``<bundle>/manifests`` to the new head;
* ``validate_bundle_tree(bundle_dir)`` is the ``operator-sdk bundle
  validate`` slot: the annotations, each release's CSV and CRD, and a
  well-formed upgrade graph (one head, an acyclic ``replaces`` chain whose
  every edge lands on a shipped version, ``skips`` edges likewise).

The CSV is ``gpu-operator.clusterserviceversion.yaml`` in the package
``gpu-operator``; ``bundle_dir`` and ``config_dir`` default to the port's
own ``deploy/bundle`` and ``deploy/config`` as absolute paths.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List

from tpu_operator_torch import consts
from tpu_operator_torch.cfg.csvgen import (
    CSV_PREFIX,
    DEFAULT_CONFIG_DIR,
    DEPLOY_DIR,
    OPERATOR_VERSION,
    PACKAGE,
    build_csv,
    validate_csv,
)

_VERSION_DIR = re.compile(r"^v\d+\.\d+\.\d+$")
CSV_NAME = f"{PACKAGE}.clusterserviceversion.yaml"
DEFAULT_BUNDLE_DIR = os.path.join(DEPLOY_DIR, "bundle")


def _crd_filename() -> str:
    return f"{consts.GROUP}_clusterpolicies.yaml"


def cut_release(
    version: str,
    replaces: str = "",
    bundle_dir: str = DEFAULT_BUNDLE_DIR,
    config_dir: str = DEFAULT_CONFIG_DIR,
) -> str:
    """Write ``<bundle_dir>/v<version>/`` and refresh the top-level bundle to
    match (the newest release is mirrored at ``<bundle_dir>/manifests``).
    Returns the release directory path."""
    import yaml

    from tpu_operator_torch.cfg.crdgen import render_crd_yaml

    ver = version.lstrip("v")
    rel_dir = os.path.join(bundle_dir, f"v{ver}")
    manifests = os.path.join(rel_dir, "manifests")
    metadata = os.path.join(rel_dir, "metadata")
    os.makedirs(manifests, exist_ok=True)
    os.makedirs(metadata, exist_ok=True)

    csv = build_csv(config_dir, version=ver, replaces=replaces)
    csv_yaml = yaml.safe_dump(csv, sort_keys=False, width=100)
    crd_yaml = render_crd_yaml()
    with open(os.path.join(manifests, CSV_NAME), "w") as f:
        f.write(csv_yaml)
    with open(os.path.join(manifests, _crd_filename()), "w") as f:
        f.write(crd_yaml)
    shutil.copy(
        os.path.join(bundle_dir, "metadata", "annotations.yaml"),
        os.path.join(metadata, "annotations.yaml"),
    )
    # head mirror: top-level manifests == newest release
    with open(os.path.join(bundle_dir, "manifests", CSV_NAME), "w") as f:
        f.write(csv_yaml)
    with open(os.path.join(bundle_dir, "manifests", _crd_filename()), "w") as f:
        f.write(crd_yaml)
    return rel_dir


def _load(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def validate_bundle_tree(
    bundle_dir: str = DEFAULT_BUNDLE_DIR, config_dir: str = DEFAULT_CONFIG_DIR
) -> List[str]:
    """The ``operator-sdk bundle validate`` slot."""
    problems: List[str] = []

    # -- annotations -----------------------------------------------------
    ann_path = os.path.join(bundle_dir, "metadata", "annotations.yaml")
    try:
        ann = _load(ann_path)["annotations"]
    except Exception as e:
        return [f"{ann_path}: unreadable ({e})"]
    for key, want in (
        ("operators.operatorframework.io.bundle.mediatype.v1", "registry+v1"),
        ("operators.operatorframework.io.bundle.manifests.v1", "manifests/"),
        ("operators.operatorframework.io.bundle.metadata.v1", "metadata/"),
        ("operators.operatorframework.io.bundle.package.v1", PACKAGE),
    ):
        if ann.get(key) != want:
            problems.append(f"annotations: {key} = {ann.get(key)!r}, want {want!r}")
    default_channel = ann.get("operators.operatorframework.io.bundle.channel.default.v1", "")
    channels = ann.get("operators.operatorframework.io.bundle.channels.v1", "").split(",")
    if default_channel not in channels:
        problems.append(f"annotations: default channel {default_channel!r} not in {channels}")

    # -- per-release bundles --------------------------------------------
    versions: Dict[str, Dict[str, Any]] = {}
    for entry in sorted(os.listdir(bundle_dir)):
        if not _VERSION_DIR.match(entry):
            continue
        rel = os.path.join(bundle_dir, entry)
        csv_path = os.path.join(rel, "manifests", CSV_NAME)
        crd_path = os.path.join(rel, "manifests", _crd_filename())
        meta_path = os.path.join(rel, "metadata", "annotations.yaml")
        for req in (csv_path, crd_path, meta_path):
            if not os.path.exists(req):
                problems.append(f"{entry}: missing {os.path.relpath(req, rel)}")
        if not os.path.exists(csv_path):
            continue
        csv = _load(csv_path)
        ver = entry[1:]
        if csv.get("metadata", {}).get("name") != f"{CSV_PREFIX}{ver}":
            problems.append(
                f"{entry}: CSV name {csv.get('metadata', {}).get('name')!r} "
                f"!= {CSV_PREFIX}{ver}"
            )
        if str(csv.get("spec", {}).get("version")) != ver:
            problems.append(f"{entry}: spec.version {csv.get('spec', {}).get('version')!r} != {ver}")
        if os.path.exists(crd_path):
            crd = _load(crd_path)
            if crd.get("metadata", {}).get("name") != consts.CRD_NAME:
                problems.append(f"{entry}: wrong CRD {crd.get('metadata', {}).get('name')!r}")
        # full CSV lint; freshness only for the current release (an older
        # bundle is a frozen snapshot of older sources)
        problems += [
            f"{entry}: {p}"
            for p in validate_csv(csv_path, config_dir=config_dir, check_fresh=(ver == OPERATOR_VERSION))
        ]
        versions[ver] = csv

    if not versions:
        problems.append(f"{bundle_dir}: no versioned release bundles (bundle/vX.Y.Z)")
        return problems

    # -- upgrade graph ---------------------------------------------------
    replaces: Dict[str, str] = {}
    for ver, csv in versions.items():
        target = str(csv.get("spec", {}).get("replaces", ""))
        if target:
            target_ver = target.removeprefix(CSV_PREFIX)
            if target_ver not in versions:
                problems.append(f"v{ver}: replaces {target!r} which is not a shipped bundle")
            replaces[ver] = target_ver
        # skips edges are graph edges too: in this self-contained tree
        # every skipped version must be a shipped bundle
        for skip in csv.get("spec", {}).get("skips", []):
            skip_ver = str(skip).removeprefix(CSV_PREFIX)
            if skip_ver not in versions:
                problems.append(f"v{ver}: skips {skip!r} which is not a shipped bundle")

    replaced = set(replaces.values())
    heads = [v for v in versions if v not in replaced]
    if len(heads) != 1:
        problems.append(f"upgrade graph must have exactly one head, got {sorted(heads)}")
    else:
        # walk the chain head -> tail; every shipped version reachable
        seen = []
        cur = heads[0]
        while cur is not None and cur not in seen:
            seen.append(cur)
            cur = replaces.get(cur)
        if cur is not None:
            problems.append(f"upgrade graph has a replaces cycle at v{cur}")
        missing = set(versions) - set(seen)
        if missing:
            problems.append(
                f"versions unreachable from head v{heads[0]}: "
                f"{sorted('v' + m for m in missing)}"
            )
        if heads[0] != OPERATOR_VERSION:
            problems.append(f"graph head v{heads[0]} != current version v{OPERATOR_VERSION}")

    # -- head mirror -----------------------------------------------------
    top_csv_path = os.path.join(bundle_dir, "manifests", CSV_NAME)
    if os.path.exists(top_csv_path):
        top = _load(top_csv_path)
        head_ver = heads[0] if len(heads) == 1 else OPERATOR_VERSION
        if head_ver in versions and top != versions[head_ver]:
            problems.append(
                "bundle/manifests CSV is not the graph head "
                f"(v{head_ver}); re-run cut_release"
            )
    else:
        problems.append("missing top-level bundle/manifests CSV")
    return problems
