"""``gpuop-cfg`` — config validation CLI (reference ``cmd/gpuop-cfg``).

    python -m tpu_operator_torch.cfg validate clusterpolicy --input FILE
    python -m tpu_operator_torch.cfg validate chart|csv|bundle
    python -m tpu_operator_torch.cfg generate crd|csv
    python -m tpu_operator_torch.cfg release bundle --version X.Y.Z

The port's copy of ``tpu_operator/cfg/main.py``, all seven subcommands:

  validate clusterpolicy --input FILE   schema admission, decode and
                                        image-resolution checks
  validate chart [--dir DIR]            the chart's values decode as a
                                        ClusterPolicySpec and its crds/
                                        equal the generated CRD
  validate csv [--input FILE]           the CSV's examples, owned CRD,
                                        pinned images and freshness
  validate bundle [--dir DIR]           the bundle tree and its upgrade
                                        graph (``release.py``)
  generate crd                          print the CRD manifest
  generate csv                          print the CSV (``csvgen.py``)
  release bundle --version X.Y.Z        cut ``<bundle>/vX.Y.Z`` and the
                                        head mirror

Every directory and file flag defaults to the port's own install tree
under ``tpu_operator_torch/deploy/`` as an absolute path, so a run from
any working directory reads the port's chart, ``config/`` and bundle,
never the JAX package's. The rc and the output are ``tpuop-cfg``'s: 0 and
``OK``, or 1 with one ``INVALID:`` line a problem on stderr.
"""

from __future__ import annotations

import argparse
import os
import sys

from tpu_operator_torch.api.v1.clusterpolicy_types import ClusterPolicySpec, clusterpolicy_from_obj
from tpu_operator_torch.cfg.csvgen import DEFAULT_CONFIG_DIR, DEPLOY_DIR

DEFAULT_CHART_DIR = os.path.join(DEPLOY_DIR, "gpu-operator")  # the port's Helm chart


def validate_clusterpolicy(path: str) -> list:
    """Returns a list of problems (empty = valid)."""
    import yaml

    with open(path) as f:
        obj = yaml.safe_load(f)
    if not isinstance(obj, dict):
        return [f"{path}: not a mapping"]
    return validate_clusterpolicy_obj(obj)


def validate_clusterpolicy_obj(obj: dict) -> list:
    problems = []
    if obj.get("kind") != "ClusterPolicy":
        problems.append(f"kind is {obj.get('kind')!r}, want ClusterPolicy")
    # schema validation first — exactly what the apiserver enforces at
    # admission against the generated CRD (enums, typed maps, bounds)
    from tpu_operator_torch.cfg.crdgen import build_crd
    from tpu_operator_torch.cfg.schema_validate import validate_cr

    problems += validate_cr(build_crd(), obj)
    try:
        cp = clusterpolicy_from_obj(obj)
    except Exception as e:
        # a CR the apiserver would reject may not decode at all; report
        # the admission problems instead of crashing on the decoder
        problems.append(f"spec does not decode: {e}")
        return problems
    spec = cp.spec
    # every enabled operand must resolve to a pullable image ref
    named = [
        ("driver", spec.driver),
        ("toolkit", spec.toolkit),
        ("devicePlugin", spec.device_plugin),
        ("metricsd", spec.metricsd),
        ("metricsExporter", spec.metrics_exporter),
        ("nodeStatusExporter", spec.node_status_exporter),
        ("tfd", spec.tfd),
        ("sliceManager", spec.slice_manager),
        ("validator", spec.validator),
    ]
    for name, sub in named:
        if not sub.is_enabled():
            continue
        image = sub.image_path()
        if not image:
            problems.append(f"spec.{name}: no image (repository/image/version or env)")
        elif ":" not in image.rsplit("/", 1)[-1] and "@" not in image:
            problems.append(f"spec.{name}: image {image!r} has no tag or digest")
    if spec.slice.strategy not in ("none", "single", "mixed"):
        problems.append(f"spec.slice.strategy {spec.slice.strategy!r} invalid")
    if spec.sandbox_workloads.default_workload not in (
        "container",
        "vm-passthrough",
    ):
        problems.append(
            f"spec.sandboxWorkloads.defaultWorkload "
            f"{spec.sandbox_workloads.default_workload!r} invalid"
        )
    pol = spec.driver.upgrade_policy
    if pol is not None:
        mu = str(pol.max_unavailable)
        if mu.endswith("%"):
            try:
                float(mu[:-1])
            except ValueError:
                problems.append(f"upgradePolicy.maxUnavailable {mu!r} invalid")
        if pol.max_parallel_upgrades < 0:
            problems.append("upgradePolicy.maxParallelUpgrades negative")
    return problems


def validate_chart(chart_dir: str = DEFAULT_CHART_DIR) -> list:
    """The chart's values must decode as a ClusterPolicySpec and the CRD in
    crds/ must match the generated one."""
    import yaml

    problems = []
    values_path = os.path.join(chart_dir, "values.yaml")
    try:
        with open(values_path) as f:
            values = yaml.safe_load(f) or {}
    except OSError as e:
        return [f"cannot read {values_path}: {e}"]
    # chart values mirror the CR spec 1:1
    ClusterPolicySpec.from_dict(values)
    crd_path = os.path.join(chart_dir, "crds", "tpu.k8s.io_clusterpolicies.yaml")
    if not os.path.exists(crd_path):
        problems.append(f"missing CRD at {crd_path}")
    else:
        from tpu_operator_torch.cfg.crdgen import build_crd

        with open(crd_path) as f:
            on_disk = yaml.safe_load(f)
        if on_disk != build_crd():
            problems.append(f"{crd_path} is stale; regenerate with 'gpuop-cfg generate crd'")
    return problems


def main(argv=None) -> int:
    from tpu_operator_torch.cfg.release import CSV_NAME, DEFAULT_BUNDLE_DIR

    p = argparse.ArgumentParser("gpuop-cfg")
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate")
    vsub = v.add_subparsers(dest="what", required=True)
    vcp = vsub.add_parser("clusterpolicy")
    vcp.add_argument("--input", required=True)
    vch = vsub.add_parser("chart")
    vch.add_argument("--dir", default=DEFAULT_CHART_DIR)
    vcsv = vsub.add_parser("csv")
    vcsv.add_argument("--input", default=os.path.join(DEFAULT_BUNDLE_DIR, "manifests", CSV_NAME))
    vcsv.add_argument("--config-dir", default=DEFAULT_CONFIG_DIR)
    vb = vsub.add_parser("bundle")
    vb.add_argument("--dir", default=DEFAULT_BUNDLE_DIR)
    vb.add_argument("--config-dir", default=DEFAULT_CONFIG_DIR)
    g = sub.add_parser("generate")
    gsub = g.add_subparsers(dest="what", required=True)
    gsub.add_parser("crd")
    gcsv = gsub.add_parser("csv")
    gcsv.add_argument("--config-dir", default=DEFAULT_CONFIG_DIR)
    r = sub.add_parser("release")
    rsub = r.add_subparsers(dest="what", required=True)
    rb = rsub.add_parser("bundle")
    rb.add_argument("--version", required=True)
    rb.add_argument("--replaces", default="")
    rb.add_argument("--bundle-dir", default=DEFAULT_BUNDLE_DIR)
    rb.add_argument("--config-dir", default=DEFAULT_CONFIG_DIR)
    args = p.parse_args(argv)

    if args.cmd == "validate" and args.what == "clusterpolicy":
        problems = validate_clusterpolicy(args.input)
    elif args.cmd == "validate" and args.what == "chart":
        problems = validate_chart(args.dir)
    elif args.cmd == "validate" and args.what == "csv":
        from tpu_operator_torch.cfg.csvgen import validate_csv

        problems = validate_csv(args.input, config_dir=args.config_dir)
    elif args.cmd == "generate" and args.what == "crd":
        from tpu_operator_torch.cfg.crdgen import render_crd_yaml

        sys.stdout.write(render_crd_yaml())
        return 0
    elif args.cmd == "generate" and args.what == "csv":
        from tpu_operator_torch.cfg.csvgen import render_csv_yaml

        sys.stdout.write(render_csv_yaml(args.config_dir))
        return 0
    elif args.cmd == "validate" and args.what == "bundle":
        from tpu_operator_torch.cfg.release import validate_bundle_tree

        problems = validate_bundle_tree(args.dir, config_dir=args.config_dir)
    elif args.cmd == "release" and args.what == "bundle":
        from tpu_operator_torch.cfg.release import cut_release

        rel = cut_release(
            args.version,
            replaces=args.replaces,
            bundle_dir=args.bundle_dir,
            config_dir=args.config_dir,
        )
        print(f"release bundle written: {rel}")
        return 0
    else:  # pragma: no cover
        p.error("unknown command")
        return 2

    for prob in problems:
        print(f"INVALID: {prob}", file=sys.stderr)
    if problems:
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
