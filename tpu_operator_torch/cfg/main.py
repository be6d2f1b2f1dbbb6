"""``gpuop-cfg`` — config validation CLI (reference ``cmd/gpuop-cfg``).

    python -m tpu_operator_torch.cfg validate clusterpolicy --input FILE
    python -m tpu_operator_torch.cfg generate crd

The port's copy of ``tpu_operator/cfg/main.py``'s two subcommands that
need nothing but the CR and its schema:

  validate clusterpolicy --input FILE   schema admission, decode and
                                        image-resolution checks; rc 1 with
                                        one ``INVALID:`` line a problem
  generate crd                          print the CRD manifest

``validate chart|csv|bundle``, ``generate csv`` and ``release bundle``
need the port's own chart, ``config/`` and bundle, and wait for them.
"""

from __future__ import annotations

import argparse
import sys

from tpu_operator_torch.api.v1.clusterpolicy_types import clusterpolicy_from_obj


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser("gpuop-cfg")
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate")
    vsub = v.add_subparsers(dest="what", required=True)
    vcp = vsub.add_parser("clusterpolicy")
    vcp.add_argument("--input", required=True)
    g = sub.add_parser("generate")
    gsub = g.add_subparsers(dest="what", required=True)
    gsub.add_parser("crd")
    args = p.parse_args(argv)

    if args.cmd == "generate":
        from tpu_operator_torch.cfg.crdgen import render_crd_yaml

        sys.stdout.write(render_crd_yaml())
        return 0
    problems = validate_clusterpolicy(args.input)
    for prob in problems:
        print(f"INVALID: {prob}", file=sys.stderr)
    if problems:
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
