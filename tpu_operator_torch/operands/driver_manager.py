"""The driver manager: prepare a node before its driver is swapped.

    python -m tpu_operator_torch.operands.driver_manager uninstall_driver|preflight

The counterpart of ``tpu_operator/operands/libtpu_manager.py`` (NVIDIA's
k8s-driver-manager initContainer). Before the driver container replaces
the libraries, it clears the barrier files so the dependent DaemonSets
block again until validation passes, then evicts this node's pods that
request ``nvidia.com/gpu`` or a MIG slice (and those the drain selector
names), and waits for them to go.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from tpu_operator_torch import consts
from tpu_operator_torch.kube.eviction import evict_pods
from tpu_operator_torch.kube.selector import pod_requests_gpu
from tpu_operator_torch.validator.components import StatusFiles

log = logging.getLogger("gpu-driver-manager")

EVICTION_POLL_S = 2.0  # the pause between passes of the eviction wait
BARRIERS = (
    consts.STATUS_FILE_DRIVER,
    consts.STATUS_FILE_TOOLKIT,
    consts.STATUS_FILE_PLUGIN,
    consts.STATUS_FILE_CUDA,
    consts.STATUS_FILE_DRIVER_CTR,
)


def _matches_selector(pod: dict, selector: str) -> bool:
    """``k=v[,k=v...]`` label match (``DRAIN_POD_SELECTOR_LABEL``)."""
    labels = pod.get("metadata", {}).get("labels", {}) or {}
    for clause in selector.split(","):
        clause = clause.strip()
        if not clause:
            continue
        k, _, v = clause.partition("=")
        if labels.get(k.strip()) != v.strip():
            return False
    return True


def uninstall_gpu_driver(
    client,
    node_name: str,
    status: StatusFiles,
    force: bool = False,
    eviction_timeout_s: float = 300.0,
    evict: bool = True,
    pod_selector: str = "",
) -> int:
    # 1. clear the barriers, so the plugin, exporter and validator pods
    #    block again
    for name in BARRIERS:
        status.remove(name)

    if not evict:
        # ENABLE_AUTO_DRAIN=false: the admin owns eviction; only the
        # barriers were cleared
        log.warning("auto-drain disabled; not evicting GPU pods")
        return 0
    if client is None or not node_name:
        return 0

    # 2. evict the GPU pods still holding the cards, and the pods the
    #    drain selector names
    def pods_to_evict():
        return [
            pod
            for pod in client.list("v1", "Pod")
            if pod.get("spec", {}).get("nodeName") == node_name
            and (pod_requests_gpu(pod) or (pod_selector and _matches_selector(pod, pod_selector)))
        ]

    pods = pods_to_evict()
    if not pods:
        return 0
    log.info("evicting %d GPU pods from %s", len(pods), node_name)
    evict_pods(client, pods, force=force)
    # a graceful delete leaves a pod listed, with a deletionTimestamp, for
    # its grace period: wait for it to go, since it maps the old libraries.
    # A pod with no deletionTimestamp is unmanaged (left alone: without
    # force that is final) or a managed pod a controller recreated since
    # the last pass (evicted again)
    deadline = time.monotonic() + eviction_timeout_s
    while True:
        pods_now = pods_to_evict()
        if not pods_now:
            return 0
        undeleted = [p for p in pods_now if not p["metadata"].get("deletionTimestamp")]
        if undeleted:
            stuck = [p for p in undeleted if not force and not p["metadata"].get("ownerReferences")]
            if stuck:
                log.error("%d unmanaged GPU pods not evictable (set DRAIN_USE_FORCE)", len(stuck))
                return 1
            evict_pods(client, undeleted, force=force)
        if time.monotonic() >= deadline:
            log.error("%d GPU pods still terminating after %.0fs", len(pods_now), eviction_timeout_s)
            return 1
        time.sleep(EVICTION_POLL_S)


def main(argv=None) -> int:
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-driver-manager")
    p.add_argument("command", choices=["uninstall_driver", "preflight"])
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument(
        "--output-dir", default=os.environ.get("VALIDATION_OUTPUT_DIR", consts.VALIDATION_DIR)
    )
    p.add_argument(
        "--force", action="store_true", default=os.environ.get("DRAIN_USE_FORCE", "") == "true"
    )
    p.add_argument(
        "--timeout-seconds", type=float, default=float(os.environ.get("DRAIN_TIMEOUT_SECONDS", "300"))
    )
    p.add_argument("--pod-selector", default=os.environ.get("DRAIN_POD_SELECTOR_LABEL", ""))
    p.add_argument(
        "--no-evict",
        action="store_true",
        default=os.environ.get("ENABLE_AUTO_DRAIN", "true") == "false",
    )
    args = p.parse_args(argv)

    if args.command == "preflight":
        # nothing to prepare for the user-space install (no kernel build)
        return 0
    client = None
    try:
        from tpu_operator_torch.kube.incluster import InClusterClient

        client = InClusterClient()
    except FileNotFoundError:
        log.warning("no in-cluster client; skipping pod eviction")
    return uninstall_gpu_driver(
        client,
        args.node_name,
        StatusFiles(args.output_dir),
        force=args.force,
        eviction_timeout_s=args.timeout_seconds,
        evict=not args.no_evict,
        pod_selector=args.pod_selector,
    )


if __name__ == "__main__":
    sys.exit(main())
