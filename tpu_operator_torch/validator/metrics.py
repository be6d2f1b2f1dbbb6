"""Validator metrics mode: the node-status exporter.

The counterpart of ``tpu_operator/validator/metrics.py`` (the reference's
``validator/metrics.go``): a Prometheus endpoint exporting per-node
readiness gauges by watching the status files (30 s), re-running the
driver validation (60 s), counting device-plugin resources (30 s) and
counting cards (60 s) (``validator/metrics.go:159-301``).

Each watcher is one pass that returns its value without
``prometheus_client`` (``status_pass``, ``driver_pass``,
``capacity_pass``, ``devices_pass``); ``run()`` creates the gauges and
loops over those passes.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.validator.components import (
    StatusFiles,
    find_driver_libraries,
    find_gpu_devices,
    node_gpu_capacity,
)

log = logging.getLogger("tpu-validator.metrics")

# one-release legacy-shape fallback noted once per process, not once per
# 30 s watch tick
_legacy_payload_logged = False

# the barrier chain's status files, each with its readiness gauge's name
READY_FILES = {
    consts.STATUS_FILE_DRIVER: "driver_ready",
    consts.STATUS_FILE_TOOLKIT: "toolkit_ready",
    consts.STATUS_FILE_PLUGIN: "plugin_ready",
    consts.STATUS_FILE_CUDA: "cuda_ready",
}


def payload_perf(payload) -> dict:
    """Canonical read of a validation status payload's performance
    fields. The schema is FLAT: ``{"tflops": x, ...}`` for the cuda
    payload and ``{"gbps": y, ...}`` for the membw payload. One release of
    fallback remains for the legacy nested ``{"result": {"tflops": ...}}``
    shape, logged once (reference ``:30``)."""
    global _legacy_payload_logged
    if not isinstance(payload, dict):
        return {}
    out = {}
    for key in ("tflops", "gbps"):
        value = payload.get(key)
        if value is None:
            nested = payload.get("result")
            if isinstance(nested, dict) and nested.get(key) is not None:
                value = nested[key]
                if not _legacy_payload_logged:
                    _legacy_payload_logged = True
                    log.warning(
                        "validation payload uses the legacy nested result.%s "
                        "shape; emit the flat canonical schema (top-level %s) "
                        "— this fallback is removed next release",
                        key,
                        key,
                    )
        if value is not None:
            try:
                out[key] = float(value)
            except (TypeError, ValueError):
                pass
    return out


class NodeMetrics:
    """reference ``NodeMetrics`` (``validator/metrics.go:52-70``)."""

    WATCH_STATUS_S = 30
    WATCH_PLUGIN_S = 30
    WATCH_DRIVER_S = 60
    WATCH_PCI_S = 60

    def __init__(
        self,
        client=None,
        node_name: str = "",
        status: StatusFiles = None,
        port: int = 8000,
        driver_root: str = consts.DRIVER_ROOT,
        dev_root: str = "/dev",
        registry=None,
    ):
        self.client = client
        self.node_name = node_name
        self.status = status or StatusFiles()
        self.port = port
        self.driver_root = driver_root
        self.dev_root = dev_root
        self.registry = registry  # None -> prometheus_client's default registry
        self._stop = threading.Event()
        self._server = None

    # -- one pass of each watcher -----------------------------------------
    def _read_payload(self, name: str) -> dict:
        try:
            with open(self.status.path(name)) as f:
                return payload_perf(json.load(f))
        except (OSError, ValueError):
            return {}

    def status_pass(self) -> dict:
        """Readiness of the barrier chain's status files and of each
        diagnostic probe (1 present, 0 absent), and the perf readings of
        the cuda and membw payloads, which go to the node's
        validator-perf annotation."""
        ready = {name: 1 if self.status.exists(name) else 0 for name in READY_FILES}
        probes = {
            name.removesuffix("-ready"): 1 if self.status.exists(name) else 0
            for name in consts.PROBE_STATUS_FILES
        }
        perf = self._read_payload(consts.STATUS_FILE_CUDA)
        cuda_tflops = perf.get("tflops")
        perf.update(self._read_payload(consts.STATUS_FILE_MEMBW))
        self._publish_perf_annotation(perf)
        return {"ready": ready, "probes": probes, "cuda_tflops": cuda_tflops, "perf": perf}

    def driver_pass(self) -> int:
        """Live re-validation: OPEN-probe every card node, not just stat
        it, and find ``libcuda`` under the driver root (the reference
        re-runs ``nvidia-smi`` through the driver chroot,
        ``validator/metrics.go:237-250``): a wedged card whose node still
        exists reads 0. An unexpected failure of the probe reads 0 too,
        and the watcher lives on."""
        try:
            devs = find_gpu_devices(self.dev_root)
            ok = (
                bool(devs)
                and all(gpuinfo.device_probe_path(p) for p in devs)
                and bool(find_driver_libraries(self.driver_root)["libcuda"])
            )
        except Exception:
            log.exception("driver re-validation pass failed")
            ok = False
        return 1 if ok else 0

    def capacity_pass(self) -> Optional[int]:
        """``nvidia.com/gpu`` (and MIG slices) in the node's capacity, or
        None without API access."""
        if self.client is None or not self.node_name:
            return None
        try:
            return node_gpu_capacity(self.client.get("v1", "Node", self.node_name))
        except Exception:
            log.exception("capacity watch failed")
            return None

    def devices_pass(self) -> int:
        """Cards on the host, from the chip table (NVML where the driver
        ships it); 0 when the count fails, towards unhealthy."""
        try:
            return gpuinfo.chip_count(self.dev_root)
        except Exception:
            log.exception("device count pass failed")
            return 0

    # -- the validator-perf annotation ------------------------------------
    def _publish_perf_annotation(self, perf: dict) -> None:
        """Publish the node's live validator perf readings as the
        ``tpu.k8s.io/validator-perf`` annotation, the evidence the rollout
        health gate compares against its pre-roll baseline. ``version``
        tags which driver produced the readings: ``DRIVER_VERSION`` where
        the deployment injects it, else the node's driver-version label,
        read inside the conflict-retried mutate so the tag matches the
        node revision the write lands on. One GET a tick, a write only on
        change."""
        if self.client is None or not self.node_name or not perf:
            return
        from tpu_operator_torch.kube.client import mutate_with_retry

        base = {k: round(v, 1) for k, v in sorted(perf.items())}
        env_version = os.environ.get("DRIVER_VERSION", "")

        def mutate(node):
            doc = dict(base)
            labels = node["metadata"].get("labels", {}) or {}
            version = env_version or labels.get(consts.DRIVER_VERSION_LABEL, "")
            if version:
                doc["version"] = version
            desired = json.dumps(doc, sort_keys=True)
            ann = node["metadata"].setdefault("annotations", {})
            if ann.get(consts.VALIDATOR_PERF_ANNOTATION) == desired:
                return False
            ann[consts.VALIDATOR_PERF_ANNOTATION] = desired
            return True

        try:
            mutate_with_retry(self.client, "v1", "Node", self.node_name, mutate=mutate)
        except Exception:
            log.exception("validator-perf annotation publish failed")

    # -- serving ------------------------------------------------------------
    def _watch(self, interval_s: float, publish) -> None:
        while not self._stop.is_set():
            publish()
            self._stop.wait(interval_s)

    def run(self, block: bool = True):
        """Create the gauges, serve them and start the four watchers
        (reference ``Run``, ``validator/metrics.go:304-320``)."""
        from prometheus_client import Gauge, start_http_server

        kw = {"registry": self.registry} if self.registry is not None else {}
        ns = "gpu_validator"
        node = self.node_name

        def mk(name, doc, labels=("node",)):
            return Gauge(f"{ns}_{name}", doc, list(labels), **kw)

        g_ready = {
            name: mk(gauge, f"{name} validation status file present")
            for name, gauge in READY_FILES.items()
        }
        g_tflops = mk("cuda_matmul_tflops", "TFLOPS recorded by the last cuda validation")
        # one labeled series per diagnostic probe; probes are opt-in, so 0
        # just means "not run on this node"
        g_probe = mk("probe_ready", "diagnostic probe status file present", ("node", "probe"))
        g_driver = mk("driver_validation", "live driver re-validation result")
        g_capacity = mk("gpu_capacity", f"{consts.GPU_RESOURCE} in node capacity")
        g_devices = mk("gpu_devices", "cards on the host")

        def publish_status():
            out = self.status_pass()
            for name, value in out["ready"].items():
                g_ready[name].labels(node=node).set(value)
            for probe, value in out["probes"].items():
                g_probe.labels(node=node, probe=probe).set(value)
            if out["cuda_tflops"]:
                g_tflops.labels(node=node).set(out["cuda_tflops"])

        def publish_capacity():
            value = self.capacity_pass()
            if value is not None:
                g_capacity.labels(node=node).set(value)

        self._server, _ = start_http_server(self.port, **kw)
        watchers = [
            (self.WATCH_STATUS_S, publish_status),
            (self.WATCH_DRIVER_S, lambda: g_driver.labels(node=node).set(self.driver_pass())),
            (self.WATCH_PLUGIN_S, publish_capacity),
            (self.WATCH_PCI_S, lambda: g_devices.labels(node=node).set(self.devices_pass())),
        ]
        for interval_s, publish in watchers:
            threading.Thread(target=self._watch, args=(interval_s, publish), daemon=True).start()
        log.info("node-status exporter serving :%d/metrics", self.port)
        if block:
            while not self._stop.is_set():
                time.sleep(1)

    def stop(self):
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
