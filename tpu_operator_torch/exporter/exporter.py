"""The metrics exporter: the dcgm-exporter slot.

    python -m tpu_operator_torch.exporter --node-name <node> [--port 9400]

The counterpart of ``tpu_operator/exporter/exporter.py``. It exports each
card's telemetry as Prometheus series under the card's names (duty cycle,
memory in use and in all, tensor-core utilization, temperature, presence,
NVLink pairs), read from NVML through ``native/gpuinfo.py``, or from the
metrics daemon's ``/json`` where ``METRICSD_ENDPOINT`` names one. The keys
are the reference's, so a reference metrics-config file selects the same
series; NVML's counters map onto them:

  duty_cycle      ← ``utilization_gpu`` (the share of NVML's last sample
                    period in which a kernel ran)
  hbm_used        ← ``memory_used_bytes``
  temperature     ← ``temperature_c`` (the die's)
  hbm_total       ← ``topology.HBM_GB`` of the card's variant (a nameplate)
  ici_links       ← ``topology.nvlink_pair_count`` over the chip table
  tensorcore_util ← the metrics daemon's sampler only

Every series carries its provenance in a ``source`` label: ``nvml`` for
NVML's readings, also where the native hostengine serves them inside its
chip entries, ``devfs`` for facts that only prove presence (the chip
table's sysfs path), ``spec`` for nameplate values and ``sampler`` for the
card-owning sampler's. ``collect_values`` builds the values and the series
set without ``prometheus_client``, which only ``Exporter`` imports.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.workloads import topology as topo

log = logging.getLogger("gpu-metrics-exporter")

# metric key -> (prometheus name, help)
ALL_METRICS = {
    "duty_cycle": ("gpu_duty_cycle_percent", "Share of the last sample period a kernel ran, %"),
    "hbm_used": ("gpu_memory_used_bytes", "Device memory in use, bytes"),
    "hbm_total": ("gpu_memory_total_bytes", "Device memory capacity, bytes"),
    "tensorcore_util": ("gpu_tensorcore_utilization_percent", "Tensor-core utilization %"),
    "temperature": ("gpu_temperature_celsius", "Card temperature"),
    "present": ("gpu_present", "Card visible"),
    "ici_links": ("gpu_nvlink_pairs_total", "Card pairs NVLink joins on this host"),
}
DEFAULT_METRICS = list(ALL_METRICS)
# NVML's counter for each key it measures
NVML_KEYS = {
    "duty_cycle": "utilization_gpu",
    "hbm_used": "memory_used_bytes",
    "temperature": "temperature_c",
}
# keys only the card-owning sampler measures: the metrics daemon serves
# them flat in its chip entries, so their provenance is set by key
SAMPLER_KEYS = ("tensorcore_util",)

Series = Tuple[str, str, str]  # (key, chip, source)


def parse_metrics_config(text: str) -> List[str]:
    """Custom metrics selection: one key per line, '#' comments."""
    keys = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if line and line in ALL_METRICS:
            keys.append(line)
    return keys or list(DEFAULT_METRICS)


def fetch_metricsd(endpoint: str) -> Optional[dict]:
    """The metrics daemon's ``/json`` at ``endpoint`` (``host:port``), with
    the card-owning sampler's counters merged into each card's entry and
    marked ``sampler``; None where no daemon is named or it does not
    answer with cards."""
    if not endpoint:
        return None
    url = f"http://{endpoint}/json"
    try:
        with urllib.request.urlopen(url, timeout=3) as r:
            data = json.load(r)
        if not isinstance(data, dict) or not data.get("chips"):
            # up but empty (starting, wrong dev root) or a port squatter:
            # unusable, so NVML answers instead
            return None
        sample_by_idx = {
            c.get("index"): c
            for c in (data.get("sample", {}) or {}).get("chips", [])
            if isinstance(c, dict)
        }
        for chip in data.get("chips", []):
            chip.setdefault("present", 1)
            sources = chip.setdefault("_sources", {})
            sources.update({k: "sampler" for k in SAMPLER_KEYS if k in chip})
            extra = sample_by_idx.get(chip.get("index"))
            if extra:
                merged = {k: v for k, v in extra.items() if k != "index"}
                chip.update(merged)
                sources.update({k: "sampler" for k in merged})
        return data
    except Exception:
        log.debug("metricsd scrape failed (%s); reading NVML", url)
        return None


def collect_values(
    data: dict,
    enabled: List[str],
    chips: List[dict],
    generation: str = "",
    host_topology: str = "",
) -> Tuple[Dict[str, Dict[str, float]], List[Tuple[Series, float]]]:
    """One pass's values from a backend's ``data`` (``gpuinfo.metrics`` or
    the daemon's ``/json``): ``{chip: {key: value}}`` and the series with
    their values in the order they are set. ``chips`` is the chip table,
    for the nameplate series; ``generation`` defaults to the variant of
    its first card's name, ``host_topology`` (which gates ``ici_links``,
    as in the reference) to its NVLink domains."""
    backend_source = "nvml" if data.get("source") == "nvml" else "devfs"
    generation = generation or (topo.device_generation(chips[0].get("name", "")) if chips else "") or ""
    cards = {c["index"]: c for c in chips}
    host_topology = host_topology or topo.domain_topology(cards)
    out: Dict[str, Dict[str, float]] = {}
    series: List[Tuple[Series, float]] = []
    for chip in data.get("chips", []):
        cid = str(chip.get("index", 0))
        key_sources = chip.get("_sources", {}) or {}
        # the native hostengine embeds the chip table's entries, each naming
        # its backend; its payload's own source names the hostengine
        chip_source = "nvml" if chip.get("source") == "nvml" else backend_source
        values = {}
        for key in enabled:
            source = key_sources.get(key, chip_source)
            if key == "present":
                values[key] = float(chip.get("present", 1))
                source = key_sources.get(key, "devfs")
            elif key == "hbm_total" and generation:
                values[key] = float(topo.HBM_GB.get(generation, 0) * 2**30)
                source = "spec"  # nameplate, not a measurement
            elif key == "ici_links" and host_topology:
                values[key] = float(topo.nvlink_pair_count(cards))
                source = "spec"
            elif key in chip:
                values[key] = float(chip[key])
            elif NVML_KEYS.get(key) in chip:
                values[key] = float(chip[NVML_KEYS[key]])
            else:
                continue
            series.append(((key, cid, source), values[key]))
        out[cid] = values
    return out, series


class Exporter:
    def __init__(
        self,
        node_name: str = "",
        dev_root: str = "/dev",
        generation: str = "",
        host_topology: str = "",
        enabled_metrics: Optional[List[str]] = None,
        interval_s: float = 10.0,
        registry=None,
        metricsd_endpoint: str = "",
    ):
        from prometheus_client import Gauge

        self.node_name = node_name
        self.dev_root = dev_root
        self.metricsd_endpoint = metricsd_endpoint
        self.generation = generation
        self.host_topology = host_topology
        self.enabled = enabled_metrics or list(DEFAULT_METRICS)
        self.interval_s = interval_s
        self.registry = registry  # None -> the default global registry
        self._stop = threading.Event()
        self.gauges: Dict[str, object] = {}
        kw = {"registry": registry} if registry is not None else {}
        # (key, chip, source) children exported by the previous pass; a
        # child absent from the current pass is removed. That covers a
        # provenance flip (the sampler dies and another source re-emits the
        # key: ``sum by (node, chip)`` must not double-count) and a
        # sampler-only key that vanishes with the sampler
        self._last_series: set = set()
        for key in self.enabled:
            name, doc = ALL_METRICS[key]
            self.gauges[key] = Gauge(name, doc, ["node", "chip", "source"], **kw)

    def _fetch_metricsd(self) -> Optional[dict]:
        return fetch_metricsd(self.metricsd_endpoint)

    def collect_once(self) -> Dict[str, Dict[str, float]]:
        """One scrape of the metrics daemon (preferred) or NVML -> gauge
        updates. Returns {chip: {key: value}}."""
        chips = gpuinfo.chip_summary(self.dev_root)
        data = self._fetch_metricsd() or gpuinfo.metrics(self.dev_root, chips=chips)
        out, series = collect_values(data, self.enabled, chips, self.generation, self.host_topology)
        # prev_series is taken up front and _last_series grows as gauges
        # are set: a pass that raises midway keeps track of the children
        # it exported, or a later pass could leave them frozen
        prev_series = set(self._last_series)
        current_series: set = set()
        for (key, cid, source), value in series:
            # a provenance flip (same key and chip, new source) removes the
            # old child BEFORE the new one is set: a scrape must never see
            # both, or ``sum by (node, chip)`` double-counts
            for old in [s for s in self._last_series if s[:2] == (key, cid) and s[2] != source]:
                try:
                    self.gauges[key].remove(self.node_name, cid, old[2])
                except KeyError:
                    pass
                self._last_series.discard(old)
            current_series.add((key, cid, source))
            self._last_series.add((key, cid, source))
            self.gauges[key].labels(node=self.node_name, chip=cid, source=source).set(value)
        for stale in prev_series - current_series:
            # exported before and not this pass: drop it, so the scrape
            # shows what the backends measured now
            key, cid, source = stale
            try:
                self.gauges[key].remove(self.node_name, cid, source)
            except KeyError:
                pass
            self._last_series.discard(stale)
        return out

    def run(self, port: int = 9400, block: bool = True):
        from prometheus_client import start_http_server

        if self.registry is not None:
            server = start_http_server(port, registry=self.registry)
        else:
            server = start_http_server(port)
        log.info("gpu-metrics-exporter serving :%d/metrics", port)

        def loop():
            while not self._stop.is_set():
                try:
                    self.collect_once()
                except Exception:
                    log.exception("collection failed")
                self._stop.wait(self.interval_s)

        threading.Thread(target=loop, daemon=True).start()
        if block:
            while not self._stop.is_set():
                time.sleep(1)
        return server

    def stop(self):
        self._stop.set()


def main(argv=None) -> int:
    import argparse
    import os

    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-metrics-exporter")
    p.add_argument("--port", type=int, default=9400)
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument(
        "--metrics-config",
        default=os.environ.get("METRICS_CONFIG_FILE", ""),
        help="file selecting which metrics to emit",
    )
    args = p.parse_args(argv)

    enabled = None
    if args.metrics_config and os.path.exists(args.metrics_config):
        with open(args.metrics_config) as f:
            enabled = parse_metrics_config(f.read())

    Exporter(
        node_name=args.node_name,
        dev_root=args.dev_root,
        generation=os.environ.get("GPU_GENERATION", ""),
        host_topology=os.environ.get("TPU_TOPOLOGY", ""),
        enabled_metrics=enabled,
        interval_s=args.interval,
        metricsd_endpoint=os.environ.get("METRICSD_ENDPOINT", ""),
    ).run(port=args.port)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
