"""The telemetry chain: sampler side-file -> native hostengine -> exporter.

The counterpart of ``bench.py``'s ``run_telemetry_chain`` (with
``_drive_chain``), as a function: ``sample`` holds counters the caller (the
card's owner) measured; it goes into a side file for every card of the chip
table, the C++ hostengine (``native/csrc/gpu_metricsd.cpp``) merges it and
serves ``/json`` and ``/metrics``, and the exporter scrapes the hostengine
over ``METRICSD_ENDPOINT``'s path into rendered Prometheus series. The
result has the reference's keys, read from the port's series names, with
each series' ``source`` label beside it.

A broken chain is an ``error`` in the result, never a traceback, and a
wedged hostengine is killed, not leaked. The devices are ``dev_root``'s
(the host's ``/dev`` by default): the reference's stand-in device node was
there only because its host had none.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import tempfile
import time
import urllib.request
from typing import Optional, Tuple

from tpu_operator_torch.metricsd.daemon import find_native_binary
from tpu_operator_torch.native import build as native_build
from tpu_operator_torch.native import gpuinfo

CHAIN = "sampler->hostengine->exporter"
# result key -> the series it reads
SERIES = {
    "tensorcore_util_percent": "gpu_tensorcore_utilization_percent",
    "duty_cycle_percent": "gpu_duty_cycle_percent",
    "hbm_used_bytes": "gpu_memory_used_bytes",
}
SERVE_TIMEOUT_S = 10.0
STOP_TIMEOUT_S = 5.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def series_value(text: str, name: str) -> Tuple[float, Optional[str]]:
    """(value, ``source`` label) of the first sample of ``name`` in a
    Prometheus text; (0.0, None) where there is none."""
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            labels = line[len(name):].rsplit(" ", 1)[0]
            source = None
            if 'source="' in labels:
                source = labels.split('source="', 1)[1].split('"', 1)[0]
            return float(line.rsplit(" ", 1)[1]), source
    return 0.0, None


def run_telemetry_chain(sample: dict, dev_root: str = "/dev") -> dict:
    """One pass of the chain with ``sample`` (sampler keys:
    ``tensorcore_util``, ``duty_cycle``, ``hbm_used``, ``hbm_total``).
    ``ok`` when every series reads above zero through both the hostengine's
    ``/metrics`` and the exporter's render; ``sources`` and
    ``native_sources`` give each series' ``source`` label."""
    out = {"ok": False, "chain": CHAIN}
    try:
        native = find_native_binary()
        if native is None:
            native_build.build()
            native = find_native_binary()
        chips = gpuinfo.chip_summary(dev_root)
    except Exception as e:  # the one-result contract: no traceback
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    if native is None:
        out["error"] = "native hostengine not built"
        return out

    tmp = tempfile.mkdtemp(prefix="gpu-telemetry-")
    sample_file = os.path.join(tmp, "sample.json")
    with open(sample_file, "w") as f:
        json.dump({"ts": time.time(),
                   "chips": [dict(sample, index=c["index"]) for c in chips] or [dict(sample, index=0)]}, f)
    port = _free_port()
    proc = subprocess.Popen(
        [native, "--port", str(port), "--dev-root", dev_root, "--sample-file", sample_file,
         "--drop-file", os.path.join(tmp, "drop.json"), "--interval", "0.2"],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    try:
        return _drive_chain(port, dev_root, out)
    except Exception as e:  # the one-result contract: no traceback
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=STOP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()  # wedged: killed, not leaked with its port
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _drive_chain(port: int, dev_root: str, out: dict) -> dict:
    # 1) the hostengine merged the side-file
    deadline = time.time() + SERVE_TIMEOUT_S
    data = None
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/json", timeout=2) as r:
                data = json.load(r)
            if data.get("chips") and data.get("sample"):
                break
        except OSError:
            pass
        time.sleep(0.2)
    if not data or not data.get("sample"):
        out["error"] = "hostengine never served the merged sample"
        return out

    # 2) the hostengine's own /metrics text
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
        native_prom = r.read().decode()

    # 3) the exporter (the dcgm-exporter slot) scrapes the hostengine and
    # renders Prometheus series
    from prometheus_client import CollectorRegistry, generate_latest

    from tpu_operator_torch.exporter.exporter import Exporter

    registry = CollectorRegistry()
    exporter = Exporter(node_name="chain", dev_root=dev_root,
                        metricsd_endpoint=f"127.0.0.1:{port}", registry=registry)
    exporter.collect_once()
    rendered = generate_latest(registry).decode()

    out["sources"], out["native_sources"] = {}, {}
    for key, name in SERIES.items():
        out[key], out["sources"][key] = series_value(rendered, name)
        out["native_" + key], out["native_sources"][key] = series_value(native_prom, name)
    # end to end: above zero all the way through both serving paths
    out["ok"] = all(out[k] > 0 and out["native_" + k] > 0 for k in SERIES)
    if not out["ok"]:
        out["error"] = "a telemetry series rendered zero"
    return out
