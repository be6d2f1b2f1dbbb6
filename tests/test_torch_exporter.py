"""The port's metrics exporter (``exporter/exporter.py``) against the
reference's on one fixture (``tests/test_discovery_exporter_sliceman.py:
106-137``, ``:345-402``): the same devfs tree with names mapped
``accelN`` ↔ ``nvidiaN``, the same scrapes of the metrics daemon, the same
metrics-config text.

Equal by design: the keys a config selects, the cards and keys each pass
exports, presence as ``devfs``, nameplate values as ``spec``, a
provenance flip removed before the new child is set, a vanished key
dropped. Different by design: the series' names (``gpu_*`` for ``tpu_*``),
NVML's readings as ``nvml`` (the reference's hostengine is ``sysfs``), the
nameplate values (80 GiB and NVLink pairs for 16 GiB and ICI links), and
the daemon's flat ``tensorcore_util`` as ``sampler`` (only the sampler
measures it)."""

import ctypes
import json
import os
import re
import socket
import subprocess
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from prometheus_client import CollectorRegistry, generate_latest

from tpu_operator.exporter import exporter as ref_ex
from tpu_operator.metricsd import daemon as ref_daemon
from tpu_operator.native import tpuinfo
from tpu_operator_torch.exporter import exporter as ex
from tpu_operator_torch.metricsd import daemon
from tpu_operator_torch.native import gpuinfo

NAMES = {ref_ex.ALL_METRICS[k][0]: ex.ALL_METRICS[k][0] for k in ex.ALL_METRICS}


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


@pytest.fixture()
def dev_roots(tmp_path):
    roots = []
    for side, prefix in (("r", "accel"), ("p", "nvidia")):
        d = tmp_path / side / "dev"
        d.mkdir(parents=True)
        for i in range(4):
            (d / f"{prefix}{i}").touch()
        roots.append(str(d))
    return roots


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _series(registry):
    """{(name, chip, source): value} of every exported child."""
    out = {}
    for line in generate_latest(registry).decode().splitlines():
        m = re.fullmatch(r'(\w+)\{chip="(\w+)",node="n1",source="(\w+)"\} (\S+)', line)
        if m:
            out[m.group(1), m.group(2), m.group(3)] = float(m.group(4))
    return out


def _mapped(series, sources=None):
    sources = sources or {}
    return {(NAMES[n], c, sources.get(s, s)): v for (n, c, s), v in series.items()}


def test_collect_matches_the_reference(dev_roots):
    ref_reg, reg = CollectorRegistry(), CollectorRegistry()
    theirs = ref_ex.Exporter(node_name="n1", dev_root=dev_roots[0], generation="v5e",
                             host_topology="2x4", registry=ref_reg).collect_once()
    mine = ex.Exporter(node_name="n1", dev_root=dev_roots[1], generation="h100-sxm",
                       registry=reg).collect_once()
    assert len(mine) == len(theirs) == 4
    assert {c: sorted(v) for c, v in mine.items()} == {c: sorted(v) for c, v in theirs.items()}
    assert mine["0"]["present"] == theirs["0"]["present"] == 1.0
    assert (theirs["0"]["hbm_total"], mine["0"]["hbm_total"]) == (16 * 2**30, 80 * 2**30)
    assert (theirs["0"]["ici_links"], mine["0"]["ici_links"]) == (10.0, 6.0)  # 2x4 mesh; 4 cards' pairs
    series = _series(reg)
    assert set(series) == set(_mapped(_series(ref_reg)))
    assert series["gpu_present", "0", "devfs"] == 1.0
    assert series["gpu_memory_total_bytes", "3", "spec"] == 80 * 2**30
    assert series["gpu_nvlink_pairs_total", "3", "spec"] == 6.0


@pytest.mark.parametrize(
    "text",
    ["duty_cycle\n# comment\nhbm_used\n", "bogus\n", "", "  temperature  # the die\nici_links\nnope\n",
     "\n".join(ex.ALL_METRICS)],
)
def test_metrics_config_parsing_matches_the_reference(text):
    assert ex.parse_metrics_config(text) == ref_ex.parse_metrics_config(text)
    assert list(ex.ALL_METRICS) == list(ref_ex.ALL_METRICS) == ex.DEFAULT_METRICS


def _both(dev_roots, enabled, monkeypatch, scrapes):
    """Run each scrape (a metricsd answer, or None and the backend's data)
    through both exporters; returns each one's series after each scrape."""
    ref_reg, reg = CollectorRegistry(), CollectorRegistry()
    ref_exp = ref_ex.Exporter(node_name="n1", dev_root=dev_roots[0], enabled_metrics=enabled,
                              registry=ref_reg)
    exp = ex.Exporter(node_name="n1", dev_root=dev_roots[1], enabled_metrics=enabled, registry=reg)
    out = []
    for metricsd, ref_backend, backend in scrapes:
        ref_exp._fetch_metricsd = lambda m=metricsd: json.loads(json.dumps(m)) if m else None
        exp._fetch_metricsd = lambda m=metricsd: json.loads(json.dumps(m)) if m else None
        monkeypatch.setattr(tpuinfo, "metrics", lambda d, b=ref_backend: b)
        monkeypatch.setattr(gpuinfo, "metrics", lambda d, chips=None, b=backend: b)
        ref_exp.collect_once()
        exp.collect_once()
        out.append((_series(ref_reg), _series(reg)))
    return out


SAMPLER = {"chips": [{"index": 0, "duty_cycle": 83.0, "tensorcore_util": 96.0,
                      "_sources": {"duty_cycle": "sampler", "tensorcore_util": "sampler"}}]}


def test_source_flip_removes_the_stale_series_as_the_reference(dev_roots, monkeypatch):
    """The sampler dies and the backend answers the same key: the sampler's
    child is removed, never left beside the new one."""
    (ref1, mine1), (ref2, mine2) = _both(dev_roots, ["duty_cycle"], monkeypatch, [
        (SAMPLER, None, None),
        (None, {"source": "fallback", "chips": [{"index": 0, "duty_cycle": 5.0}]},
         {"source": "sysfs", "chips": [{"index": 0, "duty_cycle": 5.0}]}),
    ])
    assert mine1 == _mapped(ref1) == {("gpu_duty_cycle_percent", "0", "sampler"): 83.0}
    assert mine2 == _mapped(ref2) == {("gpu_duty_cycle_percent", "0", "devfs"): 5.0}


def test_source_flip_to_nvml(dev_roots, monkeypatch):
    """NVML's reading replaces the sampler's under ``nvml`` (the
    reference's hostengine answers as ``sysfs``)."""
    (_, _), (ref2, mine2) = _both(dev_roots, ["duty_cycle"], monkeypatch, [
        (SAMPLER, None, None),
        (None, {"source": "libtpuinfo", "chips": [{"index": 0, "duty_cycle": 5.0}]},
         {"source": "nvml", "chips": [{"index": 0, "present": 1, "utilization_gpu": 5}]}),
    ])
    assert mine2 == _mapped(ref2, {"sysfs": "nvml"}) == {("gpu_duty_cycle_percent", "0", "nvml"): 5.0}


def test_vanished_sampler_key_is_removed_as_the_reference(dev_roots, monkeypatch):
    (ref1, mine1), (ref2, mine2) = _both(dev_roots, ["duty_cycle", "tensorcore_util"], monkeypatch, [
        (SAMPLER, None, None),
        (None, {"source": "fallback", "chips": [{"index": 0, "duty_cycle": 5.0}]},
         {"source": "sysfs", "chips": [{"index": 0, "duty_cycle": 5.0}]}),
    ])
    assert mine1 == _mapped(ref1)
    assert ("gpu_tensorcore_utilization_percent", "0", "sampler") in mine1
    assert mine2 == _mapped(ref2) == {("gpu_duty_cycle_percent", "0", "devfs"): 5.0}


def test_a_pass_that_raises_keeps_track_of_what_it_set(dev_roots, monkeypatch):
    """The partial-pass bookkeeping: a pass that fails while building its
    values sets no gauge, and the previous pass's children are still
    removed by a later pass that no longer produces them."""
    reg = CollectorRegistry()
    exp = ex.Exporter(node_name="n1", dev_root=dev_roots[1], enabled_metrics=["duty_cycle"],
                      registry=reg)
    exp._fetch_metricsd = lambda: {"chips": [{"index": 0, "duty_cycle": 1.0}]}
    exp.collect_once()
    exp._fetch_metricsd = lambda: {"chips": [{"index": 0, "duty_cycle": 2.0},
                                             {"index": 1, "duty_cycle": "broken"}]}
    with pytest.raises(ValueError):
        exp.collect_once()
    assert _series(reg) == {("gpu_duty_cycle_percent", "0", "devfs"): 1.0}
    exp._fetch_metricsd = lambda: None
    monkeypatch.setattr(gpuinfo, "metrics", lambda d, chips=None: {"source": "nvml", "chips": []})
    assert exp.collect_once() == {}
    assert _series(reg) == {}


class _FakeNvml:
    """A libnvidia-ml.so.1 stand-in with counters: ``cards`` are (minor,
    util %, used bytes, temperature or None for NOT_SUPPORTED)."""

    def __init__(self, cards):
        def card(h):
            return cards[h.value - 1]

        def handle(i, out):
            out._obj.value = i + 1
            return 0

        def set_value(value):
            def entry(h, out):
                out._obj.value = value(card(h))
                return 0
            return entry

        def name(h, buf, n):
            buf.value = b"NVIDIA H100 80GB HBM3"
            return 0

        def memory(h, out):
            out._obj.total, out._obj.used = 85520809984, card(h)[2]
            out._obj.free = out._obj.total - out._obj.used
            return 0

        def util(h, out):
            out._obj.gpu, out._obj.memory = card(h)[1], 0
            return 0

        def temperature(h, sensor, out):
            assert sensor == gpuinfo.NVML_TEMPERATURE_GPU
            if card(h)[3] is None:
                return 3
            out._obj.value = card(h)[3]
            return 0

        def count(out):
            out._obj.value = len(cards)
            return 0

        self.nvmlInit_v2 = self.nvmlShutdown = lambda: 0
        self.nvmlErrorString = lambda rc: b"Not Supported"
        self.nvmlDeviceGetCount_v2 = count
        self.nvmlDeviceGetHandleByIndex_v2 = handle
        self.nvmlDeviceGetName = name
        self.nvmlDeviceGetUUID = lambda h, buf, n: 3
        self.nvmlDeviceGetMinorNumber = set_value(lambda c: c[0])
        self.nvmlDeviceGetPciInfo_v3 = lambda h, out: 3
        self.nvmlDeviceGetPowerManagementLimit = set_value(lambda c: 700000)
        self.nvmlDeviceGetMemoryInfo = memory
        self.nvmlDeviceGetUtilizationRates = util
        self.nvmlDeviceGetTemperature = temperature
        self.nvmlDeviceGetMigMode = lambda h, cur, pend: 3


def test_exporter_over_nvml(monkeypatch, tmp_path):
    """NVML's counters on the reference's keys under ``nvml``; a card whose
    temperature NVML does not support has no temperature series; memory
    in all and NVLink pairs from the variant of NVML's name, as ``spec``;
    the chip label is the minor number."""
    lib = _FakeNvml([(5, 37, 2 * 2**30, 41), (3, 0, 512 * 2**20, None)])
    monkeypatch.setattr(gpuinfo, "_load", lambda: lib)
    reg = CollectorRegistry()
    values = ex.Exporter(node_name="n1", dev_root=str(tmp_path), registry=reg).collect_once()
    assert values == {
        "3": {"duty_cycle": 0.0, "hbm_used": float(512 * 2**20), "hbm_total": float(80 * 2**30),
              "present": 1.0, "ici_links": 1.0},
        "5": {"duty_cycle": 37.0, "hbm_used": float(2 * 2**30), "hbm_total": float(80 * 2**30),
              "temperature": 41.0, "present": 1.0, "ici_links": 1.0},
    }
    series = _series(reg)
    assert series["gpu_duty_cycle_percent", "5", "nvml"] == 37.0
    assert series["gpu_temperature_celsius", "5", "nvml"] == 41.0
    assert not any(k[0] == "gpu_temperature_celsius" and k[1] == "3" for k in series)
    assert series["gpu_memory_used_bytes", "3", "nvml"] == 512 * 2**20
    assert {s for (_, _, s) in series} == {"nvml", "spec", "devfs"}
    assert gpuinfo.chip_summary(str(tmp_path))[1]["temperature_c"] == 41


def test_generation_from_the_environment_or_the_name():
    chips = [{"index": 0, "name": "NVIDIA H100 NVL"}]
    data = {"source": "nvml", "chips": [{"index": 0, "present": 1}]}
    out, _ = ex.collect_values(data, ["hbm_total"], chips)
    assert out["0"]["hbm_total"] == 94 * 2**30  # derived: h100-nvl
    out, _ = ex.collect_values(data, ["hbm_total"], chips, generation="h100-pcie")
    assert out["0"]["hbm_total"] == 80 * 2**30
    out, _ = ex.collect_values(data, ["hbm_total", "ici_links"], [{"index": 0, "name": "A100"}])
    assert out == {"0": {"ici_links": 0.0}}  # no variant: no memory nameplate; one card, no pair
    out, series = ex.collect_values(data, ["hbm_total", "ici_links"], [])
    assert out == {"0": {}} and series == []  # no chip table: no topology, no nameplate


def _serve_json(payload):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.parametrize(
    "payload",
    [
        {"source": "hostengine", "chips": [{"index": 0}, {"index": 1, "present": 0}],
         "sample": {"chips": [{"index": 1, "tensorcore_util": 42.0, "duty_cycle": 7.0}, "junk"]}},
        {"source": "hostengine", "chips": []},
        ["not", "a", "dict"],
    ],
)
def test_fetch_metricsd_merges_the_sample_as_the_reference(dev_roots, payload):
    srv = _serve_json(payload)
    try:
        endpoint = f"127.0.0.1:{srv.server_address[1]}"
        theirs = ref_ex.Exporter(dev_root=dev_roots[0], registry=CollectorRegistry(),
                                 metricsd_endpoint=endpoint)._fetch_metricsd()
        mine = ex.Exporter(dev_root=dev_roots[1], registry=CollectorRegistry(),
                           metricsd_endpoint=endpoint)._fetch_metricsd()
    finally:
        srv.shutdown()
        srv.server_close()
    for chip in (mine or {}).get("chips", []):
        chip["_sources"] = chip.get("_sources") or None  # the port sets an empty map too
    for chip in (theirs or {}).get("chips", []):
        chip.setdefault("_sources", None)
    assert mine == theirs
    assert ex.Exporter(registry=CollectorRegistry(), metricsd_endpoint="")._fetch_metricsd() is None


def test_exporter_through_the_port_daemon(dev_roots, tmp_path):
    """The port's metrics daemon serving a sampler's side file: its
    ``tensorcore_util`` is exported as ``sampler``. The reference's daemon
    serves the same flat entry and its exporter labels it with the
    backend's ``sysfs``."""
    sample = tmp_path / "sample.json"
    sample.write_text(json.dumps({"ts": 0, "chips": [{"index": i, "tensorcore_util": 12.5}
                                                     for i in range(4)]}))
    results = []
    for side, (dmod, emod, root) in enumerate(((ref_daemon, ref_ex, dev_roots[0]),
                                               (daemon, ex, dev_roots[1]))):
        d = dmod.MetricsDaemon(dev_root=root, drop_file=str(tmp_path / f"drop{side}.json"),
                               sample_file=str(sample), interval_s=3600)
        port = _free_port()
        d.collect_once()
        server = d.serve(port=port, block=False)
        try:
            reg = CollectorRegistry()
            values = emod.Exporter(node_name="n1", dev_root=root, registry=reg,
                                   enabled_metrics=["tensorcore_util", "present"],
                                   metricsd_endpoint=f"127.0.0.1:{port}").collect_once()
            results.append((values, _series(reg)))
        finally:
            d.stop()
            server.shutdown()
            server.server_close()
    (ref_values, ref_series), (values, series) = results
    assert values == ref_values
    assert values["2"] == {"tensorcore_util": 12.5, "present": 1.0}
    assert series == _mapped(ref_series, {"sysfs": "sampler"})
    assert series["gpu_tensorcore_utilization_percent", "3", "sampler"] == 12.5
    assert series["gpu_present", "3", "devfs"] == 1.0


def test_run_serves_the_gpu_series(dev_roots):
    reg = CollectorRegistry()
    exp = ex.Exporter(node_name="n1", dev_root=dev_roots[1], registry=reg, interval_s=0.05)
    port = _free_port()
    served = exp.run(port=port, block=False)
    try:
        text = ""
        for _ in range(100):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                text = r.read().decode()
            if "gpu_present{" in text:
                break
            threading.Event().wait(0.05)
        assert 'gpu_present{chip="0",node="n1",source="devfs"} 1.0' in text
        assert "tpu_" not in text
    finally:
        exp.stop()
        if isinstance(served, tuple):
            served[0].shutdown()
            served[0].server_close()


def test_values_need_no_prometheus_client():
    code = """
import sys
for name in ("prometheus_client", "yaml", "torch"):
    sys.modules[name] = None
from tpu_operator_torch.exporter import exporter as ex
out, series = ex.collect_values({"source": "nvml", "chips": [{"index": 7, "utilization_gpu": 3}]},
                                ex.DEFAULT_METRICS, [{"index": 7, "name": "NVIDIA H100 PCIe"}])
print(out["7"]["duty_cycle"], out["7"]["hbm_total"], sorted({s for (_, _, s), _ in series}))
try:
    ex.Exporter()
except ImportError:
    print("no prometheus_client")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == [f"3.0 {float(80 * 2**30)} ['devfs', 'nvml', 'spec']",
                                          "no prometheus_client"]


def test_nvml_temperature_and_mig_mode_are_declared():
    args, restype = gpuinfo.NVML_SIGNATURES["nvmlDeviceGetTemperature"]
    assert args[1] is ctypes.c_int and restype is ctypes.c_int
    assert len(gpuinfo.NVML_SIGNATURES["nvmlDeviceGetMigMode"][0]) == 3
