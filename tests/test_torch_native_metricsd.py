"""The port's metrics hostengine (``native/csrc/gpu_metricsd.cpp``) against
the reference's (``native/tpu_metricsd.cpp``), both compiled with ``g++``
into a temporary directory, on the same side files (series names mapped
``tpu_`` -> ``gpu_``); the Python daemon's delegation to it; the exporter's
provenance through it; and the telemetry chain against ``bench.py``'s."""

import json
import os
import re
import signal
import subprocess
import time
import urllib.error
import urllib.request

import pytest

from test_torch_gpuinfo import _dev_tree
from test_torch_native import REPO, build_fixtures, reset_loaders
from tpu_operator_torch.exporter import exporter as ex
from tpu_operator_torch.metricsd import chain
from tpu_operator_torch.metricsd import daemon as port_daemon
from tpu_operator_torch.native import gpuinfo

# the reference's series -> the port's
SERIES = {
    "tpu_metricsd_chips": "gpu_metricsd_chips",
    "tpu_metricsd_collections_total": "gpu_metricsd_collections_total",
    "tpu_metricsd_last_collect_ts_seconds": "gpu_metricsd_last_collect_ts_seconds",
    "tpu_chip_present": "gpu_chip_present",
    "tpu_chip_numa_node": "gpu_chip_numa_node",
    "tpu_metricsd_sample_age_seconds": "gpu_metricsd_sample_age_seconds",
    "tpu_metricsd_sample_fresh": "gpu_metricsd_sample_fresh",
    "tpu_tensorcore_utilization_percent": "gpu_tensorcore_utilization_percent",
    "tpu_duty_cycle_percent": "gpu_duty_cycle_percent",
    "tpu_hbm_used_bytes": "gpu_memory_used_bytes",
    "tpu_hbm_total_bytes": "gpu_memory_total_bytes",
}
# series whose value is a clock or a count of passes: equal in presence only
TIMED = ("gpu_metricsd_collections_total", "gpu_metricsd_last_collect_ts_seconds",
         "gpu_metricsd_sample_age_seconds")
SAMPLE = {"tensorcore_util": 42.5, "duty_cycle": 99.0, "hbm_used": 123456.0, "hbm_total": 1.0e9}
WAIT_S = 5.0
# both hostengines showing a sample: a poll that returns as soon as they do,
# bounded for a loaded host (parallel test workers)
SETTLE_S = 60.0


@pytest.fixture(scope="module")
def progs(tmp_path_factory):
    return build_fixtures(tmp_path_factory.mktemp("native"), ["tpu_metricsd"])


@pytest.fixture
def roots(tmp_path):
    """Two cards each: the reference's accel nodes, the port's nvidia
    nodes (with the driver's control nodes beside them)."""
    return (_dev_tree(tmp_path / "ref_dev", ["accel0", "accel1"]),
            _dev_tree(tmp_path / "port_dev", ["nvidia0", "nvidia1", "nvidiactl", "nvidia-uvm"]))


def start(cmd, env=None):
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline()
    m = re.search(r"port (\d+)", line)
    assert m, f"no port line: {line!r}"
    return proc, int(m.group(1))


def stop(proc) -> float:
    """Seconds from SIGTERM to the process's exit."""
    if proc.poll() is not None:
        return 0.0
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=10)
    return time.monotonic() - t0


def port_cmd(progs, dev_root, tmp_path, *extra):
    return [progs.metricsd, "--dev-root", dev_root, "--proc-root", str(tmp_path / "proc"),
            "--sysfs", str(tmp_path / "sys"), *extra]


@pytest.fixture
def pair(progs, roots, tmp_path, monkeypatch):
    """Both hostengines running on one side file, NVML not answering."""
    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_down)
    sample = str(tmp_path / "sample.json")
    common = ["--port", "0", "--sample-file", sample, "--interval", "0.1"]
    ref, ref_port = start([progs.ref_tpu_metricsd, "--dev-root", roots[0], *common,
                           "--drop-file", str(tmp_path / "ref-drop.json")])
    port, port_port = start(port_cmd(progs, roots[1], tmp_path, *common,
                                     "--drop-file", str(tmp_path / "port-drop.json")))
    yield {"ref": ref_port, "port": port_port, "sample": sample, "port_proc": port}
    stop(ref)
    stop(port)


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read().decode()


def parse_prom(text: str, rename: bool = False) -> dict:
    """{(name, labels): value} of a Prometheus text, the reference's names
    renamed to the port's where ``rename``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name, _, labels = key.partition("{")
        out[(SERIES[name] if rename else name, labels.rstrip("}"))] = float(value)
    return out


def write_sample(path, payload):
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)


def settled(pair, want: str) -> tuple:
    """Both hostengines' /metrics once each shows ``want`` (or
    ``SETTLE_S`` has passed)."""
    deadline = time.time() + SETTLE_S
    while True:
        texts = get(pair["ref"], "/metrics"), get(pair["port"], "/metrics")
        if want in texts[0] and want.replace("tpu_", "gpu_") in texts[1] or time.time() > deadline:
            return texts
        time.sleep(0.05)


def assert_same_series(ref_text: str, port_text: str) -> None:
    ref, port = parse_prom(ref_text, rename=True), parse_prom(port_text)
    assert set(port) == set(ref)
    assert {k: v for k, v in port.items() if k[0] not in TIMED} == {
        k: v for k, v in ref.items() if k[0] not in TIMED}


def test_once_agrees_with_the_reference(progs, roots, tmp_path, monkeypatch):
    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_down)
    ref = subprocess.run([progs.ref_tpu_metricsd, "--dev-root", roots[0], "--once", "--drop-file",
                          str(tmp_path / "r.json")], capture_output=True, text=True, timeout=30)
    port = subprocess.run(port_cmd(progs, roots[1], tmp_path, "--once", "--drop-file",
                                   str(tmp_path / "p.json")), capture_output=True, text=True, timeout=30)
    assert port.returncode == ref.returncode == 0
    ref_snap, port_snap = json.loads(ref.stdout), json.loads(port.stdout)
    assert json.loads((tmp_path / "p.json").read_text()) == port_snap
    assert (ref_snap["source"], port_snap["source"]) == ("tpu-metricsd-native", "gpu-metricsd-native")
    assert port_snap["chip_count"] == ref_snap["chip_count"] == 2
    assert [c.pop("source") for c in port_snap["chips"]] == ["sysfs", "sysfs"]
    assert port_snap["chips"] == [
        {**c, "path": c["path"].replace(roots[0], roots[1]).replace("accel", "nvidia")}
        for c in ref_snap["chips"]]


def test_http_surface_and_sigterm(pair):
    for engine in ("ref", "port"):
        assert get(pair[engine], "/healthz") == "ok\n"
        assert json.loads(get(pair[engine], "/"))["chip_count"] == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            get(pair[engine], "/nope")
        assert e.value.code == 404
        req = urllib.request.Request(f"http://127.0.0.1:{pair[engine]}/json", data=b"x", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 405
    text = get(pair["port"], "/metrics")
    assert 'gpu_chip_present{chip="1",source="devfs"} 1' in text
    assert "gpu_metricsd_sample_fresh 0" in text and "tpu_" not in text
    assert stop(pair["port_proc"]) < 2.0
    assert pair["port_proc"].returncode == 0


@pytest.mark.parametrize(
    "chips",
    [
        [{"index": 0, "tensorcore_util": 87.5, "hbm_used": 2048}],
        # a key on one card only stays with that card
        [{"index": 0, "tensorcore_util": 50.0}, {"index": 1, "tensorcore_util": 60.0, "hbm_used": 200}],
        [{"tensorcore_util": 7.0}, {"index": 1, **SAMPLE}],  # an entry with no index: its position
    ],
)
def test_sample_merge_agrees_with_the_reference(pair, chips):
    payload = {"ts": time.time(), "chips": chips}
    write_sample(pair["sample"], payload)
    ref_text, port_text = settled(pair, "tpu_metricsd_sample_fresh 1")
    assert_same_series(ref_text, port_text)
    assert json.loads(get(pair["port"], "/json"))["sample"] == payload
    assert json.loads(get(pair["ref"], "/json"))["sample"] == payload
    if len(chips) == 2 and chips[1].get("hbm_used") == 200:
        assert 'gpu_memory_used_bytes{chip="1",source="sampler"} 200' in port_text
        assert 'gpu_memory_used_bytes{chip="0"' not in port_text


@pytest.mark.parametrize("stamp", ["stale", "unstamped"])
def test_the_age_gate_agrees_with_the_reference(pair, stamp):
    """A dead sampler reads as missing, not as its last value: a stale or
    unstamped side file is dropped from /json and /metrics alike; a fresh
    one revives the chain."""
    payload = {"chips": [{"index": 0, "tensorcore_util": 99.0}]}
    if stamp == "stale":
        payload["ts"] = time.time() - 3600
    write_sample(pair["sample"], payload)
    time.sleep(0.5)
    ref_text, port_text = settled(pair, "tpu_metricsd_sample_fresh 0")
    assert "gpu_metricsd_sample_fresh 0" in port_text
    assert "gpu_tensorcore_utilization_percent" not in port_text
    assert ("gpu_metricsd_sample_age_seconds" in port_text) == (stamp == "stale")
    assert_same_series(ref_text, port_text)
    assert "sample" not in json.loads(get(pair["port"], "/json"))
    write_sample(pair["sample"], {**payload, "ts": time.time()})
    _, port_text = settled(pair, "tpu_metricsd_sample_fresh 1")
    assert 'gpu_tensorcore_utilization_percent{chip="0",source="sampler"} 99' in port_text


@pytest.mark.parametrize("drop", ["drop-rel.json", "a/b/c/drop.json"])
def test_drop_file_agrees_with_the_reference(progs, roots, tmp_path, monkeypatch, drop):
    """A drop file with no directory part, and one whose directories are
    missing (made first), is published whole."""
    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_down)
    for engine, cmd in (("ref", [progs.ref_tpu_metricsd, "--dev-root", roots[0]]),
                        ("port", port_cmd(progs, roots[1], tmp_path))):
        cwd = tmp_path / engine
        cwd.mkdir()
        r = subprocess.run([*cmd, "--once", "--drop-file", drop], capture_output=True, text=True,
                           timeout=30, cwd=str(cwd))
        assert r.returncode == 0
        assert json.loads((cwd / drop).read_text())["chip_count"] == 2
        assert not (cwd / (drop + ".tmp")).exists()


def test_provenance_through_the_hostengine(progs, tmp_path, monkeypatch):
    """NVML's counters served inside the hostengine's chip entries keep
    their backend: the exporter labels them ``nvml``, not ``devfs`` (the
    hostengine's payload names itself, not its backend). The sampler's
    stay ``sampler``, the nameplate ``spec``, presence ``devfs``; the
    hostengine's own series take a card's counter from the sampler where
    it gave the key for that card, else from NVML."""
    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_ok)
    reset_loaders(monkeypatch)
    sample = str(tmp_path / "sample.json")
    write_sample(sample, {"ts": time.time(), "chips": [{"index": 5, "tensorcore_util": 30.0},
                                                       {"index": 1, "tensorcore_util": 31.0}]})
    proc, port = start(port_cmd(progs, "/dev", tmp_path, "--port", "0", "--sample-file", sample,
                                "--drop-file", str(tmp_path / "drop.json"), "--interval", "0.1"))
    try:
        chips = gpuinfo.chip_summary("/dev", str(tmp_path / "proc"), str(tmp_path / "sys"))
        data = ex.fetch_metricsd(f"127.0.0.1:{port}")
        assert [c["source"] for c in data["chips"]] == ["nvml", "nvml"]
        values, series = ex.collect_values(data, ex.DEFAULT_METRICS, chips)
        sources = {(k, c): s for (k, c, s), _ in series}
        assert sources[("duty_cycle", "5")] == sources[("hbm_used", "5")] == "nvml"
        assert sources[("temperature", "1")] == sources[("hbm_used", "1")] == "nvml"
        assert ("duty_cycle", "1") not in sources  # NVML did not answer card 1's utilization
        assert sources[("tensorcore_util", "5")] == sources[("tensorcore_util", "1")] == "sampler"
        assert sources[("present", "5")] == "devfs" and sources[("hbm_total", "5")] == "spec"
        assert values["5"]["duty_cycle"] == 37 and values["1"]["hbm_used"] == 2097152
        text = get(port, "/metrics")
        assert 'gpu_chip_present{chip="5",source="nvml"} 1' in text
        assert 'gpu_duty_cycle_percent{chip="5",source="nvml"} 37' in text
        assert 'gpu_memory_total_bytes{chip="1",source="nvml"} 85520809984' in text

        # the sampler's duty cycle for card 5 replaces NVML's there
        write_sample(sample, {"ts": time.time(), "chips": [{"index": 5, "duty_cycle": 88.0}]})
        deadline = time.time() + WAIT_S
        while 'source="sampler"} 88' not in text and time.time() < deadline:
            time.sleep(0.05)
            text = get(port, "/metrics")
        prom = parse_prom(text)
        assert prom[("gpu_duty_cycle_percent", 'chip="5",source="sampler"')] == 88.0
        assert ("gpu_duty_cycle_percent", 'chip="5",source="nvml"') not in prom
        _, series = ex.collect_values(ex.fetch_metricsd(f"127.0.0.1:{port}"), ex.DEFAULT_METRICS, chips)
        assert {(k, c): s for (k, c, s), _ in series}[("duty_cycle", "5")] == "sampler"
    finally:
        stop(proc)


def _main_cmd(monkeypatch, module, argv):
    """The command ``module.main(argv)`` hands to ``os.execv``, or None
    where it serves itself."""
    calls = []
    monkeypatch.setattr(os, "execv", lambda path, cmd: calls.append(cmd))
    monkeypatch.setattr(module.MetricsDaemon, "serve", lambda self, **kw: calls.append("serve"))
    monkeypatch.setattr(module.MetricsDaemon, "run_sampler", lambda self, f: calls.append("sampler"))
    module.main(argv)
    return calls[0]


@pytest.mark.parametrize("argv", [[], ["--port", "6000", "--dev-root", "/x", "--drop-file", "/d.json",
                                       "--sample-file", "/s.json", "--interval", "2.5"]])
def test_main_delegates_with_the_reference_arguments(progs, monkeypatch, tmp_path, argv):
    from tpu_operator.metricsd import daemon as ref_daemon

    monkeypatch.setenv("TPU_METRICSD_NATIVE", progs.ref_tpu_metricsd)
    monkeypatch.setenv("GPU_METRICSD_NATIVE", progs.metricsd)
    monkeypatch.delenv("METRICSD_PORT", raising=False)
    monkeypatch.delenv("METRICSD_SAMPLE_FILE", raising=False)
    ref = _main_cmd(monkeypatch, ref_daemon, argv)
    port = _main_cmd(monkeypatch, port_daemon, argv)
    assert port[0] == progs.metricsd and ref[0] == progs.ref_tpu_metricsd
    assert port[1:] == ref[1:]


@pytest.mark.parametrize("flag,serves", [("--no-native", "serve"), ("--own-chip", "serve"),
                                         ("--sampler-only", "sampler")])
def test_main_never_delegates_with(progs, monkeypatch, flag, serves):
    monkeypatch.setenv("GPU_METRICSD_NATIVE", progs.metricsd)
    import tpu_operator_torch.device as device

    monkeypatch.setattr(device, "resolve_device", lambda d: d)
    assert _main_cmd(monkeypatch, port_daemon, [flag]) == serves


def test_find_native_binary(progs, monkeypatch, tmp_path):
    """``GPU_METRICSD_NATIVE`` first, then the installed path, then the
    build directory of this source hash; a file that is not executable is
    no hostengine."""
    monkeypatch.setenv("GPU_METRICSD_NATIVE", progs.metricsd)
    assert port_daemon.find_native_binary() == progs.metricsd
    plain = tmp_path / "gpu_metricsd"
    plain.write_text("")
    monkeypatch.setenv("GPU_METRICSD_NATIVE", str(plain))
    monkeypatch.setattr(port_daemon, "INSTALLED_NATIVE", str(tmp_path / "absent"))
    monkeypatch.setattr(port_daemon.native_build, "BUILD_ROOT", tmp_path / "build")
    assert port_daemon.find_native_binary() is None
    monkeypatch.setattr(port_daemon.native_build, "BUILD_ROOT",
                        port_daemon.native_build.Path(os.path.dirname(os.path.dirname(progs.metricsd))))
    assert port_daemon.find_native_binary() == progs.metricsd


def test_telemetry_chain_agrees_with_the_bench(progs, monkeypatch, tmp_path):
    """The reference's sample through the port's chain gives the values
    ``bench.run_telemetry_chain`` gives (its hostengine built here from
    ``native/``, not the tracked ``native/out``), with each series'
    provenance; a chain with no hostengine is an error, not a traceback."""
    monkeypatch.syspath_prepend(REPO)
    import bench

    ref_repo = tmp_path / "ref_repo"
    (ref_repo / "native" / "out").mkdir(parents=True)
    os.symlink(progs.ref_tpu_metricsd, ref_repo / "native" / "out" / "tpu_metricsd")
    monkeypatch.setattr(bench, "REPO", str(ref_repo))
    ref = bench.run_telemetry_chain(dict(SAMPLE))
    assert ref["ok"], ref

    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_down)
    monkeypatch.setenv("GPU_METRICSD_NATIVE", progs.metricsd)
    reset_loaders(monkeypatch, progs.lib)
    dev = _dev_tree(tmp_path / "dev", ["nvidia0"])
    port = chain.run_telemetry_chain(dict(SAMPLE), dev_root=dev)
    assert port["ok"], port
    keys = [k for k in ref if k.endswith(("_percent", "_bytes"))]
    assert len(keys) == 6
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["tensorcore_util_percent"] == 42.5 and port["hbm_used_bytes"] == 123456.0
    assert set(port["sources"].values()) == set(port["native_sources"].values()) == {"sampler"}

    monkeypatch.setenv("GPU_METRICSD_NATIVE", str(tmp_path / "absent"))
    monkeypatch.setattr(port_daemon, "INSTALLED_NATIVE", str(tmp_path / "absent"))
    monkeypatch.setattr(port_daemon.native_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(chain.native_build, "find_cxx", lambda: str(tmp_path / "no-g++"))
    broken = chain.run_telemetry_chain(dict(SAMPLE), dev_root=dev)
    assert not broken["ok"] and "g++" in broken["error"]
