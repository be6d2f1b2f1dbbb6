"""The port's metrics daemon (``metricsd/daemon.py``) against the
reference's on the same fixtures: collection, the drop file, the side-file
merge and the HTTP endpoint (``tests/test_metricsd.py:30-55``); the duty
cycle read against the card's own peak where the reference divides by
v5e's; and no sampling without the card."""

import json
import socket
import subprocess
import sys
import urllib.request

import pytest
import torch

from tpu_operator.metricsd import daemon as ref
from tpu_operator.native import tpuinfo
from tpu_operator_torch.metricsd import daemon
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.workloads.topology import PEAK_BF16_TFLOPS


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


@pytest.fixture()
def dev_roots(tmp_path):
    roots = []
    for side, prefix in (("ref", "accel"), ("port", "nvidia")):
        d = tmp_path / side / "dev"
        d.mkdir(parents=True)
        for i in (0, 1, 4):
            (d / f"{prefix}{i}").touch()
        roots.append(str(d))
    (tmp_path / "port" / "dev" / "nvidiactl").touch()
    return roots


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _strip(payload):
    return {k: v for k, v in payload.items() if k not in ("ts", "source")}


def test_collect_and_drop_file_match_the_reference(tmp_path, dev_roots):
    outs = []
    for mod, root, name in ((ref, dev_roots[0], "ref"), (daemon, dev_roots[1], "port")):
        drop = tmp_path / name / "run" / "metricsd.json"
        out = mod.MetricsDaemon(dev_root=root, drop_file=str(drop)).collect_once()
        assert json.loads(drop.read_text()) == out
        outs.append(out)
    assert _strip(outs[1]) == _strip(outs[0])
    assert outs[1]["chips"] == [{"index": i, "present": 1} for i in (0, 1, 4)]
    assert (outs[0]["source"], outs[1]["source"]) == ("tpu-metricsd", "gpu-metricsd")


def test_side_file_merge_matches_the_reference(tmp_path, dev_roots):
    side = tmp_path / "sample.json"
    side.write_text(json.dumps({"chips": [{"index": 1, "tensorcore_util": 55.5}, "junk"]}))
    outs = [
        mod.MetricsDaemon(dev_root=root, drop_file=str(tmp_path / f"{i}.json"),
                          sample_file=str(side)).collect_once()
        for i, (mod, root) in enumerate(((ref, dev_roots[0]), (daemon, dev_roots[1])))
    ]
    assert _strip(outs[1]) == _strip(outs[0])
    assert outs[1]["chips"][1] == {"index": 1, "present": 1, "tensorcore_util": 55.5}


def test_http_endpoint_matches_the_reference(tmp_path, dev_roots):
    payloads = []
    for mod, root in ((ref, dev_roots[0]), (daemon, dev_roots[1])):
        d = mod.MetricsDaemon(dev_root=root, drop_file=str(tmp_path / f"{mod.__name__}.json"),
                              interval_s=0.2)
        port = free_port()
        server = d.serve(port=port, block=False)
        try:
            d.collect_once()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5) as r:
                payload = json.loads(r.read())
            assert set(payload) == {"source", "ts", "chips"}
            payloads.append(payload)
        finally:
            d.stop()
            server.shutdown()
            server.server_close()
    assert payloads[1]["chips"] == payloads[0]["chips"]


@pytest.mark.parametrize("seconds", [1e-3, 2.5e-5, 5e-4])
def test_duty_cycle_divides_by_the_cards_peak(monkeypatch, seconds):
    """The same timer reading gives the reference's TFLOPS; the port
    divides them by the H100's bf16 peak where the reference divides by
    v5e's (its 1.97 is 197 TFLOPS over 100), capped at 100."""
    import jax

    times = iter([10.0, 10.0 + seconds])
    monkeypatch.setattr(ref.time, "perf_counter", lambda: next(times, 10.0 + seconds))
    monkeypatch.setattr(jax, "devices", lambda: [type("D", (), {"platform": "tpu"})()])
    ref_util = ref.MetricsDaemon()._sample_duty_cycle()["tensorcore_util"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(daemon, "timed_product_s", lambda n=daemon.SAMPLE_SIZE: seconds)
    d = daemon.MetricsDaemon(own_chip=True)
    util = d._sample_duty_cycle()["tensorcore_util"]
    tflops = 2.0 * daemon.SAMPLE_SIZE**3 / seconds / 1e12
    assert d.last_sample_tflops == pytest.approx(tflops)
    assert util == round(min(100.0, tflops / (PEAK_BF16_TFLOPS["h100-sxm"] / 100)), 2)
    assert ref_util == round(min(100.0, tflops / 1.97), 2)


def test_duty_cycle_unknown_card_is_not_guessed(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(daemon, "timed_product_s", lambda n=daemon.SAMPLE_SIZE: 1e-3)
    assert daemon.MetricsDaemon(own_chip=True)._sample_duty_cycle() is None
    assert "A100" in caplog.text


def test_no_sample_off_the_card(tmp_path, dev_roots, monkeypatch):
    """Off the card both samplers return None and collection goes on
    without a sample; the card-owning sampler itself refuses to start."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ref.MetricsDaemon()._sample_duty_cycle() is None  # JAX on the CPU
    d = daemon.MetricsDaemon(dev_root=dev_roots[1], drop_file=str(tmp_path / "m.json"), own_chip=True)
    assert d._sample_duty_cycle() is None
    assert d.collect_once()["chips"][0] == {"index": 0, "present": 1}
    with pytest.raises(RuntimeError, match="expected CUDA"):
        d.run_sampler(str(tmp_path / "sample.json"))
    with pytest.raises(RuntimeError, match="expected CUDA"):
        daemon.main(["--sampler-only", "--sample-file", str(tmp_path / "s.json")])
    with pytest.raises(RuntimeError, match="expected CUDA"):
        daemon.main(["--own-chip", "--drop-file", str(tmp_path / "d.json")])


def test_sampler_writes_the_side_file(tmp_path, dev_roots, monkeypatch):
    monkeypatch.setattr(daemon.MetricsDaemon, "_sample_duty_cycle", lambda self: {"tensorcore_util": 12.5})
    monkeypatch.setattr("tpu_operator_torch.device.resolve_device", lambda d=None: d)
    d = daemon.MetricsDaemon(dev_root=dev_roots[1], interval_s=0.01)
    side = tmp_path / "run" / "sample.json"
    d._stop.set()  # stopped before it starts: no sample
    d.run_sampler(str(side))
    assert not side.exists()
    d._stop.clear()
    monkeypatch.setattr(d._stop, "wait", lambda s: d._stop.set())  # one pass
    d.run_sampler(str(side))
    chips = json.loads(side.read_text())["chips"]
    assert chips == [{"index": i, "tensorcore_util": 12.5} for i in (0, 1, 4)]


def test_module_runs_as_a_program():
    proc = subprocess.run([sys.executable, "-m", "tpu_operator_torch.metricsd", "--help"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "--sampler-only" in proc.stdout


def test_failed_sample_publishes_presence_and_keeps_the_sampler(tmp_path, dev_roots, monkeypatch):
    """A product that fails (a job holding the card's memory) leaves each
    card's presence published without ``tensorcore_util``, in both
    daemons' drop files alike, and the card-owning sampler keeps running."""
    import threading

    import jax

    oom = RuntimeError("CUDA error: out of memory")

    def fail(*_):
        raise oom

    monkeypatch.setattr(jax, "devices", fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    calls = []
    tried = threading.Event()

    def failing_product(n=daemon.SAMPLE_SIZE):
        calls.append(n)
        tried.set()
        raise oom

    monkeypatch.setattr(daemon, "timed_product_s", failing_product)
    drops = []
    for mod, root, name in ((ref, dev_roots[0], "ref"), (daemon, dev_roots[1], "port")):
        drop = tmp_path / name / "metricsd.json"
        mod.MetricsDaemon(dev_root=root, drop_file=str(drop), own_chip=True).collect_once()
        drops.append(json.loads(drop.read_text()))
    assert calls, "the port's sample was not tried"
    assert _strip(drops[1]) == _strip(drops[0])
    assert drops[1]["chips"] == [{"index": i, "present": 1} for i in (0, 1, 4)]

    monkeypatch.setattr("tpu_operator_torch.device.resolve_device", lambda d=None: d)
    d = daemon.MetricsDaemon(dev_root=dev_roots[1], interval_s=0.01)
    side = tmp_path / "side.json"
    tried.clear()
    t = threading.Thread(target=d.run_sampler, args=(str(side),), daemon=True)
    t.start()
    try:
        assert tried.wait(10), "the sampler never sampled"
        tried.clear()
        assert tried.wait(10), "the sampler did not sample again after a failure"
        assert t.is_alive()
        assert not side.exists()
    finally:
        d.stop()
        t.join(10)
    assert not t.is_alive()
