"""gpu-metricsd: the standalone metrics daemon (the DCGM hostengine slot).

The counterpart of ``tpu_operator/metricsd/daemon.py``. ``main`` hands
serving to the C++ hostengine (``native/csrc/gpu_metricsd.cpp``, built by
``native/build.py``) where one is found, as the reference hands it to
``native/tpu_metricsd.cpp``: the hostengine reads the chip table through
libgpuinfo, merges the sampler's side file and serves ``/json`` and
``/metrics`` on :5555. This Python daemon serves where no hostengine is
found, with ``--no-native``, and with ``--own-chip``, where it

* collects the cards' facts from the chip table (``native/gpuinfo.py``:
  presence, NUMA node),
* with ``--own-chip`` samples the card itself: a duty-cycle estimate from
  timing one bf16 product on ``cuda:0`` against the card's peak,
* publishes to the ``/run/tpu/metricsd.json`` drop-file and over HTTP on
  :5555, the hostengine's port.

``--sampler-only`` runs just the card-owning sampler, which writes the side
file that a serving daemon, native or not, merges.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpu_operator_torch.native import build as native_build
from tpu_operator_torch.native import gpuinfo

log = logging.getLogger("gpu-metricsd")

DROP_FILE = "/run/tpu/metricsd.json"
SAMPLE_FILE = "/run/tpu/metricsd-sample.json"
DEFAULT_PORT = 5555
INSTALLED_NATIVE = "/usr/local/bin/gpu-metricsd-native"
SAMPLE_SIZE = 2048  # the timed product is SAMPLE_SIZE² bf16, 2·SAMPLE_SIZE³ FLOPs


def _write_json(path: str, payload: dict) -> None:
    """Replace ``path`` atomically (a reader never sees half a file)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def find_native_binary() -> Optional[str]:
    """The C++ hostengine: ``GPU_METRICSD_NATIVE``, then the installed
    ``/usr/local/bin/gpu-metricsd-native``, then the build of the current
    source hash; None where none is an executable file. Never compiles."""
    explicit = os.environ.get("GPU_METRICSD_NATIVE")
    candidates = [explicit] if explicit else []
    candidates += [INSTALLED_NATIVE, str(native_build.build_dir() / native_build.METRICSD_NAME)]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return os.path.abspath(c)
    return None


def exec_native(binary: str, args) -> int:
    """Replace this process with the C++ hostengine, with the reference's
    arguments."""
    cmd = [
        binary,
        "--port", str(args.port),
        "--dev-root", args.dev_root,
        "--drop-file", args.drop_file,
        "--sample-file", args.sample_file,
        "--interval", str(args.interval),
    ]
    log.info("delegating to the native hostengine: %s", " ".join(cmd))
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(binary, cmd)
    return 1  # unreachable


def timed_product_s(n: int = SAMPLE_SIZE) -> float:
    """Host seconds of one n×n bf16 product with an f32 result on
    ``cuda:0``, after a warm call, to ``torch.cuda.synchronize()``."""
    import torch

    x = torch.ones((n, n), dtype=torch.bfloat16, device="cuda:0")
    torch.mm(x, x, out_dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.mm(x, x, out_dtype=torch.float32)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class MetricsDaemon:
    def __init__(
        self,
        dev_root: str = "/dev",
        drop_file: str = DROP_FILE,
        own_chip: bool = False,
        interval_s: float = 10.0,
        sample_file: str = SAMPLE_FILE,
    ):
        self.dev_root = dev_root
        self.drop_file = drop_file
        self.own_chip = own_chip
        self.interval_s = interval_s
        self.sample_file = sample_file
        self.last_sample_tflops: Optional[float] = None
        self._sample_failed = False  # logged once
        self._stop = threading.Event()
        self._latest: dict = {"source": "gpu-metricsd", "chips": []}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def collect_once(self) -> dict:
        chips = gpuinfo.chip_summary(self.dev_root)
        sample = self._sample_duty_cycle() if self.own_chip else None
        # merge a sampler sidecar's side-file, so the serving daemon shows
        # what the card-owning sampler measured
        side = self._read_sample_file() if not self.own_chip else {}
        out = {"source": "gpu-metricsd", "ts": time.time(), "chips": []}
        for chip in chips:
            entry = {"index": chip["index"], "present": 1}
            if "numa_node" in chip:
                entry["numa_node"] = chip["numa_node"]
            if sample is not None:
                entry.update(sample)
            extra = side.get(chip["index"])
            if extra:
                entry.update({k: v for k, v in extra.items() if k != "index"})
            out["chips"].append(entry)
        with self._lock:
            self._latest = out
        self._write_drop_file(out)
        return out

    def _sample_duty_cycle(self) -> Optional[dict]:
        """Rough tensor-core utilization: the TFLOPS of one timed
        ``SAMPLE_SIZE``² bf16 product against the card's bf16 peak
        (``workloads/topology.py``), in percent, capped at 100. None off
        the card, and for a card with no peak entry (its name is logged:
        no guess), and when the product fails (a job holding the card's
        memory): the failure is logged once and no reading is claimed, as
        the reference's guard does (``daemon.py:101-125``). The product
        takes ~25 µs at 700 TFLOPS, so the host's launch and sync dominate
        the reading."""
        import torch

        if not torch.cuda.is_available():
            return None
        from tpu_operator_torch.workloads.topology import PEAK_BF16_TFLOPS, device_generation

        name = torch.cuda.get_device_name(0)
        gen = device_generation(name)
        if gen is None:
            log.warning("no bf16 peak for %r: duty cycle not sampled", name)
            return None
        try:
            seconds = timed_product_s()
        except Exception:
            if not self._sample_failed:
                log.exception("duty-cycle sample failed; publishing presence only")
            self._sample_failed = True
            return None
        tflops = 2.0 * SAMPLE_SIZE**3 / seconds / 1e12
        self.last_sample_tflops = tflops
        return {"tensorcore_util": round(min(100.0, tflops / (PEAK_BF16_TFLOPS[gen] / 100)), 2)}

    def _read_sample_file(self) -> dict:
        """{chip_index: counters} from the card-owning sampler's side-file."""
        try:
            with open(self.sample_file) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(data, dict):
            return {}
        return {c.get("index"): c for c in data.get("chips", []) if isinstance(c, dict)}

    def _write_drop_file(self, payload: dict) -> None:
        try:
            _write_json(self.drop_file, payload)
        except OSError:
            log.exception("drop-file write failed")

    # ------------------------------------------------------------------
    def latest(self) -> dict:
        with self._lock:
            return dict(self._latest)

    def serve(self, port: int = DEFAULT_PORT, block: bool = True):
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = json.dumps(daemon.latest()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()

        def loop():
            while not self._stop.is_set():
                try:
                    self.collect_once()
                except Exception:
                    log.exception("collection failed")
                self._stop.wait(self.interval_s)

        threading.Thread(target=loop, daemon=True).start()
        log.info("gpu-metricsd serving :%d (drop-file %s)", port, self.drop_file)
        if block:
            while not self._stop.is_set():
                time.sleep(1)
        return server

    def stop(self):
        self._stop.set()

    # ------------------------------------------------------------------
    def run_sampler(self, sample_file: str = SAMPLE_FILE) -> None:
        """Card-owning sampler loop: this process holds ``cuda:0`` and drops
        its sample into the side-file a serving daemon merges. Requires
        CUDA."""
        from tpu_operator_torch.device import resolve_device

        resolve_device("cuda:0")
        while not self._stop.is_set():
            sample = self._sample_duty_cycle()
            if sample is not None:
                # one product samples the card; report it for every card on
                # the host (the --own-chip path does the same per-card fan-out)
                indices = [c["index"] for c in gpuinfo.chip_summary(self.dev_root)] or [0]
                payload = {"ts": time.time(), "chips": [{"index": i, **sample} for i in indices]}
                try:
                    _write_json(sample_file, payload)
                except OSError:
                    log.exception("sample-file write failed")
            self._stop.wait(self.interval_s)


def main(argv=None) -> int:
    import argparse

    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-metricsd")
    p.add_argument("--port", type=int, default=int(os.environ.get("METRICSD_PORT", DEFAULT_PORT)))
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--drop-file", default=DROP_FILE)
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument(
        "--own-chip",
        action="store_true",
        help="sample the card itself (needs CUDA)",
    )
    p.add_argument("--sample-file", default=os.environ.get("METRICSD_SAMPLE_FILE", SAMPLE_FILE))
    p.add_argument(
        "--sampler-only",
        action="store_true",
        help="run only the card-owning sampler writing --sample-file",
    )
    p.add_argument(
        "--no-native",
        action="store_true",
        help="never delegate serving to the C++ hostengine",
    )
    args = p.parse_args(argv)
    daemon = MetricsDaemon(
        dev_root=args.dev_root,
        drop_file=args.drop_file,
        own_chip=args.own_chip or args.sampler_only,
        interval_s=args.interval,
        sample_file=args.sample_file,
    )
    if args.sampler_only:
        daemon.run_sampler(args.sample_file)
        return 0
    if not args.no_native and not args.own_chip:
        native = find_native_binary()
        if native:
            return exec_native(native, args)
    if args.own_chip:
        from tpu_operator_torch.device import resolve_device

        resolve_device("cuda:0")
    daemon.serve(port=args.port)
    return 0
