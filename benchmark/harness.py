"""One run of one cell: set-up, a closed-loop window, the check, the result.

Everything that belongs to one configuration, mix, component or metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the widths each component runs at, with the
  limits of its comparisons (the file ``BENCHMARK.json`` names);
* ``mixes/<traffic>.json``: the entry kind and the components a pass calls,
  in order;
* ``components/<component>.py``: the call into the program, the payload's
  numbers, the comparisons with the plain reference, and the program's
  kernel builders whose functions the entry's own call is held by;
* ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader a metric.

A pass calls the mix's components in order, as one node validator does;
the first that fails the node ends the pass. One client issues one pass
after another until ``seconds`` have passed (a pass that has started runs
to its end). With ``trace`` the window runs under ``torch.profiler`` and
the result carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import importlib.util
import json
import math
import resource
import shutil
import sys
import tempfile
import time
import zlib
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

from benchmark import record
from benchmark.work import counts

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_operator")
PASS_SPAN = "pass"


class SilentMetric(RuntimeError):
    """A metric the cell reports read nothing on the card."""


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module_name(kind: str, name: str) -> str:
    return "benchmark_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for cfg in self.spec["configs"]:
            if cfg["name"] == name:
                return json.loads((self.root / cfg["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return json.loads((self.dir / "mixes" / f"{name}.json").read_text())

    def component(self, name: str):
        return load_module(self.dir / "components" / f"{name}.py", _module_name("component", name))

    def reader(self, kind: str, name: str):
        """The reader of end-to-end (``e2e``) or per-layer (``metrics``) metric ``name``."""
        return load_module(self.dir / kind / f"{name}.py", _module_name(kind, name))

    def metrics_of(self, cell: str, trace: bool) -> list:
        """The metric entries a cell reports: with ``trace`` the per-layer
        ones that list it; else the end-to-end ones that list it or list no
        cells (those every cell reports)."""
        if trace:
            return [m for m in self.spec["per_layer"] if cell in m["workloads"]]
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]


@dataclass
class Run:
    """What one run knows; the readers and the components read it."""

    cell: dict
    cfg: dict
    mix: dict
    device: torch.device
    status: object = None
    peak: Optional[dict] = None
    components: list = field(default_factory=list)  # (name, module, widths)
    shapes: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)  # (name, start_s, end_s), host clock
    annotate: bool = False
    durations: list = field(default_factory=list)  # each window pass, seconds
    attempted: int = 0
    failed: int = 0
    failures: list = field(default_factory=list)
    numbers: dict = field(default_factory=dict)  # payload numbers, the largest
    counters: dict = field(default_factory=dict)
    setup_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)  # seconds of each part of set-up
    window_s: float = 0.0
    trace: object = None

    @property
    def expect_gpu(self) -> bool:
        return self.device.type == "cuda"

    @contextmanager
    def span(self, name: str):
        """A host-clock span; under the profiler it is also an annotation."""
        mark = torch.profiler.record_function(name) if self.annotate else nullcontext()
        with mark:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.append((name, t0, time.perf_counter()))

    def generator(self, seed: int, salt: str) -> torch.Generator:
        """A generator on the run's device, from the seed and a salt of its own."""
        mixed = (int(seed) * 0x9E3779B1 + zlib.crc32(salt.encode())) % (1 << 63)
        return torch.Generator(device=self.device).manual_seed(mixed)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def _sync(run: Run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def one_pass(run: Run, record: bool) -> None:
    """The mix's components in order; the first that fails the node ends the
    pass. With ``record`` the payloads' numbers and failures count."""
    from tpu_operator_torch.validator.components import ValidationError

    for name, module, w in run.components:
        with run.span(name):
            try:
                payload = module.call(run, w)
                verdict = getattr(module, "verdict", None)
                why = verdict(payload, run, w) if verdict else None
            except ValidationError as e:
                payload, why = None, f"{type(e).__name__}: {e}"
        if record and payload is not None:
            for key, value in module.numbers(payload, run, w).items():
                if value is not None:
                    run.numbers[key] = max(value, run.numbers.get(key, value))
        if why is not None:
            if record:
                run.failed += 1
                run.failures.append(f"{name}: {why}")
            return


def setup(bench: Bench, cell_name: str, device: str, status_dir: str, annotate: bool) -> Run:
    """The cell's configuration, mix and components; the program's kernel
    library; the status files under ``status_dir``."""
    from tpu_operator_torch import _build
    from tpu_operator_torch.validator.components import StatusFiles

    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    dev = torch.device(device)
    run = Run(cell=cell, cfg=cfg, mix=mix, device=dev, annotate=annotate,
              status=StatusFiles(status_dir))
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)  # the CUDA context
        run.peak = counts.card_peak(torch.cuda.get_device_name(dev))
        t = _part(run, "cuda_context", t)
        _build.library()
        t = _part(run, "kernel_library", t)
        run.setup_parts["kernel_library_built"] = bool(_build.build_info.get("built"))
    for name in mix["components"]:
        module = bench.component(name)
        w = cfg["components"][name]
        run.shapes.update(module.prepare(run, w))
        run.components.append((name, module, w))
    _part(run, "components", t)
    return run


def _part(run: Run, name: str, since: float) -> float:
    now = time.perf_counter()
    run.setup_parts[name] = now - since
    return now


def window(run: Run, seconds: float, trace: bool) -> None:
    """Passes in a closed loop for ``seconds``; with ``trace`` under the profiler."""
    from tpu_operator_torch import _build

    from benchmark import devtrace

    profiler = devtrace.DeviceTrace(run.device) if trace else None
    if profiler:
        profiler.start()
    launches = dict(_build.launches)
    first = time.perf_counter()
    deadline = first + seconds
    end = first
    while run.attempted == 0 or end < deadline:
        run.attempted += 1
        t0 = time.perf_counter()
        with run.span(PASS_SPAN):
            one_pass(run, record=True)
            _sync(run)
        end = time.perf_counter()
        run.durations.append(end - t0)
    run.window_s = end - first
    run.counters = {
        "passes": run.attempted,
        "launches": {k: v - launches[k] for k, v in _build.launches.items()},
    }
    if profiler:
        run.trace = profiler.stop(PASS_SPAN, [PASS_SPAN] + [c[0] for c in run.components])


def hold(run: Run, module, w, control: bool = False) -> dict:
    """The component's entry called once more, its program's kernel builders
    recorded, and what their functions made in that call held to the plain
    reference (with ``control`` the reference one precision lower stands in
    for each output)."""
    from tpu_operator_torch.validator.components import ValidationError

    with record.recording(module.BUILDERS) as builds:
        try:
            module.call(run, w)
        except ValidationError:
            pass  # the window counts a failed admission; here the outputs are judged
    return module.held(run, w, builds, control)


def check(run: Run, seed: int, control: bool = False) -> dict:
    """Every number ``correct`` holds to a limit: each component's comparison
    on inputs from ``seed``, the entry's own call held (``hold``), and the
    payloads' numbers from the window. Returns ``{name: (value, limit)}``."""
    found = {}
    for name, module, w in run.components:
        gen = run.generator(seed, name)
        numbers = module.compare(run, w, gen, control)
        _sync(run)
        numbers.update(hold(run, module, w, control))
        for key, value in numbers.items():
            found[key] = (value, w["limits"][key])
        _sync(run)
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
    for name, _, w in run.components:
        for key, limit in w["limits"].items():
            if key not in found:
                found[key] = (run.numbers.get(key), limit)
    return found


def is_correct(checks: dict) -> bool:
    """Every compared number within its limit; a payload number that no pass
    of the window gave (the pass failed first) is not compared."""
    return all(value is None or (not math.isnan(value) and value <= limit)
               for value, limit in checks.values())


def memory_peak_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def require_read(cell: str, listed: list, metrics: dict, device: torch.device) -> None:
    """On the card every metric the cell reports must have read something;
    off the card the readers of the card's trace and counters find nothing."""
    silent = [m["name"] for m in listed if m["name"] not in metrics]
    if silent and device.type == "cuda":
        raise SilentMetric(f"{cell}: read nothing for {', '.join(silent)}")


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float) -> dict:
    """One whole run; returns the result line as a dict (``checks`` last)."""
    status_dir = tempfile.mkdtemp(prefix="bench-status-")
    try:
        imported = time.perf_counter() - t0
        run = setup(bench, cell_name, device, status_dir, annotate=trace)
        run.setup_parts["imports"] = imported
        t = time.perf_counter()
        one_pass(run, record=False)  # every shape the window runs, warmed
        _sync(run)
        _part(run, "warm_pass", t)
        run.spans.clear()
        run.setup_s = time.perf_counter() - t0
        window(run, seconds, trace)
        peak = memory_peak_bytes(run.device)
        listed = bench.metrics_of(cell_name, trace)
        metrics = {}
        for m in listed:
            value = bench.reader("metrics" if trace else "e2e", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        require_read(cell_name, listed, metrics, run.device)
        checks = check(run, seed)
    finally:
        shutil.rmtree(status_dir, ignore_errors=True)
    dev = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    result = {"correct": is_correct(checks), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    if run.failures:
        result["failures"] = run.failures[:5]
    result["setup_parts"] = run.setup_parts
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The result as the last line on standard output; the numbers compared,
    each beside its limit, as the last lines on standard error."""
    print(f"correct {result['correct']}", file=err)
    for key, c in result["checks"].items():
        verdict = "not compared" if c["value"] is None else (
            "ok" if c["value"] <= c["limit"] else "OVER")
        print(f"check {key} {c['value']} limit {c['limit']} {verdict}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, for the record."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"

