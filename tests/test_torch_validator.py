"""The port's validator on the CPU: the CLI writes each status file, the
JAX package's exporter reads the payloads unchanged, entry points refuse
to run without a GPU unless asked for the CPU, kernel wrappers count no
launch on the CPU, and the package imports neither jax nor tpu_operator."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tpu_operator.consts import PROBE_STATUS_FILES
from tpu_operator.validator.metrics import payload_perf
from tpu_operator_torch import _build
from tpu_operator_torch.validator import components as comp
from tpu_operator_torch.validator import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLI_CASES = [
    ("cuda", ["--matmul-size", "256"], "cuda-ready", "tflops"),
    ("membw", ["--membw-size-mb", "2"], "membw-ready", "gbps"),
    ("flashattn", ["--flashattn-seq", "256", "--flashattn-heads", "2"], "flashattn-ready", None),
    # the multi-device components, each in a gloo world of two
    ("slice", ["--expect-devices", "2"], "slice-ready", None),
    ("ici", ["--expect-devices", "2"], "ici-ready", None),
    ("ringattn", ["--expect-devices", "2", "--ringattn-seq-len", "256"], "ringattn-ready", None),
    ("pipeline", ["--expect-devices", "2"], "pipeline-ready", None),
    ("moe", ["--expect-devices", "2"], "moe-ready", None),
]
MULTIDEVICE = ["slice", "ici", "ringattn", "pipeline", "moe"]


@pytest.mark.parametrize("component,args,status_file,perf_key", CLI_CASES)
def test_cli_writes_status_file(tmp_path, component, args, status_file, perf_key):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.validator", "--component",
         component, "--allow-cpu", *args, "--output-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / status_file) as f:
        payload = json.load(f)
    assert payload["ok"] is True
    if component in MULTIDEVICE:
        # a probe the reference exporter publishes, with its world's size
        assert status_file in PROBE_STATUS_FILES
        assert payload.get("n_devices", payload.get("n_stages", payload.get("n_experts"))) == 2
    if perf_key is not None:
        # the reference exporter's canonical (flat) read, unchanged
        perf = payload_perf(payload)
        assert set(perf) == {perf_key} and perf[perf_key] > 0


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import tpu_operator_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'tpu_operator_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'tpu_operator' or n.startswith('tpu_operator.'))\n"
        "assert not bad, bad\n"
        "assert 'tpu_operator_torch.workloads.flashattn' in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=240
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    from tpu_operator_torch.entry import dryrun_multichip, entry
    from tpu_operator_torch.workloads.burnin import run_burnin
    from tpu_operator_torch.workloads.flashattn import run_flashattn_probe
    from tpu_operator_torch.workloads.matmul import run_matmul_validation
    from tpu_operator_torch.workloads.membw import run_membw_probe
    from tpu_operator_torch.workloads.moe import run_moe
    from tpu_operator_torch.workloads.pipeline import run_pipeline
    from tpu_operator_torch.workloads.ring import run_ring_probe
    from tpu_operator_torch.workloads.ringattn import run_ringattn

    return {
        "entry": lambda: entry(),
        "matmul": lambda: run_matmul_validation(size=256, depth=1, iters=1),
        "membw": lambda: run_membw_probe(size_mb=2, iters=1),
        "flashattn": lambda: run_flashattn_probe(seq=256, heads=1),
        "dryrun": lambda: dryrun_multichip(1),
        "burnin": lambda: run_burnin(1, steps=1),
        "ring": lambda: run_ring_probe(1),
        "ringattn": lambda: run_ringattn(1, seq_len=64),
        "pipeline": lambda: run_pipeline(1),
        "moe": lambda: run_moe(1),
    }


@pytest.mark.parametrize("name", ["entry", "matmul", "membw", "flashattn", "dryrun", "burnin",
                                  "ring", "ringattn", "pipeline", "moe"])
def test_entry_points_raise_without_gpu(no_gpu, name):
    with pytest.raises(RuntimeError, match="expected CUDA"):
        _entry_points()[name]()


@pytest.mark.parametrize("component", ["cuda", "membw", "flashattn", *MULTIDEVICE])
def test_cli_fails_without_gpu_unless_allow_cpu(no_gpu, tmp_path, component):
    assert cli.main(["--component", component, "--output-dir", str(tmp_path)]) == 1
    assert not os.listdir(tmp_path)


def test_kernel_wrappers_on_cpu_launch_nothing():
    from tpu_operator_torch.workloads import flashattn, membw

    _build.reset_launches()
    x = torch.zeros((8, membw.LANES), dtype=torch.float32)
    membw.tiled_copy(x)
    membw.bulk_copy(x)
    q = torch.zeros((1, 128, 128), dtype=torch.bfloat16)
    flashattn.flash_attention(q, q, q, 64, 64)
    assert _build.launches == {name: 0 for name in _build.KERNELS}


def test_validate_membw_cpu(tmp_path):
    status = comp.StatusFiles(str(tmp_path))
    info = comp.validate_membw(status, expect_gpu=False, size_mb=2)
    assert info["ok"] and info["integrity"]
    assert status.exists("membw-ready")


def test_validate_membw_utilization_gate(tmp_path, monkeypatch):
    """A sick stack (below the fraction of the card's spec) fails loudly."""
    from tpu_operator_torch.workloads import membw

    sick = membw.MemBwResult(
        ok=True, device_kind="NVIDIA H100 80GB HBM3", platform="cuda",
        size_mb=2048, iters=16, elapsed_s=1.0, gbps=900.0,
        peak_gbps=3350.0, utilization=900.0 / 3350.0, integrity=True,
    )
    monkeypatch.setattr(membw, "run_membw_probe", lambda **kw: sick)
    status = comp.StatusFiles(str(tmp_path))
    with pytest.raises(comp.ValidationError, match="below"):
        comp.validate_membw(status, expect_gpu=True, min_utilization=0.5)
    assert not status.exists("membw-ready")


def test_cli_environment_defaults(monkeypatch):
    monkeypatch.setenv("FLASHATTN_SEQ", "4096")
    monkeypatch.setenv("FLASHATTN_HEADS", "")
    monkeypatch.setenv("MEMBW_MIN_UTILIZATION", "0.7")
    monkeypatch.setenv("MEMBW_SIZE_MB", "oops")
    monkeypatch.setenv("RINGATTN_SEQ_LEN", "1024")
    args = cli.build_parser().parse_args(["--component", "membw"])
    assert (args.flashattn_seq, args.flashattn_heads) == (4096, 8)
    assert (args.membw_min_utilization, args.membw_size_mb) == (0.7, 0)
    assert args.matmul_size == 4096 and not args.allow_cpu
    assert args.ringattn_seq_len == 1024 and args.expect_devices is None
    monkeypatch.setenv("EXPECT_GPU_DEVICES", "4")
    assert cli.build_parser().parse_args(["--component", "ici"]).expect_devices == 4
