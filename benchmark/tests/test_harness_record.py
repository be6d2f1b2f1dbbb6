"""The recorder of the program's kernel builders, and the rule that a
metric the cell reports reads something on the card."""

import pytest
import torch

from benchmark import harness, record
from tpu_operator_torch.workloads import flashattn, matmul


def test_recording_keeps_arguments_and_the_first_call_and_restores_the_builder():
    real = matmul.make_matmul_step
    with record.recording([("tpu_operator_torch.workloads.matmul", "make_matmul_step")]) as builds:
        step, (a, b) = matmul.make_matmul_step(64, depth=2, device="cpu")
        first = step(a, b)
        step(first, b)
    assert matmul.make_matmul_step is real
    (build,) = builds
    assert build.builder == "make_matmul_step"
    assert build.args == {"size": 64, "depth": 2, "device": "cpu"}
    (x, y), out = build.first
    assert x is a and y is b and out is first


def test_off_widths_counts_refused_missing_and_extra_builds():
    with record.recording([("tpu_operator_torch.workloads.flashattn", "make_flash_fn")]) as builds:
        q = torch.randn(2, 128, 128, dtype=torch.bfloat16)
        flashattn.make_flash_fn(128, 2, 128, 64, 64)(q, q, q)
        flashattn.make_flash_fn(128, 2, 128, 64, 64)  # built, never called
    wanted = lambda _, a: a["heads"] == 2  # noqa: E731
    assert record.off_widths(builds, 1, wanted) == 0
    assert record.off_widths(builds, 1, lambda _, a: a["heads"] == 4) == 1
    assert record.off_widths(builds, 3, wanted) == 2
    assert record.off_widths([], 1, wanted) == 1


@pytest.mark.parametrize("device, raises", [("cuda", True), ("cpu", False)])
def test_a_metric_that_reads_nothing_fails_the_run_on_the_card(device, raises):
    listed = [{"name": "kernel.k3_roofline"}, {"name": "device.idle"}]
    metrics = {"device.idle": {"value": 8.1, "unit": "%"}}
    if raises:
        with pytest.raises(harness.SilentMetric, match="kernel.k3_roofline"):
            harness.require_read("admission.attn", listed, metrics, torch.device(device))
    else:
        harness.require_read("admission.attn", listed, metrics, torch.device(device))
    metrics["kernel.k3_roofline"] = {"value": 36.2, "unit": "%"}
    harness.require_read("admission.attn", listed, metrics, torch.device("cuda"))
