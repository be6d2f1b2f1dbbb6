"""The port's ``dryrun_multichip`` on the CPU, and its refusals: it prints
the reference's summary line over a gloo world of four, and with no GPU,
or fewer cards than ranks, it raises instead of running on the CPU."""

import re

import pytest
import torch

from tpu_operator_torch import consts
from tpu_operator_torch.entry import dryrun_multichip
from tpu_operator_torch.validator import components as comp
from tpu_operator_torch.workloads import mesh

SUMMARY = re.compile(
    r"^dryrun_multichip OK: mesh dp=2 tp=2 sp=4 pp=4 ep=4 \(4 devices\), "
    r"loss=[0-9.]+, ringattn max_err=\S+, pipeline max_err=\S+, moe max_err=\S+$"
)


def _never_runs(world):
    raise AssertionError("a rank started")


@pytest.fixture
def one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_dryrun_prints_the_summary_on_four_cpu_ranks(capsys):
    dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert SUMMARY.match(lines[-1]), lines[-1]


def test_dryrun_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="expected CUDA"):
        dryrun_multichip(1)


def test_nccl_world_larger_than_the_cards_raises(one_card):
    """Two ranks on one card raise before any process starts: no fallback
    to the CPU."""
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        mesh.spawn_world(_never_runs, 2, "cuda")
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        dryrun_multichip(2)


@pytest.mark.parametrize(
    "validate,status_file",
    [
        (comp.validate_slice, consts.STATUS_FILE_SLICE),
        (comp.validate_ici, consts.STATUS_FILE_ICI),
        (comp.validate_ringattn, consts.STATUS_FILE_RINGATTN),
        (comp.validate_pipeline, consts.STATUS_FILE_PIPELINE),
        (comp.validate_moe, consts.STATUS_FILE_MOE),
    ],
)
def test_components_fail_with_too_few_cards(one_card, tmp_path, validate, status_file):
    status = comp.StatusFiles(str(tmp_path))
    with pytest.raises(comp.ValidationError, match="need 2 devices, have 1"):
        validate(status, expect_devices=2)
    assert not status.exists(status_file)


def test_probe_status_files_are_the_references():
    from tpu_operator import consts as ref

    assert consts.PROBE_STATUS_FILES == ref.PROBE_STATUS_FILES
    for name in ("SLICE", "SLICE_WORKLOAD"):
        attr = f"STATUS_FILE_{name}"
        assert getattr(consts, attr) == getattr(ref, attr)
