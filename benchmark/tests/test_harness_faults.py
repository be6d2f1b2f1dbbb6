"""The check fails what it should: the control (the reference one precision
lower in the program's place), and a whole run with the timed path broken
underneath, once for each fault the cells can have."""

import functools

import pytest
import torch

from benchmark import harness
from tpu_operator_torch.workloads import flashattn, matmul, membw


def _setup(bench, cell, tmp_path):
    return harness.setup(bench, cell, "cpu", str(tmp_path / "status"), False)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_program_passes_and_the_control_fails(tiny_bench, tmp_path, seed):
    run = _setup(tiny_bench, "tiny.chain", tmp_path)
    assert harness.is_correct(harness.check(run, seed))
    control = harness.check(run, seed, control=True)
    assert not harness.is_correct(control)
    for key in ("attn_err", "mm_err", "copy_bits_differ"):
        value, limit = control[key]
        assert value > limit, key  # each control fails its own number


def _altered(out):
    out = out.clone()
    flat = out.view(-1)
    i = int(flat.float().abs().argmax())
    flat[i] = -flat[i] if flat.dtype != torch.float32 else flat[i] + 1.0
    return out


def _half(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


FAULTS = {
    "answer_altered": lambda out, first: _altered(out),
    "half_left_out": lambda out, first: _half(out),
    "state_unchanged": lambda out, first: first,
}


def _break(monkeypatch, component, fault):
    bad = FAULTS[fault]
    if component == "flashattn":
        real = flashattn.flash_attention
        monkeypatch.setattr(flashattn, "flash_attention",
                            lambda q, k, v, *a, **kw: bad(real(q, k, v, *a, **kw), q))
    elif component == "membw":
        for name in ("bulk_copy", "tiled_copy"):
            real = getattr(membw, name)
            monkeypatch.setattr(membw, name,
                                lambda x, *a, _real=real, **kw: bad(_real(x, *a, **kw), x))
    else:
        real_make = matmul.make_matmul_step

        @functools.wraps(real_make)
        def make(*a, **kw):
            step, ab = real_make(*a, **kw)
            return (lambda x, b: bad(step(x, b), x)), ab

        monkeypatch.setattr(matmul, "make_matmul_step", make)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("component", ["cuda", "membw", "flashattn"])
def test_a_broken_timed_path_comes_out_not_correct(tiny_bench, monkeypatch, component, fault):
    _break(monkeypatch, component, fault)
    result = harness.run_cell(tiny_bench, "tiny.chain", 2**31 + 3, 0.2, False, "cpu", 0.0)
    assert result["correct"] is False
    assert result["attempted"] >= 1


PROBES = {"cuda": (matmul, "run_matmul_validation", "size"),
          "membw": (membw, "run_membw_probe", "size_mb"),
          "flashattn": (flashattn, "run_flashattn_probe", "heads")}


def _break_inside_probe(monkeypatch, component, fault):
    """Break the component's probe alone: its kernel's output altered only
    while the probe runs, or the probe run at twice its width. The seeded
    comparison, which drives the kernels outside the probe, sees neither."""
    module, name, width = PROBES[component]
    real = getattr(module, name)

    @functools.wraps(real)
    def probe(*a, **kw):
        if fault == "other_width":
            kw[width] = kw[width] * 2
            return real(*a, **kw)
        with pytest.MonkeyPatch.context() as inside:
            if component == "cuda":  # under the step the builder makes
                addmm = torch.addmm
                inside.setattr(torch, "addmm", lambda *x, **y: _altered(addmm(*x, **y)))
            else:
                _break(inside, component, "answer_altered")
            return real(*a, **kw)

    monkeypatch.setattr(module, name, probe)


@pytest.mark.parametrize("fault, number", [("answer_altered", "entry"), ("other_width", "off_widths")])
@pytest.mark.parametrize("component, prefix", [("cuda", "mm"), ("membw", "copy"),
                                               ("flashattn", "flash")])
def test_a_fault_inside_the_entry_alone_comes_out_not_correct(
        tiny_bench, monkeypatch, component, prefix, fault, number):
    _break_inside_probe(monkeypatch, component, fault)
    result = harness.run_cell(tiny_bench, "tiny.chain", 2**31 + 5, 0.2, False, "cpu", 0.0)
    checks = result["checks"]
    assert result["correct"] is False
    failing = {k for k, c in checks.items() if c["value"] is not None and c["value"] > c["limit"]}
    assert failing and all(k.startswith(prefix + "_") for k in failing)
    assert any(number in k for k in failing)
    assert checks["attn_err"]["value"] <= checks["attn_err"]["limit"]  # the seeded check is clean
