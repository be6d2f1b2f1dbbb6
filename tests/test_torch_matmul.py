"""The port's matmul chain against the JAX package's, on the CPU, and the
numpy <-> tensor carrier both sides are fed through."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_operator.workloads import matmul as ref
from tpu_operator_torch import convert
from tpu_operator_torch.entry import entry
from tpu_operator_torch.workloads import matmul as port


def bf16_normal(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape, dtype=np.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_matches_jax(seed):
    """Same bf16 a, b at size 256, depth 2. The scale 1/256 is a power of
    two, so rounding to bf16 before or after it gives the same value; only
    the order of the f32 sums differs. Tolerance: one bf16 ulp (2^-8
    relative) per step, two steps, at the output's largest magnitude."""
    size, depth = 256, 2
    a, b = bf16_normal((size, size), seed), bf16_normal((size, size), seed + 100)
    fn_j, _ = ref.make_matmul_step(size=size, depth=depth)
    want = np.asarray(fn_j(jnp.asarray(a), jnp.asarray(b))).astype(np.float32)
    fn_t, _ = port.make_matmul_step(size=size, depth=depth, device="cpu")
    out = fn_t(convert.to_torch(a), convert.to_torch(b))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (size, size)
    got = convert.to_numpy(out, jnp.bfloat16).astype(np.float32)
    tol = 2 * 2.0**-8 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("size", [96, 200, 1000])
def test_chain_rounds_once_like_the_reference(size):
    """Depth 4 at sizes whose 1/size is no power of two, where rounding
    the f32 sum to bf16 before the scale would differ from the reference at
    most elements: the port scales in f32 and rounds once, as
    ``make_matmul_step`` does, so the two chains agree bit for bit."""
    depth = 4
    a, b = bf16_normal((size, size), size), bf16_normal((size, size), size + 1)
    fn_j, _ = ref.make_matmul_step(size=size, depth=depth)
    want = np.asarray(fn_j(jnp.asarray(a), jnp.asarray(b)))
    fn_t, _ = port.make_matmul_step(size=size, depth=depth, device="cpu")
    got = convert.to_numpy(fn_t(convert.to_torch(a), convert.to_torch(b)), jnp.bfloat16)
    assert got.tobytes() == want.tobytes()


def test_result_to_dict_keys_match():
    args = (True, "kind", "cpu", 1, 256, 2, 0.5, 1.0, None, None)
    assert port.MatmulResult(*args).to_dict().keys() == ref.MatmulResult(*args).to_dict().keys()


def test_run_matmul_validation_cpu():
    res = port.run_matmul_validation(size=256, depth=2, iters=2, device="cpu")
    assert res.ok, res.error
    assert res.platform == "cpu" and res.device_kind == "cpu"
    assert res.tflops > 0 and res.peak_tflops is None
    d = res.to_dict()
    assert d["ok"] and d["tflops"] > 0


@pytest.mark.parametrize(
    "name,tag",
    [
        ("NVIDIA H100 80GB HBM3", "h100-sxm"),
        ("NVIDIA H100 SXM5 80GB", "h100-sxm"),
        ("NVIDIA H100 PCIe", "h100-pcie"),
        ("NVIDIA H100 NVL", "h100-nvl"),
        ("NVIDIA A100-SXM4-80GB", None),
        ("NVIDIA H200", None),
        ("TPU v5 lite", None),
        ("cpu", None),
    ],
)
def test_device_generation(name, tag):
    assert port.device_generation(name) == tag


def test_entry_on_cpu():
    fn, (a, b) = entry(device="cpu")
    assert a.shape == b.shape == (1024, 1024) and a.dtype == torch.bfloat16
    out = fn(a, b)
    assert out.shape == (1024, 1024) and bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("dtype", [np.float32, np.int32, jnp.bfloat16])
def test_convert_round_trip_keeps_bits(dtype):
    x = (np.arange(-12, 12, dtype=np.float32) * 0.37).reshape(4, 6).astype(dtype)
    t = convert.to_torch(x)
    back = convert.to_numpy(t, jnp.bfloat16 if dtype is jnp.bfloat16 else None)
    assert back.dtype == x.dtype
    assert back.tobytes() == x.tobytes()


def test_convert_bf16_values():
    x = np.array([1.5, -2.25, 3e-3], dtype=np.float32).astype(jnp.bfloat16)
    t = convert.to_torch(x)
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == x.astype(np.float32).tolist()
    assert convert.to_numpy(t).dtype == np.uint16
