"""The port's bandwidth probe against the JAX package's, on the CPU: the
copy kernels' plain versions are bit-exact against the interpreted Pallas
copy, the plausibility gate gives the same answers, and the probe runs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_operator.workloads import membw as ref
from tpu_operator_torch import convert
from tpu_operator_torch.workloads import membw as port


@pytest.mark.parametrize("kind", ["tiled", "tiled_tma", "bulk"])
def test_copy_plain_matches_jax_kernel(kind):
    """Bit-exact (a copy has no rounding) on the input of
    ``test_membw_copy_kernel_exact``: rows 8, block_rows 4."""
    rows = 8
    x = np.arange(rows * ref.LANES, dtype=np.float32).reshape(rows, ref.LANES)
    want = np.asarray(ref.make_copy_fn(rows, block_rows=4, interpret=True)(jnp.asarray(x)))
    fn = {
        "tiled": port.make_copy_fn(rows, 4),
        "tiled_tma": port.tiled_copy_tma,
        "bulk": port.make_dma_copy_fn(rows, 8),
    }[kind]
    got = convert.to_numpy(fn(convert.to_torch(x)))
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize(
    "copy,stream,peak",
    [
        (600.0, 700.0, 819.0),
        (650.0, 2800.0, 819.0),
        (2800.0, 650.0, 819.0),
        (820.0, 0.0, 819.0),
        (123.0, 456.0, None),
        (3000.0, 2900.0, 3350.0),
        (3600.0, 2500.0, 3350.0),
        (2800.0, 3000.0, 819.0),
        (0.0, 0.0, None),
        (4000.0, 3600.0, 3350.0),
    ],
)
def test_best_plausible_gbps_agrees(copy, stream, peak):
    try:
        want = ref.best_plausible_gbps(copy, stream, peak)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            port.best_plausible_gbps(copy, stream, peak)
    else:
        assert port.best_plausible_gbps(copy, stream, peak) == want


def test_probe_cpu():
    res = port.run_membw_probe(size_mb=2, iters=2, device="cpu")
    assert res.ok, res.error
    assert res.integrity and res.platform == "cpu"
    assert res.copy_gbps > 0 and res.stream_gbps > 0
    assert res.gbps == max(res.copy_gbps, res.stream_gbps)
    # the same buffer as the reference's probe at this size
    assert res.size_mb == ref.run_membw_probe(size_mb=2, iters=1).size_mb


@pytest.mark.parametrize("size_mb", [1, 2, 100, 2048])
def test_probe_rows_match_reference_rule(size_mb):
    """2048 MiB gives the (32768, 16384) f32 probe buffer, 2 GiB."""
    align = 8 * 32
    rows = max(align, (size_mb * (1 << 20)) // (ref.LANES * 4))
    assert port.probe_rows(size_mb) == rows - rows % align
    if size_mb == 2048:
        assert port.probe_rows(size_mb) * port.LANES * 4 == 2 << 30


def test_copy_fns_reject_non_tiling_rows():
    with pytest.raises(ValueError):
        port.make_copy_fn(10, 4)
    with pytest.raises(ValueError):
        port.make_dma_copy_fn(12, 8)


@pytest.mark.parametrize(
    "shape,dtype",
    [((8, 100), torch.float32), ((8, port.LANES), torch.float64), ((port.LANES,), torch.float32)],
)
def test_copy_wrappers_reject_bad_buffers(shape, dtype):
    x = torch.zeros(shape, dtype=dtype)
    for wrapper in (port.tiled_copy, port.tiled_copy_tma, port.bulk_copy):
        with pytest.raises(ValueError):
            wrapper(x)


def test_time_copies_needs_the_card():
    """The kernels' times come from the card only: without a GPU the
    timing entry raises rather than time the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.time_copies(size_mb=2)
