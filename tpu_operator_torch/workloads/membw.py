"""HBM bandwidth probe — hand-written copy kernels against the card's spec.

The counterpart of the JAX package's ``workloads/membw.py``. Achieved
device-memory bandwidth is measured two ways and compared with the card's
datasheet rate; a sick memory stack shows a bandwidth cliff long before it
corrupts training.

* ``copy_gbps``: K2, the bulk-copy kernel (``csrc/copy.cu::bulk_copy``),
  the whole buffer as ``n_chunks`` chunks of ``cp.async.bulk`` copies;
* ``stream_gbps``: eager ``x + 1.0``, one read and one write per element
  (the reference's fused XLA pass, which is no kernel of its own).

K1, the tiled copy (``csrc/copy.cu::tiled_copy_f32``), backs
``make_copy_fn``: the copy path off the card, where it runs its plain
version. ``tiled_copy_tma`` is K1's Hopper redesign (TMA tiles through a
ring, a persistent grid), which measured slower than K1 and is on no path;
it is timed beside K1. Each wrapper takes the plain version (``x.clone()``)
only for a tensor on the CPU; for a CUDA tensor it launches its kernel or
raises.

    python -m tpu_operator_torch.workloads.membw

prints the card's name, then K1's, the tried design's, K2's and
``Tensor.copy_``'s device milliseconds a copy of the probe's 2 GiB buffer
as one JSON line.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tpu_operator_torch import _build
from tpu_operator_torch.device import device_kind, resolve_device
from tpu_operator_torch.workloads.matmul import device_generation
from tpu_operator_torch.workloads.timing import chain_per_iter_seconds, event_ms
from tpu_operator_torch.workloads.topology import PEAK_HBM_GBPS

LANES = 16384  # f32 row width of the probe buffer: 64 KB rows


@dataclass
class MemBwResult:
    ok: bool
    device_kind: str
    platform: str
    size_mb: float
    iters: int
    elapsed_s: float
    gbps: float  # best plausible throughput (max of the two probes)
    copy_gbps: float = 0.0  # K2 bulk copy (K1 tiled copy off the card)
    stream_gbps: float = 0.0  # eager elementwise stream
    peak_gbps: Optional[float] = None
    utilization: Optional[float] = None
    integrity: bool = False
    error: str = ""

    def to_dict(self):
        return {
            "ok": self.ok,
            "device_kind": self.device_kind,
            "platform": self.platform,
            "size_mb": round(self.size_mb, 1),
            "iters": self.iters,
            "elapsed_s": round(self.elapsed_s, 6),
            "gbps": round(self.gbps, 1),
            "copy_gbps": round(self.copy_gbps, 1),
            "stream_gbps": round(self.stream_gbps, 1),
            "peak_gbps": self.peak_gbps,
            "utilization": round(self.utilization, 4)
            if self.utilization is not None
            else None,
            "integrity": self.integrity,
            "error": self.error,
        }


def plain_copy(x: torch.Tensor) -> torch.Tensor:
    """The plain version of both copy kernels."""
    return x.clone()


def _check_buffer(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(
            f"copy takes a (rows, {LANES}) float32 buffer, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("copy takes a contiguous buffer")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"copy runs on cpu or cuda, not {x.device}")


def _tiled(x: torch.Tensor, name: str, entry: str) -> torch.Tensor:
    _check_buffer(x)
    if x.device.type == "cpu":
        return plain_copy(x)
    lib = _build.library()
    out = torch.empty_like(x)
    err = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), x.numel(), _build.stream_ptr(x))
    _build.check(lib, err, name)
    _build.count_launch(name)
    return out


def tiled_copy(x: torch.Tensor) -> torch.Tensor:
    """K1: ``x`` copied through shared memory one 16 KB tile per block."""
    return _tiled(x, "tiled_copy", "tiled_copy_f32")


def tiled_copy_tma(x: torch.Tensor) -> torch.Tensor:
    """K1's tried Hopper design: ``x`` copied in 16 KB tiles by TMA loads
    and stores through a ring of shared-memory stages, by a grid of one
    wave. On no path; timed beside K1."""
    return _tiled(x, "tiled_copy_tma", "tiled_copy_tma_f32")


def bulk_copy(x: torch.Tensor, n_chunks: int = 8) -> torch.Tensor:
    """K2: ``x`` copied as ``n_chunks`` chunks of bulk copies, global to
    shared to global, several pieces in flight per block."""
    _check_buffer(x)
    if x.shape[0] % n_chunks:
        raise ValueError(f"rows={x.shape[0]} not a multiple of n_chunks={n_chunks}")
    if x.device.type == "cpu":
        return plain_copy(x)
    lib = _build.library()
    out = torch.empty_like(x)
    err = lib.bulk_copy(
        x.data_ptr(), out.data_ptr(), x.numel() * 4, n_chunks, _build.stream_ptr(x)
    )
    _build.check(lib, err, "bulk_copy")
    _build.count_launch("bulk_copy")
    return out


def make_copy_fn(rows: int, block_rows: int):
    """The tiled copy of a ``(rows, LANES)`` f32 buffer. ``block_rows`` is
    the reference's tile height; it must divide ``rows`` as there."""
    if rows % block_rows:
        raise ValueError(f"rows={rows} not a multiple of block_rows={block_rows}")

    def copy(x):
        if x.shape[0] != rows:
            raise ValueError(f"copy built for {rows} rows, got {x.shape[0]}")
        return tiled_copy(x)

    return copy


def make_dma_copy_fn(rows: int, n_chunks: int = 8):
    """The whole-buffer copy of a ``(rows, LANES)`` f32 buffer as
    ``n_chunks`` chunks in flight."""
    if rows % n_chunks:
        raise ValueError(f"rows={rows} not a multiple of n_chunks={n_chunks}")

    def copy(x):
        if x.shape[0] != rows:
            raise ValueError(f"copy built for {rows} rows, got {x.shape[0]}")
        return bulk_copy(x, n_chunks)

    return copy


# a bandwidth reading above hardware peak is a broken measurement (a
# timing-sync failure), not a fast card; small tolerance for spec rounding
PLAUSIBILITY_MARGIN = 1.05


def best_plausible_gbps(copy_gbps: float, stream_gbps: float, peak) -> float:
    """The better of the two paths among PHYSICALLY POSSIBLE readings.
    With a known peak, any path measuring above peak*margin is discarded;
    if both are implausible the measurement is invalid and raises — a
    bogus number must never be recorded as a healthy rate."""
    candidates = [g for g in (copy_gbps, stream_gbps) if g > 0]
    if peak:
        candidates = [g for g in candidates if g <= peak * PLAUSIBILITY_MARGIN]
    if not candidates:
        raise RuntimeError(
            f"implausible bandwidth measurement (copy={copy_gbps:.0f}, "
            f"stream={stream_gbps:.0f} GB/s vs peak {peak}); timing sync "
            "failure — rerun"
        )
    return max(candidates)


def probe_rows(size_mb: int, block_rows: int = 32) -> int:
    """Rows of the probe buffer for ``size_mb``: a multiple of 8 chunks of
    ``block_rows`` (32768 rows, 2 GiB, at 2048)."""
    align = 8 * block_rows
    rows = max(align, (size_mb * (1 << 20)) // (LANES * 4))
    return rows - rows % align


def run_membw_probe(
    size_mb: int = 2048,
    block_rows: int = 32,
    iters: int = 16,
    device: Optional[str] = None,
) -> MemBwResult:
    """Measure achieved device-memory bandwidth on one card (``copy_gbps``
    from K2, ``stream_gbps`` from ``x + 1.0``). ``gbps``/``utilization``
    report the better plausible one. On ``cuda`` unless ``device`` says
    otherwise; without a GPU the default raises."""
    dev = resolve_device(device)
    try:
        on_gpu = dev.type == "cuda"
        rows = probe_rows(size_mb, block_rows)
        buf_bytes = rows * LANES * 4

        copy_fn = (
            make_dma_copy_fn(rows, n_chunks=8)
            if on_gpu
            else make_copy_fn(rows, block_rows)
        )

        def stream_fn(v):
            return v + 1.0

        gen = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn((rows, LANES), generator=gen, device=dev, dtype=torch.float32)

        # integrity: the copy must be bit-exact over the WHOLE buffer — a
        # corner probe would miss corruption in 7 of the 8 chunks; the
        # comparison runs on the device and fetches one boolean
        y = copy_fn(x)
        integrity = bool(torch.equal(x, y))
        del y
        if not integrity:
            raise RuntimeError("copy integrity check failed: HBM readback mismatch")

        def force(v):
            if on_gpu:
                torch.cuda.synchronize(dev)
            return float(v[0, :128].sum())

        moved = 2.0 * buf_bytes  # each pass reads + writes the buffer once
        copy_per_iter = chain_per_iter_seconds(copy_fn, x, force, iters)
        copy_gbps = moved / copy_per_iter / 1e9
        stream_per_iter = chain_per_iter_seconds(stream_fn, x, force, iters)
        stream_gbps = moved / stream_per_iter / 1e9

        kind = device_kind(dev)
        gen_tag = device_generation(kind)
        peak = PEAK_HBM_GBPS.get(gen_tag) if gen_tag else None
        gbps = best_plausible_gbps(copy_gbps, stream_gbps, peak)
        util = gbps / peak if peak else None
        return MemBwResult(
            ok=True,
            device_kind=kind,
            platform=dev.type,
            size_mb=buf_bytes / (1 << 20),
            iters=iters,
            elapsed_s=(copy_per_iter + stream_per_iter) * iters,
            gbps=gbps,
            copy_gbps=copy_gbps,
            stream_gbps=stream_gbps,
            peak_gbps=peak,
            utilization=util,
            integrity=integrity,
        )
    except Exception as e:
        return MemBwResult(False, "", "", size_mb, iters, 0.0, 0.0, error=str(e))


def time_copies(size_mb: int = 2048, reps: int = 20) -> dict:
    """K1's, its tried design's, K2's and ``Tensor.copy_``'s mean device
    milliseconds a copy of the probe's ``(probe_rows(size_mb), LANES)`` f32
    buffer on the card (CUDA events over ``reps`` calls), each kernel
    checked bit-exact first."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((probe_rows(size_mb), LANES), generator=gen, device=dev)
    dst = torch.empty_like(x)
    out = {"shape": list(x.shape)}
    for name, wrapper in (("tiled_copy", tiled_copy), ("tiled_copy_tma", tiled_copy_tma),
                          ("bulk_copy", bulk_copy)):
        if not torch.equal(wrapper(x), x):
            raise RuntimeError(f"{name} is not bit-exact")
        out[f"{name}_ms"] = event_ms(lambda: wrapper(x), reps)
    out["copy_ms"] = event_ms(lambda: dst.copy_(x), reps)
    return out


if __name__ == "__main__":
    import json

    print(device_kind(resolve_device()), flush=True)
    print(json.dumps(time_copies()), flush=True)
