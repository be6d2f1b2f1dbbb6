"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, goes to ``build/tpu_operator_torch/<hash>/`` beside the package
(git-ignored) and is keyed by a hash of the sources (the ``.cu`` files and
the ``.cuh`` headers they share) and flags, so a changed source rebuilds
and an unchanged one loads what is there. A file lock
keeps concurrent processes from building the same key twice.

``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one only where it launches the kernel, never on its plain path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "tpu_operator_torch"
LIB_NAME = "libtpu_operator_torch_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# tiled_copy_tma: K1's tried Hopper design, timed beside K1, on no path
KERNELS = (
    "tiled_copy", "tiled_copy_tma", "bulk_copy", "flash_fwd", "flash_fwd_pipelined",
    "flash_fwd_bf16exp", "flash_softmax_stub", "flash_qk_only", "flash_fwd_paired",
    "flash_fwd_bf16s", "flash_fwd_paired16",
)
launches = {name: 0 for name in KERNELS}

_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(name: str) -> None:
    launches[name] += 1


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _compile(out_dir: Path) -> str:
    """Compile each ``.cu`` in parallel, link them, return the ptxas log."""
    nvcc = find_nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out_dir / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out_dir / LIB_NAME)
    return "\n".join(log)


def bind(lib):
    """Set every C entry's ``argtypes`` and ``restype`` on ``lib``: pointers
    and the stream as ``c_void_p`` (ctypes would cut them to 32 bits
    otherwise), ints as ``c_int``, byte counts as ``c_longlong``."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("tiled_copy_f32", "tiled_copy_tma_f32"):
        getattr(lib, name).argtypes = [vp, vp, i64, vp]
        getattr(lib, name).restype = i32
    lib.bulk_copy.argtypes = [vp, vp, i64, i32, vp]
    lib.bulk_copy.restype = i32
    for name in ("flash_fwd_bf16", "flash_fwd_pipelined", "flash_fwd_bf16exp",
                 "flash_softmax_stub", "flash_fwd_paired", "flash_fwd_bf16s",
                 "flash_fwd_paired16"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
        fn.restype = i32
    lib.flash_qk_only.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]  # no V
    lib.flash_qk_only.restype = i32
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library, built first if this source hash has no
    build yet. Raises when the build fails; there is no fallback."""
    global _lib
    if _lib is not None:
        return _lib
    key = source_hash()
    out_dir = BUILD_ROOT / key
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / LIB_NAME
    t0 = time.perf_counter()
    built = False
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                (out_dir / "ptxas.log").write_text(_compile(out_dir))
                built = True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = bind(ctypes.CDLL(str(so)))
    build_info.update(
        key=key, path=str(so), built=built,
        seconds=time.perf_counter() - t0,
    )
    _lib = lib
    return lib


def check(lib, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch shows only
    in ``cudaGetLastError``, which each entry returns)."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
