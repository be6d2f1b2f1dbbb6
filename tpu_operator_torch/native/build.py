"""Build the native programs of the node agents.

    python -m tpu_operator_torch.native.build [--out DIR]

Three programs from ``csrc/``, each by its own ``g++`` process (all started
together): ``libgpuinfo.so``, the card probe that ``gpuinfo.py`` loads;
``gpu_smoke``, the driver's startup probe; and ``gpu_metricsd``, the metrics
hostengine. They go to ``build/tpu_operator_torch/native/<hash>/`` beside the
package (git-ignored), keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is found where it is. A file lock keeps
concurrent processes from building the same key twice.

Nothing here imports ``torch``: the node agents run without it. Loading the
library (``gpuinfo._load_native``) never compiles; a build happens here, at
first use by a caller that asks for one, or by hand with the command above,
which prints the paths.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpu_operator_torch" / "native"
CXX_FLAGS = ["-O2", "-Wall", "-Wextra", "-std=c++17", "-fPIC"]
LIB_NAME = "libgpuinfo.so"
SMOKE_NAME = "gpu_smoke"
METRICSD_NAME = "gpu_metricsd"
# program -> (sources, flags of its own); every program links libdl for NVML
PROGRAMS = {
    LIB_NAME: (["libgpuinfo.cpp"], ["-shared"]),
    SMOKE_NAME: (["gpu_smoke.cpp", "libgpuinfo.cpp"], []),
    METRICSD_NAME: (["gpu_metricsd.cpp", "libgpuinfo.cpp"], ["-pthread"]),
}
LIBS = ["-ldl"]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(repr(sorted(PROGRAMS.items())).encode())
    for src in sorted(CSRC.glob("*.cpp")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir(root: Optional[str] = None) -> Path:
    """Where this source hash's programs are (or will be) under ``root``."""
    return Path(root or BUILD_ROOT) / source_hash()


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native programs cannot be built")
    return cxx


def cxx_version() -> str:
    """The compiler's first ``--version`` line."""
    out = subprocess.run([find_cxx(), "--version"], capture_output=True, text=True, timeout=60)
    return out.stdout.splitlines()[0] if out.stdout else out.stderr.strip()


def _compile(out_dir: Path) -> None:
    """Compile every program in parallel; each lands under its name only
    once it is whole."""
    cxx = find_cxx()
    procs = []
    for name, (sources, flags) in PROGRAMS.items():
        tmp = out_dir / (name + ".tmp")
        cmd = [cxx, *CXX_FLAGS, *flags, "-o", str(tmp), *(str(CSRC / s) for s in sources), *LIBS]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"== {name}\n{out}")
        else:
            os.replace(tmp, out_dir / name)
    if failed:
        raise RuntimeError("g++ failed:\n" + "\n".join(failed))


def build(root: Optional[str] = None) -> Dict[str, object]:
    """Build the programs of this source hash under ``root`` (the repo's
    ``build/tpu_operator_torch/native`` by default) unless they are there:
    ``{"dir", "paths": {program: path}, "built", "seconds"}``. Raises when
    the compiler fails; there is no fallback."""
    out_dir = build_dir(root)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: str(out_dir / name) for name in PROGRAMS}
    t0 = time.perf_counter()
    built = False
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not all(os.path.exists(p) for p in paths.values()):
                _compile(out_dir)
                built = True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return {"dir": str(out_dir), "paths": paths, "built": built,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("python -m tpu_operator_torch.native.build")
    p.add_argument("--out", default=None, help=f"build root (default {BUILD_ROOT})")
    args = p.parse_args(argv)
    info = build(args.out)
    print(f"{cxx_version()}; built={info['built']} in {info['seconds']:.2f} s")
    for path in info["paths"].values():
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
