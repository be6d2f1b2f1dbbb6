"""The driver container's entrypoint: install the driver's user-space
libraries.

    python -m tpu_operator_torch.operands.driver_installer init|install|uninstall

The counterpart of ``tpu_operator/operands/libtpu_installer.py``. NVIDIA's
driver container builds and loads the kernel module; that cannot be done
here, so this is the user-space half, as libtpu's installer is: copy the
image's newest ``libcuda.so.<version>`` and ``libnvidia-ml.so.<version>``
into the driver root's library directory (where the ``driver`` component
and the CDI writer look), repoint their ``.so.1`` and ``.so`` links
atomically, record ``VERSION`` and remove older versions. ``init``
installs and stays resident until SIGTERM, so the DaemonSet's startupProbe
and preStop hook manage the ``.driver-ctr-ready`` barrier.

A driver's version follows ``.so.`` (``libcuda.so.580.159.03``), and a
payload may hold two drivers' libraries side by side, so the version is
read from the file that was chosen, by a numeric-aware sort.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import re
import signal
import shutil
import sys
import time

from tpu_operator_torch import consts

log = logging.getLogger("gpu-driver-installer")

# where the operand image ships its payload
DEFAULT_SOURCE_DIR = "/opt/nvidia/driver"
# the driver root's library directory the install writes (the first of
# validator/components.DRIVER_LIB_DIRS)
LIB_DIR = "usr/lib64"
LIBRARIES = ("libcuda", "libnvidia-ml")


def _version(path: str, name: str) -> str:
    return os.path.basename(path)[len(name) + len(".so."):]


def version_key(version: str) -> list:
    """Numeric-aware: 580.10.2 > 580.9.1 (a string sort fails once a part
    reaches two digits)."""
    return [
        (0, int(part), "") if part.isdigit() else (1, 0, part)
        for part in re.split(r"[._-]", version)
        if part
    ]


def find_source(source_dir: str, name: str, version: str = "") -> str:
    """The payload's ``<name>.so.<version>``, else its newest
    ``<name>.so.*``."""
    if version:
        exact = os.path.join(source_dir, f"{name}.so.{version}")
        if os.path.exists(exact):
            return exact
    candidates = sorted(
        (p for p in glob.glob(os.path.join(source_dir, f"{name}.so.*")) if not p.endswith(".tmp")),
        key=lambda p: version_key(_version(p, name)),
    )
    if not candidates:
        raise FileNotFoundError(f"no {name}.so.* under {source_dir}")
    return candidates[-1]


def _swap_link(link: str, target: str) -> None:
    """Point ``link`` at ``target`` atomically: running workloads keep the
    version they mapped."""
    tmp = link + ".tmp"
    if os.path.lexists(tmp):
        os.unlink(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)


def install(
    source_dir: str = DEFAULT_SOURCE_DIR,
    driver_root: str = consts.DRIVER_ROOT,
    version: str = "",
) -> str:
    """Install the payload's libraries of one version (``version``, else
    ``libcuda``'s newest) into ``<driver_root>/usr/lib64``; returns the
    version. Raises FileNotFoundError where a library is missing and
    ValueError where the two libraries' versions differ."""
    sources = {"libcuda": find_source(source_dir, "libcuda", version)}
    version = _version(sources["libcuda"], "libcuda")
    sources["libnvidia-ml"] = find_source(source_dir, "libnvidia-ml", version)
    ml_version = _version(sources["libnvidia-ml"], "libnvidia-ml")
    if ml_version != version:
        raise ValueError(f"libnvidia-ml.so.{ml_version} does not match libcuda.so.{version}")
    lib_dir = os.path.join(driver_root, LIB_DIR)
    os.makedirs(lib_dir, exist_ok=True)
    for name, src in sources.items():
        versioned = f"{name}.so.{version}"
        tmp = os.path.join(lib_dir, versioned + ".tmp")
        shutil.copyfile(src, tmp)
        os.replace(tmp, os.path.join(lib_dir, versioned))
        _swap_link(os.path.join(lib_dir, f"{name}.so.1"), versioned)
        _swap_link(os.path.join(lib_dir, f"{name}.so"), f"{name}.so.1")
        # remove older versions, keeping the active one
        for old in glob.glob(os.path.join(lib_dir, f"{name}.so.*")):
            if os.path.basename(old) not in (versioned, f"{name}.so.1"):
                try:
                    os.unlink(old)
                except OSError:
                    pass
    with open(os.path.join(lib_dir, "VERSION"), "w") as f:
        f.write(version + "\n")
    log.info("installed driver libraries %s into %s", version, lib_dir)
    return version


def uninstall(driver_root: str = consts.DRIVER_ROOT) -> None:
    lib_dir = os.path.join(driver_root, LIB_DIR)
    paths = [p for name in LIBRARIES for p in glob.glob(os.path.join(lib_dir, f"{name}.so*"))]
    for path in paths + [os.path.join(lib_dir, "VERSION")]:
        try:
            os.unlink(path)
            log.info("removed %s", path)
        except OSError:
            pass


def main(argv=None) -> int:
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-driver-installer")
    p.add_argument("command", choices=["init", "install", "uninstall"])
    p.add_argument("--source-dir", default=os.environ.get("DRIVER_SOURCE_DIR", DEFAULT_SOURCE_DIR))
    p.add_argument("--driver-root", default=os.environ.get("DRIVER_ROOT", consts.DRIVER_ROOT))
    p.add_argument("--version", default=os.environ.get("DRIVER_VERSION", ""))
    args = p.parse_args(argv)

    if args.command == "uninstall":
        uninstall(args.driver_root)
        return 0

    try:
        install(args.source_dir, args.driver_root, args.version)
    except (FileNotFoundError, ValueError) as e:
        log.error("%s", e)
        return 1
    if args.command == "install":
        return 0

    # init: stay resident; preStop removes the barrier files
    stop = {"flag": False}

    def on_term(*_):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    log.info("driver libraries installed; holding (the startupProbe gates the barrier)")
    while not stop["flag"]:
        time.sleep(5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
