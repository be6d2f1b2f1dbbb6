"""/dev/char symlinks for the card's device nodes.

The counterpart of ``tpu_operator/operands/devchar.py`` (the reference's
``createDevCharSymlinks``, ``validator/main.go:681-708``): systemd rebuilds
cgroup device allow-lists from ``/dev/char`` on daemon-reload, and a device
node without its char symlink silently loses container access. The driver
validation makes one ``<major>:<minor>`` link for every NVIDIA node and VFIO
group, gated by ``DISABLE_DEV_CHAR_SYMLINK_CREATION`` like the reference.
"""

from __future__ import annotations

import glob
import logging
import os
import stat
from typing import List, Tuple

log = logging.getLogger("tpu-validator")

DISABLE_ENV = "DISABLE_DEV_CHAR_SYMLINK_CREATION"
DEV_CHAR_PATH = "/dev/char"
DEVICE_GLOBS = (
    "nvidia[0-9]*",
    "nvidiactl",
    "nvidia-uvm",
    "nvidia-uvm-tools",
    "nvidia-modeset",
    "nvidia-caps/*",
    "vfio/*",
)


def _char_devices(dev_root: str = "/dev") -> List[Tuple[str, int, int]]:
    """(path, major, minor) for every card-related char device node."""
    out = []
    for pattern in DEVICE_GLOBS:
        for path in sorted(glob.glob(os.path.join(dev_root, pattern))):
            try:
                st = os.stat(path)
            except OSError:
                continue
            if not stat.S_ISCHR(st.st_mode):
                continue
            rdev = st.st_rdev
            out.append((path, os.major(rdev), os.minor(rdev)))
    return out


def create_dev_char_symlinks(
    dev_root: str = "/dev", dev_char_path: str = DEV_CHAR_PATH
) -> List[str]:
    """Best-effort: a failure to link must not fail validation (the bug
    only bites on systemd daemon-reload; the node is otherwise usable).
    A link to another node is repointed; a real node at the link's name is
    left alone. Returns the list of created link paths."""
    created = []
    devices = _char_devices(dev_root)
    if not devices:
        return created
    try:
        os.makedirs(dev_char_path, exist_ok=True)
    except OSError:
        log.warning("cannot create %s; skipping dev-char symlinks", dev_char_path)
        return created
    for path, major, minor in devices:
        link = os.path.join(dev_char_path, f"{major}:{minor}")
        try:
            if os.path.islink(link):
                if os.readlink(link) == path:
                    continue
                os.unlink(link)  # repoint a stale link
            elif os.path.exists(link):
                continue  # a real node already provides the mapping
            os.symlink(path, link)
            created.append(link)
        except OSError as e:
            log.warning("dev-char symlink %s -> %s failed: %s", link, path, e)
    if created:
        log.info("created %d %s symlinks", len(created), dev_char_path)
    return created
