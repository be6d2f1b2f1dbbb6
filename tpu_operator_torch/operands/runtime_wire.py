"""The container toolkit's slot: keep the CDI spec fresh.

    python -m tpu_operator_torch.operands.runtime_wire [--once]

The counterpart of ``tpu_operator/operands/runtime_wire.py``. Where
NVIDIA's toolkit rewrites the containerd, docker or cri-o configuration and
installs a runtime hook, this path is CDI first: it writes the CDI spec for
every card in the chip table (``plugin/cdi.py``) and writes it again when
the set of cards or the partition file's mtime changes. For a containerd
without CDI enabled it drops a snippet that enables it. ``toolkit-ready``
(the reference's ``runtime-ready``) says the spec is live; SIGTERM removes
it.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.plugin import cdi
from tpu_operator_torch.validator.components import StatusFiles

log = logging.getLogger("gpu-runtime-wire")

CONTAINERD_SNIPPET = """\
# Installed by tpu-operator (runtime wire): enables CDI injection.
[plugins."io.containerd.grpc.v1.cri"]
  enable_cdi = true
  cdi_spec_dirs = ["/etc/cdi", "/var/run/cdi"]
"""
SNIPPET_NAME = "nvidia-cdi.toml"


def wire_once(
    cdi_output: str,
    dev_root: str = "/dev",
    driver_root: str = consts.DRIVER_ROOT,
    containerd_conf_dir: str = "",
    chips: Optional[list] = None,
    partition_file: str = cdi.DEFAULT_PARTITION_FILE,
) -> dict:
    """Write the CDI spec (and the containerd snippet once); returns it."""
    spec = cdi.write_spec(
        cdi_output,
        dev_root=dev_root,
        driver_root=driver_root,
        chips=chips,
        partition_file=partition_file,
    )
    if containerd_conf_dir:
        os.makedirs(containerd_conf_dir, exist_ok=True)
        snippet = os.path.join(containerd_conf_dir, SNIPPET_NAME)
        if not os.path.exists(snippet):
            with open(snippet, "w") as f:
                f.write(CONTAINERD_SNIPPET)
            log.info("wrote containerd CDI snippet %s", snippet)
    return spec


def wire_pass(
    status: StatusFiles,
    cdi_output: str,
    last: Optional[tuple] = None,
    dev_root: str = "/dev",
    driver_root: str = consts.DRIVER_ROOT,
    containerd_conf_dir: str = "",
    partition_file: str = cdi.DEFAULT_PARTITION_FILE,
) -> tuple:
    """One pass of the loop: rewrite the spec and ``toolkit-ready`` where
    the cards' nodes or the partition file's mtime differ from ``last``;
    returns this pass's signature."""
    try:
        part_mtime = os.stat(partition_file).st_mtime
    except OSError:
        part_mtime = 0.0
    chips = gpuinfo.chip_summary(dev_root)
    # a repartition must refresh the spec too
    sig = (tuple(c.get("path", "") for c in chips), part_mtime)
    if sig != last:
        wire_once(
            cdi_output,
            dev_root=dev_root,
            driver_root=driver_root,
            containerd_conf_dir=containerd_conf_dir,
            chips=chips,
            partition_file=partition_file,
        )
        status.write(consts.STATUS_FILE_TOOLKIT, {"cdiSpec": cdi_output, "chips": len(chips)})
        log.info("CDI spec refreshed for %d cards", len(chips))
    return sig


def main(argv=None) -> int:
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-runtime-wire")
    p.add_argument("--cdi-output", default=os.environ.get("CDI_SPEC_PATH", cdi.DEFAULT_SPEC_PATH))
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--driver-root", default=os.environ.get("DRIVER_ROOT", consts.DRIVER_ROOT))
    p.add_argument(
        "--containerd-conf-dir",
        default=os.environ.get("CONTAINERD_CONF_DIR", ""),
        help="also drop a containerd conf.d snippet enabling CDI",
    )
    p.add_argument(
        "--output-dir", default=os.environ.get("VALIDATION_OUTPUT_DIR", consts.VALIDATION_DIR)
    )
    p.add_argument("--interval", type=float, default=30.0)
    p.add_argument("--once", action="store_true")
    args = p.parse_args(argv)
    status = StatusFiles(args.output_dir)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

    last = None
    while True:
        try:
            last = wire_pass(
                status,
                args.cdi_output,
                last,
                dev_root=args.dev_root,
                driver_root=args.driver_root,
                containerd_conf_dir=args.containerd_conf_dir,
            )
        except Exception:
            log.exception("wire pass failed")
        if args.once or stop.wait(args.interval):
            break
    if stop.is_set():
        status.remove(consts.STATUS_FILE_TOOLKIT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
