"""The slice manager: the mig-manager slot, over whole cards.

    python -m tpu_operator_torch.sliceman --node-name <node> [--once]

The counterpart of ``tpu_operator/sliceman/slice_manager.py``. It

* watches ``tpu.k8s.io/tpu.slice.config`` for a named profile of the
  layouts file (``slice-configs``, the reference's format);
* partitions the host's cards into subslices: a subslice is a group of
  whole cards inside one NVLink domain, advertised by the device plugin as
  ``nvidia.com/mig-<shape>`` (``plugin/manager.py``). The partition is
  logical, as the reference's is: "apply" writes the partition file the
  device plugin and the CDI writer read, and regenerates the CDI spec with
  one composite device a subslice. No MIG profile is applied; switching a
  card into MIG needs root and a card reset;
* pauses the cards' clients first by flipping their deploy labels to
  ``paused-for-slice-config`` and restores them afterwards;
* reports through ``tpu.k8s.io/tpu.slice.config.state`` ∈
  pending|success|failed, the contract of the control plane's
  repartition controller, which writes the config label.

A subslice's cards are named by their ids, the minor numbers of
``/dev/nvidiaN``, never by mesh positions: the ids a host has may be 1, 3,
5 and 7, and the partition file's readers key by id. Mesh position p is
the p-th card in (NVLink domain, id) order, so a mesh row is a domain.
PyYAML is imported only by the functions that read the layouts.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.controllers.state_manager import node_generation
from tpu_operator_torch.kube.client import ConflictError, mutate_with_retry
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.workloads import topology as topo

log = logging.getLogger("gpu-slice-manager")

STATE_PENDING = "pending"
STATE_SUCCESS = "success"
STATE_FAILED = "failed"

DEFAULT_PARTITION_FILE = consts.PARTITION_FILE
PAUSED_VALUE = "paused-for-slice-config"


def _load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_slice_configs(path: str) -> Dict[str, List[dict]]:
    configs = _load_yaml(path).get("slice-configs", {})
    if not isinstance(configs, dict) or not configs:
        raise ValueError(f"{path}: no slice-configs")
    return configs


def load_chip_clients(path: str) -> List[str]:
    try:
        return list(_load_yaml(path).get("kubernetes-labels", []) or [])
    except OSError:
        return []


def resolve_shape(profile: List[dict], host_topology: str) -> Optional[str]:
    """Profile entries -> a subslice shape, or None for unpartitioned."""
    for entry in profile:
        if not entry.get("partitioned", False):
            return None
        layout = entry.get("layout", {}) or {}
        shape = layout.get("shape", "")
        if shape == "host":
            return host_topology
        if shape:
            return shape
    return None


def compute_partitions(
    host_topology: str, generation: str, shape: Optional[str], chips: List[dict]
) -> dict:
    """The partition state the device plugin and the CDI writer read.
    ``chips`` is the chip table. Raises ValueError where the topology's
    card count is not the table's, the shape does not tile the topology,
    or a subslice's cards span NVLink domains."""
    if shape is None:
        return {"partitioned": False, "subslices": []}
    cards = {c["index"]: c for c in chips}
    by_position = sorted(cards, key=lambda i: (cards[i].get("nvlink_domain", 0), i))
    if topo.chip_count(host_topology) != len(by_position):
        raise ValueError(
            f"topology {host_topology} has {topo.chip_count(host_topology)} cards; "
            f"the chip table has {len(by_position)}: {sorted(cards)}"
        )
    dims = topo.parse_topology(host_topology)
    subslices = []
    for i, tile in enumerate(topo.enumerate_subslices(host_topology, topo.parse_topology(shape))):
        ids = sorted(by_position[topo.coord_to_index(c, dims)] for c in tile.coords())
        if not topo.contiguous(ids, cards):
            raise ValueError(f"subslice {i} ({tile.name()}) spans NVLink domains: cards {ids}")
        subslices.append(
            {
                "id": i,
                "shape": tile.name(),
                "chips": ids,
                "resource": consts.MIG_RESOURCE_PREFIX + tile.name(),
            }
        )
    return {
        "partitioned": True,
        "topology": host_topology,
        "generation": generation,
        "shape": shape,
        "subslices": subslices,
    }


def write_partition_state(state: dict, path: str = DEFAULT_PARTITION_FILE) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def read_partition_state(path: str = DEFAULT_PARTITION_FILE) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class SliceManager:
    def __init__(
        self,
        client,
        node_name: str,
        config_file: str,
        chip_clients_file: str = "",
        partition_file: str = DEFAULT_PARTITION_FILE,
        cdi_spec_path: str = "",
        dev_root: str = "/dev",
        driver_root: str = consts.DRIVER_ROOT,
    ):
        self.client = client
        self.node_name = node_name
        self.config_file = config_file
        self.chip_clients_file = chip_clients_file
        self.partition_file = partition_file
        self.cdi_spec_path = cdi_spec_path
        self.dev_root = dev_root
        self.driver_root = driver_root
        self._applied: Optional[str] = None

    # ------------------------------------------------------------------
    def _node(self) -> dict:
        return self.client.get("v1", "Node", self.node_name)

    def _mutate_labels(self, mutate) -> None:
        """Apply ``mutate(labels) -> bool(changed)`` under optimistic
        concurrency: other writers (the control plane's deploy labels,
        feature discovery) share the Node, so a 409 means re-GET and
        re-apply, not failure."""
        mutate_with_retry(
            self.client,
            "v1",
            "Node",
            self.node_name,
            mutate=lambda node: mutate(node["metadata"].setdefault("labels", {})),
        )

    def _set_state(self, value: str) -> None:
        def mutate(labels: dict) -> bool:
            if labels.get(consts.SLICE_CONFIG_STATE_LABEL) == value:
                return False
            labels[consts.SLICE_CONFIG_STATE_LABEL] = value
            return True

        self._mutate_labels(mutate)

    def _pause_clients(self, pause: bool) -> None:
        """Flip the cards' clients' deploy labels so their DaemonSets
        release the cards during the repartition."""
        client_labels = load_chip_clients(self.chip_clients_file)
        if not client_labels:
            return

        def mutate(labels: dict) -> bool:
            changed = False
            for key in client_labels:
                if pause and labels.get(key) == "true":
                    labels[key] = PAUSED_VALUE
                    changed = True
                elif not pause and labels.get(key) == PAUSED_VALUE:
                    labels[key] = "true"
                    changed = True
            return changed

        self._mutate_labels(mutate)

    # ------------------------------------------------------------------
    def apply_config(self, config_name: str) -> dict:
        configs = load_slice_configs(self.config_file)
        if config_name not in configs:
            raise ValueError(f"unknown slice config {config_name!r}")
        node = self._node()
        labels = node["metadata"].get("labels", {}) or {}
        chips = gpuinfo.chip_summary(self.dev_root)
        # feature discovery's NVLink-domain string; else one domain of
        # every visible card
        host_topology = labels.get(consts.TFD_TOPOLOGY_LABEL)
        if not host_topology:
            if not chips:
                raise RuntimeError("no topology label and no visible cards")
            host_topology = f"1x{len(chips)}"
        shape = resolve_shape(configs[config_name], host_topology)
        state = compute_partitions(host_topology, node_generation(node) or "", shape, chips)
        state["config"] = config_name
        write_partition_state(state, self.partition_file)
        if self.cdi_spec_path:
            self._regenerate_cdi(chips)
        return state

    def _regenerate_cdi(self, chips: List[dict]) -> None:
        # build_spec reads the partition file just written, so the subslice
        # composites land in the spec the runtime wire also maintains: both
        # writers produce the same content
        from tpu_operator_torch.plugin import cdi

        cdi.write_spec(
            self.cdi_spec_path,
            dev_root=self.dev_root,
            driver_root=self.driver_root,
            chips=chips,
            partition_file=self.partition_file,
        )

    # ------------------------------------------------------------------
    def reconcile_once(self) -> Optional[str]:
        """One pass of the label FSM; returns the state written (or None)."""
        node = self._node()
        labels = node["metadata"].get("labels", {}) or {}
        want = labels.get(consts.SLICE_CONFIG_LABEL)
        if not want:
            return None
        # clients still paused (a pass died or hit 409s between apply and
        # unpause) veto the early return: the re-apply is idempotent and
        # retries the unpause
        paused = any(
            labels.get(k) == PAUSED_VALUE for k in load_chip_clients(self.chip_clients_file)
        )
        if (
            want == self._applied
            and labels.get(consts.SLICE_CONFIG_STATE_LABEL) == STATE_SUCCESS
            and not paused
        ):
            return STATE_SUCCESS
        try:
            self._set_state(STATE_PENDING)
            self._pause_clients(True)
            self.apply_config(want)
            self._applied = want
            self._set_state(STATE_SUCCESS)
            result = STATE_SUCCESS
        except ConflictError:
            # a write race that outlasted the retries is transient: the
            # next pass reconciles again; FAILED would misreport the node
            log.warning("slice config %r hit persistent 409s; retrying", want)
            result = None
        except Exception:
            log.exception("slice config %r failed", want)
            try:
                self._set_state(STATE_FAILED)
            except ConflictError:
                log.warning("failed-state write hit 409s; next pass retries")
            result = STATE_FAILED
        try:
            self._pause_clients(False)
        except ConflictError:
            # clients stay paused for now; the paused veto above makes the
            # next pass retry the unpause
            log.warning("unpause hit persistent 409s; next pass retries")
        return result

    def run_loop(self, interval_s: float = 15.0, once: bool = False) -> None:
        while True:
            try:
                self.reconcile_once()
            except Exception:
                log.exception("slice reconcile pass failed")
            if once:
                return
            time.sleep(interval_s)


def main(argv=None) -> int:
    import argparse

    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-slice-manager")
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument(
        "--config-file", default=os.environ.get("SLICE_CONFIG_FILE", "/slice-config/config.yaml")
    )
    p.add_argument(
        "--chip-clients-file",
        default=os.environ.get("CHIP_CLIENTS_FILE", "/chip-clients/clients.yaml"),
    )
    p.add_argument("--partition-file", default=DEFAULT_PARTITION_FILE)
    # the CDI spec is regenerated only where the control plane passes its
    # path (CDI enabled); an empty default writes no host spec
    p.add_argument("--cdi-spec", default=os.environ.get("CDI_SPEC_PATH", ""))
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--driver-root", default=os.environ.get("DRIVER_ROOT", consts.DRIVER_ROOT))
    p.add_argument("--interval", type=float, default=15.0)
    p.add_argument("--once", action="store_true")
    args = p.parse_args(argv)
    if not args.node_name:
        log.error("NODE_NAME required")
        return 1
    from tpu_operator_torch.kube.incluster import InClusterClient

    SliceManager(
        InClusterClient(),
        args.node_name,
        config_file=args.config_file,
        chip_clients_file=args.chip_clients_file,
        partition_file=args.partition_file,
        cdi_spec_path=args.cdi_spec,
        dev_root=args.dev_root,
        driver_root=args.driver_root,
    ).run_loop(interval_s=args.interval, once=args.once)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
