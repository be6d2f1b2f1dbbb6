"""Fake-cluster end-to-end: the full operand lifecycle with no k8s.

The port's copy of ``tests/scripts/fake_e2e.py``. It drives the same
sequence as ``end-to-end.sh`` (install → converge → operator restart →
update-clusterpolicy → disable/enable → uninstall) against the in-memory
API server (``main.make_fake_client``) with the simulated kubelet, and
between them the multi-host slice aggregate with one lagging validator
pod, node departure and arrival, and the validator's four parallelism
probes (``ici``, ``ringattn``, ``pipeline``, ``moe``), each of which must
write its ``*-ready`` file.

Where the probes run is explicit. ``main(device=None)`` (or ``"cuda"``)
runs them on the cards, one NCCL rank a card (``--expect-devices`` is
the card count); with no card visible that step fails. ``main(device=
"cpu")`` runs them on the CPU in a gloo world of two ranks with
``--allow-cpu``. The reference forces an 8-device virtual CPU mesh
instead; two ranks keep the CPU run inside the tier-1 budget, as the
validator's own CPU tests do, since each rank here is a process.

Run: ``python -m tpu_operator_torch.e2e.fake_e2e [--device cpu]`` (exit 0
and ``FAKE-E2E PASSED``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

CP = "tpu.k8s.io/v1"
PROBES = ("ici", "ringattn", "pipeline", "moe")
CPU_RANKS = 2


def probe_args(device: Optional[str]) -> List[str]:
    """The validator flags that place the probes: the cards for ``None``
    or ``"cuda"``, two gloo ranks for ``"cpu"``."""
    if device == "cpu":
        return ["--allow-cpu", "--expect-devices", str(CPU_RANKS)]
    if device not in (None, "cuda"):
        raise ValueError(f"device must be None, 'cuda' or 'cpu', not {device!r}")
    import torch

    cards = torch.cuda.device_count()
    if cards < 1:
        raise SystemExit("parallelism probes: no card visible (pass device='cpu' for the CPU)")
    return ["--expect-devices", str(cards)]


def main(device: Optional[str] = None, probe_dir: Optional[str] = None) -> int:
    """The whole sequence; 0 when every step held. ``probe_dir`` keeps the
    probes' status files there (a temporary directory otherwise)."""
    from tpu_operator_torch import consts

    os.environ.setdefault(consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
    os.environ.setdefault("UNIT_TEST", "true")
    ns = os.environ[consts.OPERATOR_NAMESPACE_ENV]

    from tpu_operator_torch.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler,
    )
    from tpu_operator_torch.kube.testing import (
        make_gpu_node,
        make_validator_pod,
        simulate_kubelet_once,
        wait_for,
    )
    from tpu_operator_torch.main import make_fake_client
    from tpu_operator_torch.validator import main as vmain

    client = make_fake_client()
    reconciler = ClusterPolicyReconciler(client)

    def converge(max_rounds=30):
        for _ in range(max_rounds):
            res = reconciler.reconcile()
            simulate_kubelet_once(client, ns)
            if res.ready:
                return res
        return res

    def ds_names():
        return {d["metadata"]["name"] for d in client.list("apps/v1", "DaemonSet", ns)}

    exporter_ds = consts.OPERAND_APPS["tpu-metrics-exporter"]

    print("=== install-operator (reconcile to Ready)")
    res = converge()
    assert res.ready, f"never converged: {res}"
    cp = client.get(CP, "ClusterPolicy", "cluster-policy")
    assert cp["status"]["state"] == "ready", cp["status"]

    print("=== verify-operator (DaemonSets present)")
    names = ds_names()
    for reference_name in (
        "tpu-libtpu-daemonset",
        "tpu-device-plugin-daemonset",
        "tpu-operator-validator",
        "tpu-feature-discovery",
        "tpu-metrics-exporter",
    ):
        expected = consts.OPERAND_APPS[reference_name]
        assert expected in names, f"{expected} missing from {sorted(names)}"

    print("=== verify-operand-restarts (reconciler restart keeps operands)")
    uids_before = {
        d["metadata"]["name"]: d["metadata"].get("uid")
        for d in client.list("apps/v1", "DaemonSet", ns)
    }
    ClusterPolicyReconciler(client).reconcile()  # fresh process analogue
    uids_after = {
        d["metadata"]["name"]: d["metadata"].get("uid")
        for d in client.list("apps/v1", "DaemonSet", ns)
    }
    assert uids_before == uids_after, "operands churned on operator restart"

    print("=== update-clusterpolicy (disable metricsExporter)")
    cp = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
    cp["spec"]["metricsExporter"]["enabled"] = False
    client.update(cp)
    converge()
    assert exporter_ds not in ds_names(), "exporter not deleted on disable"

    print("=== enable-operands (re-enable metricsExporter)")
    cp = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
    cp["spec"]["metricsExporter"]["enabled"] = True
    client.update(cp)
    res = converge()
    assert res.ready
    assert exporter_ds in ds_names()

    print("=== slice-readiness (multi-host aggregate: all-hosts-or-nothing)")
    for i in range(2):
        client.create(
            make_gpu_node(
                f"vp-host-{i}",
                extra_labels={
                    consts.GKE_NODEPOOL_LABEL: "vp-pool",
                    consts.TFD_SLICE_HOSTS_LABEL: "2",
                    consts.TFD_WORKER_ID_LABEL: str(i),
                },
            )
        )

    def validator_pod(node, ready):
        if client.get_or_none("v1", "Pod", f"val-{node}", ns) is not None:
            client.delete("v1", "Pod", f"val-{node}", ns)
        client.create(make_validator_pod(node, ready, ns))

    validator_pod("vp-host-0", True)
    validator_pod("vp-host-1", False)  # one host lags: slice must be degraded
    converge()
    cp = client.get(CP, "ClusterPolicy", "cluster-policy")
    slices = cp["status"]["slices"]
    assert "vp-pool" in slices.get("degraded", []), slices
    n0 = client.get("v1", "Node", "vp-host-0")
    # not-ready shows as label ABSENCE on a never-ready slice ("false" is
    # only written on a real true→false flip; the scheduler gate selects
    # on "true" either way)
    assert n0["metadata"]["labels"].get(consts.SLICE_READY_LABEL) != "true", (
        "a slice with a lagging host must not be ready on ANY member"
    )

    validator_pod("vp-host-1", True)  # last host validates → slice flips
    converge()
    cp = client.get(CP, "ClusterPolicy", "cluster-policy")
    assert "vp-pool" not in cp["status"]["slices"].get("degraded", [])
    for i in range(2):
        node = client.get("v1", "Node", f"vp-host-{i}")
        assert node["metadata"]["labels"][consts.SLICE_READY_LABEL] == "true"
    print("ok: slice aggregate degraded→ready")

    # clean up the slice nodes so the node-departure step below still
    # exercises the zero-GPU-node posture
    for i in range(2):
        # node deletion GCs the bound validator pod
        client.delete("v1", "Node", f"vp-host-{i}")
        assert client.get_or_none("v1", "Pod", f"val-vp-host-{i}", ns) is None

    print("=== node-departure (last GPU node removed → 45s NFD-poll posture)")
    client.delete("v1", "Node", "fake-gpu-node-1")
    res = reconciler.reconcile()
    # reference semantics (clusterpolicy_controller.go:169-182): with no
    # NFD-labelled node left the CR drops to notReady and polls at 45s
    assert not res.ready and res.requeue_after == 45.0, res

    print("=== node-arrival (GPU node joins → back to Ready)")
    client.create(make_gpu_node("fake-gpu-node-1"))
    res = converge()
    assert res.ready, f"did not recover on node arrival: {res}"

    where = "the CPU, 2 gloo ranks" if device == "cpu" else "the cards over NCCL"
    print(f"=== parallelism-probes (ici/ringattn/pipeline/moe on {where})")
    placement = probe_args(device)
    with tempfile.TemporaryDirectory(prefix="fake-e2e-val-") as tmp:
        out_dir = probe_dir or tmp
        for component in PROBES:
            rc = vmain.main(
                ["--component", component, "--output-dir", out_dir,
                 "--ringattn-seq-len", "256", *placement]
            )
            assert rc == 0, f"{component} probe failed"
            assert os.path.exists(os.path.join(out_dir, f"{component}-ready"))
    print(f"ok: all parallelism probes passed on {where}")

    print("=== uninstall (delete CR → operands garbage-collected by ownerRef)")
    client.delete(CP, "ClusterPolicy", "cluster-policy")
    # the fake client implements ownerRef cascade like the API server's GC
    wait_for(
        "operand GC",
        lambda: not client.list("apps/v1", "DaemonSet", ns),
        timeout_s=10,
    )

    print("FAKE-E2E PASSED")
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m tpu_operator_torch.e2e.fake_e2e")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the parallelism probes run (default: the cards)")
    sys.exit(main(parser.parse_args().device))
