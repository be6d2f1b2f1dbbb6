"""The validator's workload pods find the validator DaemonSet by the port's
name (``consts.VALIDATOR_APP``, ``gpu-operator-validator``), as the
reference's find ``tpu-operator-validator``.

Each side's state machine renders and applies its own validator DaemonSet
from its own assets into a ``FakeClient`` (the paired worlds of
``tests/test_torch_state_machine.py``); then ``gang_epoch`` must name that
DaemonSet's uid and generation, and the matmul pod (``run_to_completion``)
and the slice gang's Service and pods (``run_slice_gang``) must carry an
owner reference to it. The two sides agree through
``convert.operand_app_from_reference``. Tolerance: exact equality.
"""

import threading
import time

from tests.test_torch_state_machine import NS, SIDES, make_ctrl, run_all_states
from tpu_operator.validator import workload_pods as ref_wp
from tpu_operator_torch import consts, convert
from tpu_operator_torch.validator import workload_pods as wp

WORKLOAD_PODS = {"reference": (ref_wp, ref_wp.jax_workload_pod), "port": (wp, wp.cuda_workload_pod)}


def _finish_pods(client, phase="Succeeded"):
    """The kubelet's part: every workload pod (one with a spec that is not
    yet Running, unlike the operand pods) runs on its node and ends
    ``phase``."""
    stop = threading.Event()

    def run():
        while not stop.is_set():
            for pod in client.list("v1", "Pod", NS):
                if "spec" in pod and (pod.get("status") or {}).get("phase") not in (phase, "Running"):
                    pod["spec"]["nodeName"] = (pod["spec"].get("nodeSelector") or {}).get(
                        "kubernetes.io/hostname", "node")
                    pod["status"] = {"phase": phase}
                    client.update_status(pod)
            time.sleep(0.01)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return stop, t


def _script(side_name, monkeypatch):
    side = SIDES[side_name]
    mod, factory = WORKLOAD_PODS[side_name]
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    c = make_ctrl(side)
    run_all_states(c, side)
    client = c.client
    validators = [d for d in client.list("apps/v1", "DaemonSet", NS)
                  if d["metadata"]["name"].endswith("operator-validator")]
    assert len(validators) == 1
    ds = validators[0]["metadata"]
    epoch = mod.gang_epoch(client, NS)
    stop, t = _finish_pods(client)
    try:
        pod = factory("tpu-node-1", NS)
        mod.run_to_completion(client, pod, retries=200, sleep_s=0.01)
        owned = client.get("v1", "Pod", pod["metadata"]["name"], NS)["metadata"]["ownerReferences"]
        out = mod.run_slice_gang(client, NS, "s-1", [("tpu-node-1", "8")], retries=200, sleep_s=0.01)
    finally:
        stop.set()
        t.join(timeout=10)
    svc = client.get("v1", "Service", mod.gang_name("s-1"), NS)["metadata"]["ownerReferences"]
    gang = client.get("v1", "Pod", f"{mod.gang_name('s-1')}-0", NS)["metadata"]
    return {
        "ds": ds["name"],
        "epoch": epoch == f"{(ds.get('uid') or 'x')[:8]}-{ds.get('generation', 0)}" and bool(epoch),
        "owners": [(o["kind"], o["name"], o["uid"] == ds.get("uid")) for o in owned + svc
                   + gang["ownerReferences"]],
        "gang_epoch_label": gang["labels"][mod.GANG_EPOCH_LABEL] == epoch,
        "gang": out["result"],
    }


def test_gang_epoch_and_owners_find_each_side_s_validator(monkeypatch):
    ref = _script("reference", monkeypatch)
    port = _script("port", monkeypatch)
    assert port["ds"] == consts.VALIDATOR_APP == "gpu-operator-validator"
    assert ref["ds"] == "tpu-operator-validator"
    mapped = dict(ref, ds=convert.operand_app_from_reference(ref["ds"]),
                  owners=[(k, convert.operand_app_from_reference(n), same) for k, n, same in ref["owners"]])
    assert port == mapped
    assert port["epoch"] and port["gang_epoch_label"] and port["gang"] == "Succeeded"
    assert port["owners"] == [("DaemonSet", "gpu-operator-validator", True)] * 3
