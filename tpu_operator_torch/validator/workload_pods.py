"""Validation workload pods.

The counterpart of ``tpu_operator/validator/workload_pods.py``: a matmul
pod (the ``cuda --with-workload`` path), a one-card device-count pod (the
``plugin --with-workload`` path) and the slice gang, one pod a member host,
each owner-ref'd to the validator DaemonSet so cluster GC reaps it. The
pods request ``nvidia.com/gpu`` and run PyTorch on ``cuda``.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
import time
from typing import Optional

from tpu_operator_torch import consts

log = logging.getLogger("tpu-validator")

POLL_RETRIES = 60  # reference validator/main.go:158-161
POLL_SLEEP_S = 5

# a bf16 product with an f32 result, as the reference's
# preferred_element_type=float32 gives
CUDA_MATMUL_SCRIPT = (
    "import torch; "
    "assert torch.cuda.is_available(), 'expected CUDA, found no GPU'; "
    "a = torch.ones((1024, 1024), dtype=torch.bfloat16, device='cuda'); "
    "out = torch.mm(a, a, out_dtype=torch.float32); "
    "torch.cuda.synchronize(); "
    "assert out.dtype == torch.float32 and float(out[0, 0]) == 1024.0, (out.dtype, float(out[0, 0])); "
    "print('CUDA matmul OK on', torch.cuda.get_device_name(0))"
)

PLUGIN_SMOKE_SCRIPT = (
    "import torch; n = torch.cuda.device_count(); "
    "assert torch.cuda.is_available() and n > 0, 'expected CUDA, found no GPU'; "
    "print(n, 'GPU device(s) visible')"
)

# Coordinated multi-host startup proof: every gang member joins one NCCL
# process group off the injected env (env:// reads MASTER_ADDR, MASTER_PORT,
# WORLD_SIZE and RANK) and all-gathers across it, so one host failing to
# join fails every member: the acceptance semantics of a multi-host slice.
# Unlike the reference's script, which never checks the platform, it
# requires CUDA: each member runs on its pod's first card.
SLICE_GANG_SCRIPT = (
    "import os, torch, torch.distributed as dist; "
    "assert torch.cuda.is_available(), 'expected CUDA, found no GPU'; "
    "torch.cuda.set_device(0); "
    "dist.init_process_group('nccl', init_method='env://'); "
    "world = dist.get_world_size(); "
    "x = torch.full((4,), float(dist.get_rank()), device='cuda'); "
    "g = [torch.empty_like(x) for _ in range(world)]; "
    "dist.all_gather(g, x); "
    "torch.cuda.synchronize(); "
    "want = int(os.environ['TPU_SLICE_HOSTS']); "
    "assert world == want, (world, want); "
    "assert all(bool((t == r).all()) for r, t in enumerate(g)), g; "
    "print('slice gang OK:', dist.get_rank(), '/', world); "
    "dist.destroy_process_group()"
)

GANG_PORT = 29500  # the process group's rendezvous port (torch's default)

# epoch label: ties a gang to the validator DaemonSet revision that
# spawned it, so a follower cannot converge on a STALE gang's Succeeded
# pods from before a re-roll (the leader is about to replace them)
GANG_EPOCH_LABEL = f"{consts.GROUP}/gang-epoch"


def _image(image: str) -> str:
    return image or os.environ.get("CUDA_WORKLOAD_IMAGE", consts.DEFAULT_CUDA_WORKLOAD_IMAGE)


def _workload_pod(name: str, node_name: str, namespace: str, script: str, image: str) -> dict:
    # pull policy/secrets follow the validator's own, injected by the
    # operator (reference controllers/object_controls.go:1906-1912)
    pull_policy = os.environ.get("CUDA_WORKLOAD_PULL_POLICY", "IfNotPresent")
    pull_secrets = [
        {"name": s}
        for s in os.environ.get("CUDA_WORKLOAD_PULL_SECRETS", "").split(",")
        if s
    ]
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {"app": name},
        },
        "spec": {
            "restartPolicy": "Never",
            "nodeName": node_name,
            "runtimeClassName": None,  # filled by operator policy if needed
            "tolerations": [
                {
                    "key": consts.GPU_RESOURCE,
                    "operator": "Exists",
                    "effect": "NoSchedule",
                }
            ],
            "imagePullSecrets": pull_secrets,
            "containers": [
                {
                    "name": name,
                    "image": image,
                    "imagePullPolicy": pull_policy,
                    "command": ["python3", "-c", script],
                    "resources": {
                        "limits": {consts.GPU_RESOURCE: "1"},
                        "requests": {consts.GPU_RESOURCE: "1"},
                    },
                }
            ],
        },
    }


def _per_node_name(base: str, node_name: str) -> str:
    """Pod name unique PER NODE: every node's validator spawns its own
    workload pod into the shared operator namespace, and a fixed name
    would make concurrent bring-up delete each other's in-flight pods.
    Sanitized + length-bounded (DNS-1123), with a short hash so
    truncation cannot collide."""
    safe = re.sub(r"[^a-z0-9-]", "-", node_name.lower()).strip("-")
    suffix = hashlib.sha1(node_name.encode()).hexdigest()[:5]
    # the name doubles as the pod's `app` label value: stay under the
    # 63-char label limit (longest base 20 + 1 + 30 + 1 + 5 = 57)
    return f"{base}-{safe[:30].rstrip('-')}-{suffix}"


def cuda_workload_pod(node_name: str, namespace: str, image: str = "") -> dict:
    return _workload_pod(
        _per_node_name("tpu-cuda-validator", node_name),
        node_name,
        namespace,
        CUDA_MATMUL_SCRIPT,
        _image(image),
    )


def plugin_workload_pod(node_name: str, namespace: str, image: str = "") -> dict:
    return _workload_pod(
        _per_node_name("tpu-plugin-validator", node_name),
        node_name,
        namespace,
        PLUGIN_SMOKE_SCRIPT,
        _image(image),
    )


def gang_epoch(client, namespace: str) -> str:
    """Current gang epoch: the validator DaemonSet's (``consts.VALIDATOR_APP``)
    uid+generation ('' degrades the check away when the DS does not exist,
    e.g. bare CLI runs)."""
    ds = client.get_or_none("apps/v1", "DaemonSet", consts.VALIDATOR_APP, namespace)
    if ds is None:
        return ""
    meta = ds.get("metadata", {})
    return f"{(meta.get('uid') or 'x')[:8]}-{meta.get('generation', 0)}"


def gang_name(slice_id: str) -> str:
    return _per_node_name("tpu-slice-gang", slice_id)


def gang_service(slice_id: str, namespace: str) -> dict:
    """Headless Service giving gang pods stable DNS (the rendezvous
    address must resolve before any pod has an IP)."""
    name = gang_name(slice_id)
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "clusterIP": "None",
            "selector": {"app": name},
            "ports": [{"name": "coordinator", "port": GANG_PORT}],
        },
    }


def slice_gang_pod(
    slice_id: str,
    node_name: str,
    namespace: str,
    ordinal: int,
    num_hosts: int,
    chips: str = "1",
    image: str = "",
    extra_env: Optional[dict] = None,
) -> dict:
    """One gang member pod, GATED on ``tpu.slice.ready`` via nodeSelector
    (the scheduler refuses the pod while the slice verdict is false),
    pinned to its member host by hostname, with worker ordinal, the
    slice's env and the process group's env (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) injected; ``extra_env``
    overrides any of them."""
    name = gang_name(slice_id)
    hostnames = ",".join(f"{name}-{i}.{name}.{namespace}" for i in range(num_hosts))
    leader = f"{name}-0.{name}.{namespace}"
    env = {
        "TPU_WORKER_ID": str(ordinal),
        "TPU_SLICE_HOSTS": str(num_hosts),
        "TPU_WORKER_HOSTNAMES": hostnames,
        "MEGASCALE_COORDINATOR_ADDRESS": f"{leader}:{GANG_PORT}",
        # init_process_group(init_method="env://") reads these
        "MASTER_ADDR": leader,
        "MASTER_PORT": str(GANG_PORT),
        "WORLD_SIZE": str(num_hosts),
        "RANK": str(ordinal),
    }
    env.update(extra_env or {})
    pod = _workload_pod(f"{name}-{ordinal}", node_name, namespace, SLICE_GANG_SCRIPT, _image(image))
    pod["metadata"]["labels"]["app"] = name
    spec = pod["spec"]
    # the slice-ready GATE: schedule via selector, not nodeName — a
    # nodeName pin would bypass the scheduler and with it the gate
    del spec["nodeName"]
    spec["nodeSelector"] = {
        "kubernetes.io/hostname": node_name,
        consts.SLICE_READY_LABEL: "true",
    }
    spec["hostname"] = f"{name}-{ordinal}"
    spec["subdomain"] = name
    ctr = spec["containers"][0]
    ctr["name"] = "gang"
    ctr["env"] = [{"name": k, "value": v} for k, v in sorted(env.items())]
    ctr["resources"] = {
        "limits": {consts.GPU_RESOURCE: chips},
        "requests": {consts.GPU_RESOURCE: chips},
    }
    return pod


def run_slice_gang(
    client,
    namespace: str,
    slice_id: str,
    members,
    spawn: bool = True,
    image: str = "",
    retries: int = POLL_RETRIES,
    sleep_s: float = POLL_SLEEP_S,
) -> dict:
    """Spawn (leader) or observe (followers) one gang pod per member
    host and wait for ALL to succeed. ``members`` is the ordered list of
    ``(node_name, chips)`` pairs; failure names every host whose pod did
    not make it — a member that cannot schedule is named with its phase
    so the operator can see WHICH host holds the slice back."""
    name = gang_name(slice_id)
    epoch = gang_epoch(client, namespace)
    pods = [
        slice_gang_pod(slice_id, node, namespace, ordinal, len(members), chips=chips, image=image)
        for ordinal, (node, chips) in enumerate(members)
    ]
    host_of = {
        p["metadata"]["name"]: p["spec"]["nodeSelector"]["kubernetes.io/hostname"] for p in pods
    }
    if epoch:
        for pod in pods:
            pod["metadata"]["labels"][GANG_EPOCH_LABEL] = epoch
    if spawn:
        svc = gang_service(slice_id, namespace)
        set_owner_daemonset(client, svc, namespace, consts.VALIDATOR_APP)
        client.delete_if_exists("v1", "Service", name, namespace)
        client.create(svc)
        for pod in pods:
            client.delete_if_exists("v1", "Pod", pod["metadata"]["name"], namespace)
            set_owner_daemonset(client, pod, namespace, consts.VALIDATOR_APP)
            client.create(pod)
    phases: dict = {}
    for _ in range(retries):
        phases = {}
        for pod in pods:
            live = client.get_or_none("v1", "Pod", pod["metadata"]["name"], namespace)
            if live is None:
                phases[pod["metadata"]["name"]] = "Missing" if spawn else "NotCreated"
                continue
            live_epoch = (live["metadata"].get("labels", {}) or {}).get(GANG_EPOCH_LABEL, "")
            if epoch and live_epoch != epoch:
                # a previous epoch's gang (validator re-rolled since): its
                # Succeeded means nothing now — a follower must wait for
                # the leader to respawn the current epoch
                phases[pod["metadata"]["name"]] = "StaleEpoch"
                continue
            phase = live.get("status", {}).get("phase", "Pending")
            if phase == "Pending" and not live.get("spec", {}).get("nodeName"):
                phase = "Unschedulable"
            phases[pod["metadata"]["name"]] = phase
        if all(p == "Succeeded" for p in phases.values()):
            return {
                "slice": slice_id,
                "hosts": [n for n, _ in members],
                "gang": name,
                "result": "Succeeded",
            }
        if any(p == "Failed" for p in phases.values()):
            break
        time.sleep(sleep_s)
    notes = {
        "Unschedulable": " (slice gate tpu.slice.ready or cordon is refusing it)",
        "StaleEpoch": " (previous-epoch gang; leader respawn pending)",
    }
    stragglers = "; ".join(
        f"member host {host_of[pname]}: pod {pname} {phase}" + notes.get(phase, "")
        for pname, phase in sorted(phases.items())
        if phase != "Succeeded"
    )
    raise RuntimeError(f"slice {slice_id} gang validation did not complete: {stragglers}")


def set_owner_daemonset(client, pod: dict, namespace: str, app: str) -> None:
    """Owner the workload pod to the validator DaemonSet so it's GC'd with
    it (reference ``:1017-1035``)."""
    ds = client.get_or_none("apps/v1", "DaemonSet", app, namespace)
    if ds is None:
        return
    meta = ds["metadata"]
    pod["metadata"]["ownerReferences"] = [
        {
            "apiVersion": "apps/v1",
            "kind": "DaemonSet",
            "name": meta["name"],
            "uid": meta.get("uid", ""),
            "controller": True,
        }
    ]


def run_to_completion(
    client,
    pod: dict,
    retries: int = POLL_RETRIES,
    sleep_s: float = POLL_SLEEP_S,
) -> str:
    """Create (recreating any stale instance) and poll to Succeeded
    (reference ``:1042-1059``)."""
    meta = pod["metadata"]
    ns, name = meta["namespace"], meta["name"]
    client.delete_if_exists("v1", "Pod", name, ns)
    # pods from before per-node naming: a stuck one still holds its card
    # request and would starve the new pod forever
    for legacy in ("tpu-cuda-validator", "tpu-plugin-validator"):
        if name != legacy and name.startswith(legacy + "-"):
            client.delete_if_exists("v1", "Pod", legacy, ns)
    set_owner_daemonset(client, pod, ns, consts.VALIDATOR_APP)
    client.create(pod)
    for _ in range(retries):
        live = client.get_or_none("v1", "Pod", name, ns)
        phase = (live or {}).get("status", {}).get("phase", "")
        if phase == "Succeeded":
            return phase
        if phase == "Failed":
            raise RuntimeError(f"workload pod {ns}/{name} failed")
        time.sleep(sleep_s)
    raise RuntimeError(f"workload pod {ns}/{name} did not complete")
