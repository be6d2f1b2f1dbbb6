"""Pod eviction through the Eviction subresource.

The port's copy of ``EvictResult`` and ``PodManager.evict_pods``
(``tpu_operator/upgrade/upgrade_state.py:274-335``). It lives here, not in
an upgrade package, because the upgrade engine is control plane; the node
agents' driver manager is its caller.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List

from tpu_operator_torch.kube.client import EvictionBlockedError, NotFoundError, Obj

log = logging.getLogger("gpu-eviction")


@dataclass
class EvictResult:
    """What an eviction sweep did."""

    evicted: int = 0
    skipped: int = 0  # unmanaged pods left alone (no force)
    blocked: List[str] = field(default_factory=list)  # disruption-budget vetoes
    # the vetoed pods themselves, for a caller that retries exactly these
    blocked_pods: List[Obj] = field(default_factory=list)


def evict_pods(client, pods: List[Obj], force: bool = False) -> EvictResult:
    """Evict each pod through ``client.evict``, never a bare DELETE, so a
    PodDisruptionBudget can veto. Without ``force`` an unmanaged pod (no
    ``ownerReferences``) is left alone: no controller would recreate it,
    so its work would be lost (kubectl drain's ``--force``)."""
    res = EvictResult()
    for pod in pods:
        meta = pod["metadata"]
        if not force and not meta.get("ownerReferences"):
            log.warning("skipping unmanaged pod %s/%s (set force to delete)",
                        meta.get("namespace"), meta["name"])
            res.skipped += 1
            continue
        log.info("evicting GPU pod %s/%s", meta.get("namespace"), meta["name"])
        try:
            client.evict(meta["name"], meta.get("namespace", ""))
            res.evicted += 1
        except NotFoundError:
            res.evicted += 1  # already gone: the goal state
        except EvictionBlockedError as e:
            log.warning("eviction of %s/%s vetoed by a disruption budget: %s",
                        meta.get("namespace"), meta["name"], e)
            res.blocked.append(str(e))
            res.blocked_pods.append(pod)
    return res
