"""Errors of the API server and the conflict-retried update.

The port's copy of ``tpu_operator/kube/client.py``'s ``NotFoundError``,
``ConflictError``, ``EvictionBlockedError`` and ``mutate_with_retry``
(``:62``). Objects are plain dicts in Kubernetes wire format.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional

Obj = Dict


class NotFoundError(KeyError):
    """Object does not exist (HTTP 404)."""


class ConflictError(RuntimeError):
    """resourceVersion conflict on update (HTTP 409)."""


class EvictionBlockedError(RuntimeError):
    """Eviction vetoed by a PodDisruptionBudget (HTTP 429 on the
    ``pods/<name>/eviction`` subresource); the caller retries later."""


def mutate_with_retry(
    client,
    api_version: str,
    kind: str,
    name: str,
    namespace: str = "",
    *,
    mutate: Callable[[Obj], bool],
    attempts: int = 5,
    backoff_s: float = 0.05,
    backoff_cap_s: float = 1.0,
) -> Obj:
    """Optimistic-concurrency read-mutate-update: re-GET and re-apply on a
    409, the discipline every writer of a shared object (a Node carries
    labels and annotations from many writers) follows. ``mutate(obj) ->
    bool`` returns whether anything changed; False skips the write.
    Backoff is jittered exponential with a cap. Raises the last
    ConflictError when the race outlasts ``attempts``."""
    last: Optional[Exception] = None
    for attempt in range(attempts):
        if attempt:
            delay = min(backoff_cap_s, backoff_s * (2 ** (attempt - 1)))
            time.sleep(random.uniform(delay / 2, delay))
        if attempt == 0:
            obj = client.get(api_version, kind, name, namespace, copy=True)
        else:
            # after a 409 the read must be live, not a cache's stale copy
            obj = getattr(client, "get_live", client.get)(api_version, kind, name, namespace)
        if not mutate(obj):
            return obj
        try:
            client.update(obj)
            return obj
        except ConflictError as e:
            last = e
    raise last  # type: ignore[misc]
