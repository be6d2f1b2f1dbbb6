"""Stdlib-only in-cluster Kubernetes REST client.

The port's copy of ``tpu_operator/kube/rest.py``: ``RestClient`` implements
the ``Client`` interface over the API server's REST surface using
``http.client`` + the pod's service-account credentials — every verb
through the retry policy and the circuit breaker (``kube/retry.py``),
chunked LISTs, label and field selectors, watches that resume on expiry and
re-list on a 410, the eviction subresource, and server-side APPLY with its
batch PATCH. The node agents' smaller ``InClusterClient``
(``kube/incluster.py``) stays beside it.

Path construction follows the standard discovery rules:
``/api/v1/...`` for the core group, ``/apis/<group>/<version>/...``
otherwise; namespaced vs cluster-scoped from a static kind table (the kinds
the operator manages are known at build time, exactly like the reference's
``Resources`` struct, ``controllers/resource_manager.go:35-53``).
"""

from __future__ import annotations

import json
import os
import ssl
import threading
import time
from http.client import HTTPException, HTTPSConnection
from typing import Dict, List, Optional
from urllib.parse import quote, urlencode

from tpu_operator_torch.kube.client import Client, ConflictError, NotFoundError, Obj
from tpu_operator_torch.kube.retry import CircuitBreaker, RetryPolicy, WatchBackoff
from tpu_operator_torch.obs import flight, trace

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# a metrics layer may install this: it observes each WRITE verb's
# round-trip (ms, retries included) without kube/ importing upward
on_write_rtt_ms = None

_WRITE_VERBS = frozenset(("POST", "PUT", "PATCH", "DELETE", "APPLY"))


def _plural_of(path: str) -> str:
    """Resource plural from a discovery-rule path (trace attribute):
    ``/api/v1/namespaces/ns/pods/name`` -> ``pods``."""
    parts = path.split("?", 1)[0].strip("/").split("/")
    i = 2 if parts[:1] == ["api"] else 3  # /apis/<group>/<version>/...
    if len(parts) > i + 1 and parts[i] == "namespaces":
        i += 2
    return parts[i] if len(parts) > i else ""


class TransientAPIError(RuntimeError):
    """429 / 5xx from the API server — retryable (reads and writes both,
    within the per-call ``RetryPolicy`` budget)."""


class TooManyRequestsError(TransientAPIError):
    """HTTP 429 specifically: on the eviction subresource this is the
    PDB-veto signal, not a load-shedding hiccup. Carries the response's
    ``Retry-After`` (seconds) when the server sent one."""

    retry_after: Optional[float] = None


class CircuitOpenError(TransientAPIError):
    """Fast-fail while the apiserver circuit breaker is open: the last
    ``CircuitBreaker.threshold`` consecutive requests all failed at the
    transport/5xx level, so new requests are refused locally until the
    cooldown lapses instead of stacking timeouts on a dead server."""

# kind -> (plural, namespaced)
KIND_TABLE: Dict[str, tuple] = {
    "Pod": ("pods", True),
    "Node": ("nodes", False),
    "Namespace": ("namespaces", False),
    "Service": ("services", True),
    "ServiceAccount": ("serviceaccounts", True),
    "ConfigMap": ("configmaps", True),
    "Secret": ("secrets", True),
    "Event": ("events", True),
    "DaemonSet": ("daemonsets", True),
    "Deployment": ("deployments", True),
    "ReplicaSet": ("replicasets", True),
    "Job": ("jobs", True),
    "Role": ("roles", True),
    "RoleBinding": ("rolebindings", True),
    "ClusterRole": ("clusterroles", False),
    "ClusterRoleBinding": ("clusterrolebindings", False),
    "RuntimeClass": ("runtimeclasses", False),
    "PodSecurityPolicy": ("podsecuritypolicies", False),
    "ServiceMonitor": ("servicemonitors", True),
    "PrometheusRule": ("prometheusrules", True),
    "ClusterPolicy": ("clusterpolicies", False),
    "Lease": ("leases", True),
    "CustomResourceDefinition": ("customresourcedefinitions", False),
    "Eviction": ("evictions", True),
    "PodDisruptionBudget": ("poddisruptionbudgets", True),
}


def _resource_path(
    api_version: str, kind: str, namespace: str = "", name: str = ""
) -> str:
    plural, namespaced = KIND_TABLE[kind]
    if "/" in api_version:
        base = f"/apis/{api_version}"
    else:
        base = f"/api/{api_version}"
    parts = [base]
    if namespaced and namespace:
        parts.append(f"namespaces/{quote(namespace)}")
    parts.append(plural)
    if name:
        parts.append(quote(name))
    return "/".join(parts)


# watch stream windowing: short windows bound SILENT staleness (a peer
# that dies without closing the socket wedges reads until the socket
# timeout), and clean expiry RESUMES from the last resourceVersion —
# with bookmarks requested, quiet kinds' resume rv keeps advancing, so
# renewal is one cheap request, not a re-list. Worst-case silent-death
# detection = WATCH_WINDOW_S + WATCH_SOCKET_SLACK_S.
WATCH_WINDOW_S = 30
WATCH_SOCKET_SLACK_S = 30


class RestClient(Client):
    def __init__(
        self,
        host: Optional[str] = None,
        port: Optional[str] = None,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure: bool = False,
        retry_policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.host = host or os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        self.port = int(port or os.environ.get("KUBERNETES_SERVICE_PORT", "443"))
        # fault-tolerance surface (kube/retry.py): per-verb retry policy
        # + the global circuit breaker, one pair per client instance
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker or CircuitBreaker()
        # None = re-read the projected SA token per request (bound tokens are
        # rotated on disk by the kubelet and expire ~hourly).
        self._static_token = token
        ca = ca_file or os.path.join(SA_DIR, "ca.crt")
        if insecure:
            self._ctx = ssl.create_default_context()
            self._ctx.check_hostname = False
            self._ctx.verify_mode = ssl.CERT_NONE
        else:
            if not os.path.exists(ca):
                raise FileNotFoundError(
                    f"API server CA bundle not found at {ca}; pass ca_file= or "
                    "insecure=True explicitly for dev setups"
                )
            self._ctx = ssl.create_default_context(cafile=ca)
        # keep-alive connection pool: one idle connection per recent
        # in-flight worker instead of a TCP+TLS handshake per request —
        # client-go's pooled http.Transport, stdlib edition. Watch
        # streams deliberately bypass it (their sockets carry custom
        # timeouts and live for the stream). Thread-safe: the write
        # pipeline runs many workers over one client.
        self.pool_max = int(os.environ.get("REST_CONN_POOL_MAX", "32"))
        self._pool: List = []
        self._pool_lock = threading.Lock()
        self.pool_reuses = 0
        self.pool_fresh = 0
        self.pool_stale_drops = 0

    # -- connection pool --------------------------------------------------
    def _acquire_conn(self):
        """An idle pooled connection (LIFO: the most recently used is
        the least likely to have been closed by the server), or a fresh
        one. Returns ``(conn, reused)``."""
        with self._pool_lock:
            if self._pool:
                self.pool_reuses += 1
                return self._pool.pop(), True
            self.pool_fresh += 1
        return self._make_conn(), False

    def _release_conn(self, conn) -> None:
        with self._pool_lock:
            if len(self._pool) < self.pool_max:
                self._pool.append(conn)
                return
        conn.close()

    def _discard_conn(self, conn) -> None:
        try:
            conn.close()
        except OSError:
            pass

    def close_idle_connections(self) -> None:
        """Drop every pooled idle connection (tests / shutdown)."""
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            self._discard_conn(conn)

    def pool_stats(self) -> Dict[str, int]:
        with self._pool_lock:
            return {
                "idle": len(self._pool),
                "max": self.pool_max,
                "reuses": self.pool_reuses,
                "fresh": self.pool_fresh,
                "stale_drops": self.pool_stale_drops,
            }

    def _token(self) -> str:
        if self._static_token is not None:
            return self._static_token
        token_path = os.path.join(SA_DIR, "token")
        try:
            with open(token_path) as f:
                return f.read().strip()
        except OSError:
            return ""

    # -- low-level -------------------------------------------------------
    def _make_conn(self, timeout: float = 30):
        """Connection factory (separated so tests can point the client at a
        plain-HTTP stub API server)."""
        return HTTPSConnection(
            self.host, self.port, context=self._ctx, timeout=timeout
        )

    def fault_stats(self) -> Dict[str, object]:
        out = super().fault_stats()
        out["conn_pool"] = self.pool_stats()
        return out

    # back-compat knobs: existing callers/tests tune the read retry
    # count/backoff through these names; they now alias the RetryPolicy
    @property
    def GET_RETRIES(self) -> int:  # noqa: N802 - historical name
        return self.retry_policy.read_attempts

    @GET_RETRIES.setter
    def GET_RETRIES(self, n: int) -> None:  # noqa: N802
        self.retry_policy.read_attempts = n

    @property
    def GET_RETRY_BACKOFF_S(self) -> float:  # noqa: N802
        return self.retry_policy.backoff_s

    @GET_RETRY_BACKOFF_S.setter
    def GET_RETRY_BACKOFF_S(self, s: float) -> None:  # noqa: N802
        self.retry_policy.backoff_s = s

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Obj] = None,
        content_type: str = "application/json",
        retry_429: bool = True,
        count_as: Optional[str] = None,
    ) -> Obj:
        """Instrumented wrapper over ``_request_policied``: a
        ``rest.request`` span (verb, plural, attempts, breaker state)
        when tracing is on, and the write-RTT histogram observation
        when metrics installed the hook. Both off — the common steady
        state — is one extra frame and two branches."""
        verb = count_as or method
        observe = on_write_rtt_ms if verb in _WRITE_VERBS else None
        if not trace.TRACER.enabled and observe is None:
            return self._request_policied(
                method, path, body, content_type, retry_429, verb,
                trace.NOOP,
            )
        t0 = time.monotonic()
        with trace.span(
            "rest.request", verb=verb, plural=_plural_of(path)
        ) as sp:
            result = self._request_policied(
                method, path, body, content_type, retry_429, verb, sp
            )
            # COMPLETED round-trips only: a failed call (and especially
            # a microsecond breaker fast-fail) must not fill the
            # alerting-grade RTT series with healthy-looking samples
            # during the very outage it exists to catch — failures show
            # up on the retry/breaker counters instead
            if observe is not None:
                try:
                    observe(verb, (time.monotonic() - t0) * 1000.0)
                except Exception:
                    pass
            return result

    def _request_policied(
        self,
        method: str,
        path: str,
        body: Optional[Obj],
        content_type: str,
        retry_429: bool,
        verb: str,
        sp,
    ) -> Obj:
        """One API call under the fault-tolerance policy: per-verb
        bounded retries with jittered exponential backoff for transient
        failures (connection refused/reset, 429, 5xx) on reads AND
        writes, honoring 429 ``Retry-After``, within a per-call
        wall-clock budget; semantic statuses (404/409/other 4xx) fail
        fast — retrying cannot help, and the answer proves the apiserver
        is alive. The global circuit breaker fails calls fast while the
        apiserver is known-dead. ``retry_429=False`` exempts a call
        whose 429 is a semantic veto, not load shedding (the eviction
        subresource's PDB refusal). ``count_as`` overrides the verb the
        retry counters record (server-side apply rides PATCH on the
        wire but is the APPLY verb to the policy surface)."""
        policy = self.retry_policy
        breaker = self.breaker
        attempts = policy.attempts_for(method)
        deadline = time.monotonic() + policy.budget_s
        last_err: Optional[Exception] = None
        retry_after: Optional[float] = None
        for attempt in range(attempts):
            # breaker first: an open breaker must fail fast, not after
            # sleeping a full backoff delay it was never going to use
            if not breaker.allow():
                sp.set("breaker", "open")
                raise CircuitOpenError(
                    f"{method} {path}: apiserver circuit open "
                    f"({breaker.stats()})"
                )
            if attempt:
                delay = policy.backoff(attempt, retry_after)
                if time.monotonic() + delay > deadline:
                    policy.count_giveup()
                    break  # budget exhausted: surface the last error
                policy.count_retry(
                    verb, honored_retry_after=retry_after is not None
                )
                time.sleep(delay)
            try:
                result = self._request_once(method, path, body, content_type)
                breaker.record_success()
                if attempt:
                    sp.set("retries", attempt)
                return result
            except (NotFoundError, ConflictError):
                breaker.record_success()  # the server answered
                raise  # semantic statuses, not transient
            except TooManyRequestsError as e:
                # load shedding: the server is alive (never trips the
                # breaker) and may have told us exactly when to return
                breaker.record_success()
                if not retry_429:
                    raise
                last_err = e
                retry_after = e.retry_after
            except (OSError, TransientAPIError) as e:
                # connection refused/reset, 5xx: the API server (or a
                # lagging webhook) hiccupped — worth a bounded retry
                breaker.record_failure()
                last_err = e
                retry_after = None
            except RuntimeError:
                breaker.record_success()  # other 4xx: the server answered
                raise  # retrying cannot help
        raise last_err  # type: ignore[misc]

    def _request_once(
        self,
        method: str,
        path: str,
        body: Optional[Obj],
        content_type: str = "application/json",
    ) -> Obj:
        headers = {
            "Accept": "application/json",
            "Content-Type": content_type,
        }
        token = self._token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        payload = json.dumps(body) if body is not None else None
        idempotent = method in ("GET", "HEAD")
        while True:
            conn, reused = self._acquire_conn()
            sent = False
            try:
                conn.request(method, path, body=payload, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, HTTPException):
                # the socket died. A REUSED keep-alive connection failing
                # here overwhelmingly means the server closed it while it
                # idled in the pool — housekeeping, not an apiserver
                # failure: retry once on a FRESH connection without
                # touching the breaker/retry counters. But a
                # NON-idempotent write whose request DID go out may have
                # been processed before the socket died — silently
                # re-sending it could double-apply (urllib3/client-go
                # restrict idle-connection auto-retry the same way), so
                # that case surfaces to the retry policy, which counts
                # and bounds the re-send it was already doing for
                # transport errors. A fresh connection failing is a real
                # transport error and always surfaces.
                self._discard_conn(conn)
                if reused and (idempotent or not sent):
                    with self._pool_lock:
                        self.pool_stale_drops += 1
                    continue
                raise
            # response fully read: the connection is reusable unless the
            # server asked to close (HTTP/1.0, Connection: close)
            if getattr(resp, "will_close", True):
                self._discard_conn(conn)
            else:
                self._release_conn(conn)
            if resp.status == 404:
                raise NotFoundError(path)
            if resp.status == 409:
                err = ConflictError(path)
                # the status body distinguishes an rv/AlreadyExists 409
                # from a field-ownership conflict (apply callers need
                # the reason + the conflicting fields)
                err.body = data
                raise err
            if resp.status == 429:
                err = TooManyRequestsError(
                    f"{method} {path} -> {resp.status}: {data[:512]!r}"
                )
                ra = resp.getheader("Retry-After")
                try:
                    err.retry_after = float(ra) if ra is not None else None
                except (TypeError, ValueError):
                    err.retry_after = None
                raise err
            if resp.status >= 500:
                raise TransientAPIError(
                    f"{method} {path} -> {resp.status}: {data[:512]!r}"
                )
            if resp.status >= 400:
                raise RuntimeError(
                    f"{method} {path} -> {resp.status}: {data[:512]!r}"
                )
            return json.loads(data) if data else {}

    # -- chunked LIST (server-side limit/continue) ------------------------
    @staticmethod
    def list_page_size() -> int:
        """LIST chunk size (``REST_LIST_PAGE_SIZE``, default 2000; 0
        disables chunking). Real apiservers bound LIST responses this
        way (client-go's pager defaults to 500); one unbounded 50k-node
        LIST is a multi-second, hundreds-of-MB response the informer
        initial sync should never depend on."""
        try:
            return max(0, int(os.environ.get("REST_LIST_PAGE_SIZE", "2000")))
        except ValueError:
            return 2000

    def _paged_list(self, base_path: str, params: dict) -> dict:
        """GET a collection in ``limit``/``continue`` chunks, merging
        pages into one List document. The returned metadata carries the
        FIRST page's resourceVersion — the apiserver pins the snapshot
        rv across a continue chain, so a watch resumed from it replays
        whatever landed while the client paged."""
        page = self.list_page_size()
        merged = None
        cont = ""
        while True:
            p = dict(params)
            if page > 0:
                p["limit"] = str(page)
            if cont:
                p["continue"] = cont
            path = base_path + ("?" + urlencode(p) if p else "")
            result = self._request("GET", path)
            if merged is None:
                merged = result
            else:
                merged.setdefault("items", []).extend(
                    result.get("items", [])
                )
            cont = (result.get("metadata") or {}).get("continue") or ""
            if not cont or page <= 0:
                break
        if isinstance(merged.get("metadata"), dict):
            merged["metadata"].pop("continue", None)
        return merged

    # -- Client interface -------------------------------------------------
    def get(self, api_version, kind, name, namespace="", copy=False):
        # ``copy`` accepted for Client-interface parity; every REST read
        # is freshly parsed JSON, so the result is always private
        return self._request(
            "GET", _resource_path(api_version, kind, namespace, name)
        )

    def list(
        self,
        api_version,
        kind,
        namespace="",
        label_selector=None,
        field_selector=None,
        copy=False,
    ) -> List[Obj]:
        path = _resource_path(api_version, kind, namespace)
        params = {}
        if label_selector:
            if isinstance(label_selector, str):
                # raw apiserver grammar (set-based terms included) goes
                # through verbatim — server-side filtering
                params["labelSelector"] = label_selector
            else:
                from tpu_operator_torch.kube.selector import encode_dict_selector

                encoded = encode_dict_selector(label_selector)
                if encoded:
                    params["labelSelector"] = encoded
        if field_selector:
            params["fieldSelector"] = ",".join(
                f"{k}={v}" for k, v in field_selector.items()
            )
        result = self._paged_list(path, params)
        items = result.get("items", [])
        # server-side selectors can't express globs; filter client-side
        from tpu_operator_torch.kube.client import match_labels

        api_version_out = result.get("apiVersion", api_version)
        for item in items:
            item.setdefault("apiVersion", api_version_out.replace("List", ""))
            item.setdefault("kind", kind)
        if (
            label_selector
            and not isinstance(label_selector, str)
            and any(
                not isinstance(v, (list, tuple)) and "*" in str(v)
                for v in label_selector.values()
            )
        ):
            items = [o for o in items if match_labels(o, label_selector)]
        return items

    def list_with_rv(self, api_version, kind, namespace=""):
        """Unfiltered list plus the List response's collection
        resourceVersion — the informer resync needs the snapshot rv to
        tell a deleted object from one created after the snapshot."""
        result = self._paged_list(
            _resource_path(api_version, kind, namespace), {}
        )
        items = result.get("items", [])
        for item in items:
            item.setdefault("apiVersion", api_version)
            item.setdefault("kind", kind)
        return items, result.get("metadata", {}).get("resourceVersion")

    def create(self, obj):
        av, kind = obj["apiVersion"], obj["kind"]
        meta = obj.get("metadata", {})
        ns = meta.get("namespace", "")
        if kind == "Eviction":
            # Eviction only exists as the pods/{name}/eviction subresource;
            # a 429 here is a PodDisruptionBudget veto, not load shedding
            pod_path = _resource_path("v1", "Pod", ns, meta["name"])
            try:
                # retry_429=False: this 429 is a semantic veto (the PDB
                # refused the disruption), not load shedding — retrying
                # inside the client would just re-ask a firm "no"
                return self._request(
                    "POST", pod_path + "/eviction", obj, retry_429=False
                )
            except TooManyRequestsError as e:
                from tpu_operator_torch.kube.client import EvictionBlockedError

                raise EvictionBlockedError(str(e)) from e
        return self._request("POST", _resource_path(av, kind, ns), obj)

    def update(self, obj):
        av, kind = obj["apiVersion"], obj["kind"]
        meta = obj.get("metadata", {})
        return self._request(
            "PUT", _resource_path(av, kind, meta.get("namespace", ""), meta["name"]), obj
        )

    def update_status(self, obj):
        av, kind = obj["apiVersion"], obj["kind"]
        meta = obj.get("metadata", {})
        path = _resource_path(av, kind, meta.get("namespace", ""), meta["name"])
        return self._request("PUT", path + "/status", obj)

    def patch_labels(
        self, api_version, kind, name, namespace="", labels=None,
        resource_version=None,
    ):
        """HTTP merge patch (RFC 7386): the body is just the label
        delta (``None`` → JSON null → delete). With ``resource_version``
        the rv rides in the body as an optimistic-concurrency
        precondition (apiserver PATCH semantics: 409 on mismatch);
        without it the patch applies to whatever revision is current."""
        meta: Obj = {"labels": dict(labels or {})}
        if resource_version is not None:
            meta["resourceVersion"] = str(resource_version)
        return self._request(
            "PATCH",
            _resource_path(api_version, kind, namespace, name),
            {"metadata": meta},
            content_type="application/merge-patch+json",
        )

    # -- server-side apply -------------------------------------------------
    @staticmethod
    def _apply_qs(
        field_manager, force, prune, create_only=None, update_only=None
    ) -> str:
        from tpu_operator_torch.kube.apply import DEFAULT_FIELD_MANAGER

        params = {
            "fieldManager": field_manager or DEFAULT_FIELD_MANAGER,
            "force": "true" if force else "false",
            "prune": "true" if prune else "false",
        }
        if create_only:
            params["createOnly"] = "true"
        if update_only:
            params["updateOnly"] = "true"
        return urlencode(params)

    def _raise_apply_conflict(self, e: ConflictError) -> None:
        """Re-raise a 409 whose status body is a field-ownership
        conflict as ``ApplyConflictError`` (callers recompute from a
        fresh read); any other 409 (stale rv, AlreadyExists) propagates
        unchanged."""
        from tpu_operator_torch.kube.apply import ApplyConflictError

        body = getattr(e, "body", b"") or b""
        if b"FieldConflict" in body:
            try:
                message = json.loads(body).get("message", str(e))
            except (ValueError, AttributeError):
                message = str(e)
            raise ApplyConflictError(message) from e
        raise e

    def apply_ssa(
        self,
        obj,
        field_manager=None,
        force=True,
        prune=True,
        create_only=False,
        update_only=False,
    ):
        """The APPLY verb on the wire: one PATCH with content type
        ``application/apply-patch+yaml`` (body is the applied
        configuration as JSON — a YAML superset, like the real
        apiserver accepts). No GET-before-PUT, no resourceVersion: the
        server merges under field ownership and a repeat apply is a
        server-side no-op."""
        av, kind = obj["apiVersion"], obj["kind"]
        meta = obj.get("metadata", {})
        path = (
            _resource_path(av, kind, meta.get("namespace", ""), meta["name"])
            + "?"
            + self._apply_qs(
                field_manager, force, prune, create_only, update_only
            )
        )
        try:
            return self._request(
                "PATCH",
                path,
                obj,
                content_type="application/apply-patch+yaml",
                count_as="APPLY",
            )
        except ConflictError as e:
            self._raise_apply_conflict(e)

    def apply_ssa_batch(
        self, items, field_manager=None, force=True, prune=True,
        update_only=False,
    ):
        """Batched APPLY: N sibling objects of ONE (apiVersion, kind,
        namespace) collection in a single wire request, per-item status
        fan-back (one failed item fails only itself). Returns
        ``[(object, error)]`` aligned to ``items``. Transient transport
        failures retry the WHOLE batch inside ``_request`` — applies
        are idempotent, and a retried ``create_only`` item surfaces as
        a benign per-item AlreadyExists."""
        from tpu_operator_torch.kube.apply import ApplyConflictError

        norm = [
            item if isinstance(item, tuple) else (item, False)
            for item in items
        ]
        if not norm:
            return []
        first = norm[0][0]
        av, kind = first["apiVersion"], first["kind"]
        ns = first.get("metadata", {}).get("namespace", "")
        path = (
            _resource_path(av, kind, ns)
            + "?"
            + self._apply_qs(
                field_manager, force, prune, update_only=update_only
            )
        )
        body = {
            "items": [
                {"object": obj, "createOnly": bool(create_only)}
                for obj, create_only in norm
            ]
        }
        result = self._request(
            "PATCH",
            path,
            body,
            content_type="application/apply-patch+yaml",
            count_as="APPLY",
        )
        out = []
        for i, entry in enumerate(result.get("items", [])):
            code = entry.get("code", 500)
            if code < 400:
                obj = entry.get("object", {})
                obj.setdefault("apiVersion", av)
                obj.setdefault("kind", kind)
                out.append((obj, None))
                continue
            status = entry.get("status", {}) or {}
            message = status.get("message", f"apply item {i} -> {code}")
            if code == 404:
                out.append((None, NotFoundError(message)))
            elif code == 409 and status.get("reason") == "FieldConflict":
                out.append((None, ApplyConflictError(message)))
            elif code == 409:
                out.append((None, ConflictError(message)))
            else:
                out.append((None, RuntimeError(message)))
        while len(out) < len(norm):  # defensive: a short reply fails the rest
            out.append((None, RuntimeError("apply batch reply truncated")))
        return out

    def delete(self, api_version, kind, name, namespace=""):
        self._request(
            "DELETE", _resource_path(api_version, kind, namespace, name)
        )

    # -- watch ------------------------------------------------------------
    def watch(
        self,
        api_version: str,
        kind: str,
        callback,
        namespace: str = "",
        stop_event=None,
        timeout_s: int = WATCH_WINDOW_S,
        on_sync=None,
        seed_rv=None,
        seed_known=None,
        on_progress=None,
    ) -> None:
        """Blocking list+watch loop: calls ``callback(event_type, obj)`` for
        ADDED/MODIFIED/DELETED. Re-lists on expiry/disconnect (the
        controller-runtime informer contract, minus caching).
        ``on_sync()`` fires after each full list has been delivered — the
        informer cache uses it as its HasSynced barrier.

        ``seed_rv``/``seed_known`` (warm restart): the caller already
        holds the world (journal-seeded informer store), so the FIRST
        cycle skips the initial LIST entirely and streams from
        ``seed_rv``; a 410 (history compacted past the journal) falls
        back to the normal list path — bounded staleness, never wrong.

        ``on_progress(rv)`` fires whenever the stream's resume position
        advances — list rv, event rv, or BOOKMARK rv. The informer
        records it as its journal resume point (client-go's
        LastSyncResourceVersion, which bookmarks advance on QUIET kinds
        precisely so a restart can resume instead of 410ing into a
        re-list)."""
        import logging
        import threading

        log = logging.getLogger("gpu-operator.watch")
        stop_event = stop_event or threading.Event()

        def deliver(etype, obj):
            # a poison object must not kill the watch loop
            try:
                callback(etype, obj)
            except Exception:
                log.exception("watch callback failed for %s %s", etype, kind)

        known = set(seed_known) if seed_known else set()
        warm_rv = str(seed_rv) if seed_rv else None
        # jittered exponential reconnect backoff (reset once a list
        # succeeds): a fleet of informers on a fixed delay re-LISTs a
        # recovering apiserver in lockstep — the thundering herd the
        # jitter exists to break up
        backoff = WatchBackoff()
        listed_once = False
        while not stop_event.is_set():
            try:
                if listed_once:
                    # every LIST after the first is a RE-list (410'd
                    # history, disconnect, NotFound poll) — the watch-gap
                    # event the flight recorder timelines. NEVER let a
                    # recorder bug kill the watch loop.
                    try:
                        flight.record("watch.relist", watched=kind)
                    except Exception:
                        pass
                if warm_rv is not None:
                    rv, warm_rv = warm_rv, None
                    # the journal seed counts as the first list: when
                    # this stream dies (e.g. a 410 history gap), the
                    # re-list IS a watch-gap event worth timelining
                    listed_once = True
                    self._watch_loop_streams(
                        api_version, kind, namespace, rv, deliver,
                        stop_event, timeout_s, known, on_progress,
                    )
                    continue  # stream ended: re-list (cold path below)
                try:
                    # chunked like every other LIST: the informer
                    # initial sync at 50k nodes must never hinge on one
                    # unbounded response
                    listing = self._paged_list(
                        _resource_path(api_version, kind, namespace), {}
                    )
                    backoff.reset()
                    listed_once = True
                except NotFoundError:
                    # the kind is not served (optional CRD not installed,
                    # e.g. ServiceMonitor without prometheus-operator, or
                    # PSP on k8s >= 1.25): "nothing exists" IS the
                    # authoritative state — sync empty, poll slowly for
                    # the CRD to appear, and never log-spam a traceback
                    for ns_name in known:
                        deliver(
                            "DELETED",
                            {
                                "apiVersion": api_version,
                                "kind": kind,
                                "metadata": {
                                    "namespace": ns_name[0],
                                    "name": ns_name[1],
                                },
                            },
                        )
                    known = set()
                    if on_sync is not None:
                        try:
                            on_sync()
                        except Exception:
                            log.exception("watch on_sync callback failed")
                    stop_event.wait(30)
                    continue
                rv = listing.get("metadata", {}).get("resourceVersion", "")
                if rv and on_progress is not None:
                    try:
                        on_progress(rv)
                    except Exception:
                        log.exception("watch on_progress callback failed")
                seen = set()
                for item in listing.get("items", []):
                    item.setdefault("apiVersion", api_version)
                    item.setdefault("kind", kind)
                    meta = item.get("metadata", {})
                    seen.add((meta.get("namespace", ""), meta.get("name", "")))
                    deliver("ADDED", item)
                # objects deleted during a watch gap: synthesize DELETED
                for ns_name in known - seen:
                    deliver(
                        "DELETED",
                        {
                            "apiVersion": api_version,
                            "kind": kind,
                            "metadata": {
                                "namespace": ns_name[0],
                                "name": ns_name[1],
                            },
                        },
                    )
                known = seen
                if on_sync is not None:
                    try:
                        on_sync()
                    except Exception:
                        log.exception("watch on_sync callback failed")
                # stream, RESUMING from the last seen resourceVersion on
                # clean expiry (server timeoutSeconds) — the informer
                # contract: only a 410 Gone forces the full re-list above
                self._watch_loop_streams(
                    api_version, kind, namespace, rv, deliver, stop_event,
                    timeout_s, known, on_progress,
                )
            except Exception:
                if stop_event.is_set():
                    return
                log.exception("watch %s/%s disconnected; re-listing", api_version, kind)
                stop_event.wait(backoff.next_delay())  # then re-list

    def _watch_loop_streams(
        self, api_version, kind, namespace, rv, deliver, stop_event,
        timeout_s, known, on_progress=None,
    ) -> None:
        """Renew watch windows from ``rv`` until the history expires
        (410/ERROR) or the caller stops — returning means the caller
        must re-list."""
        while not stop_event.is_set():
            rv = self._watch_stream(
                api_version,
                kind,
                namespace,
                rv,
                deliver,
                stop_event,
                timeout_s,
                known,
                on_progress,
            )
            if rv is None:
                return  # expired history: re-list

    def _watch_stream(
        self,
        api_version,
        kind,
        namespace,
        rv,
        callback,
        stop_event,
        timeout_s,
        known=None,
        on_progress=None,
    ) -> Optional[str]:
        """One watch request. Returns the resourceVersion to RESUME from
        after a clean server-side close (expiry), or ``None`` when the
        server answered 410/ERROR — history expired, caller must re-list."""
        path = _resource_path(api_version, kind, namespace)
        params = {
            "watch": "true",
            "timeoutSeconds": str(timeout_s),
            # without bookmarks a QUIET kind's resume rv never advances,
            # and the global resourceVersion compacts past it within
            # minutes on a busy cluster — every window renewal would 410
            # into a full re-list instead of a cheap resume
            "allowWatchBookmarks": "true",
        }
        if rv:
            params["resourceVersion"] = rv
        path += "?" + urlencode(params)
        conn = self._make_conn(timeout=timeout_s + WATCH_SOCKET_SLACK_S)
        last_rv: Optional[str] = rv or None
        try:
            headers = {"Accept": "application/json"}
            token = self._token()
            if token:
                headers["Authorization"] = f"Bearer {token}"
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
            if resp.status == 410:
                return None  # Gone: re-list
            if resp.status >= 400:
                raise RuntimeError(f"watch {path} -> {resp.status}")
            buf = b""
            while not stop_event.is_set():
                chunk = resp.read1(65536)
                if not chunk:
                    return last_rv  # clean close; caller resumes from here
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    event = json.loads(line)
                    etype = event.get("type", "")
                    obj = event.get("object", {})
                    if etype == "ERROR":
                        return None  # resourceVersion expired; re-list
                    obj_rv = obj.get("metadata", {}).get("resourceVersion")
                    if obj_rv:
                        last_rv = obj_rv
                        if on_progress is not None:
                            try:
                                on_progress(obj_rv)
                            except Exception:
                                pass  # progress is advisory, never fatal
                    if etype == "BOOKMARK":
                        continue  # progress marker only: advances last_rv
                    if etype in ("ADDED", "MODIFIED", "DELETED"):
                        obj.setdefault("apiVersion", api_version)
                        obj.setdefault("kind", kind)
                        if known is not None:
                            meta = obj.get("metadata", {})
                            key = (
                                meta.get("namespace", ""),
                                meta.get("name", ""),
                            )
                            if etype == "DELETED":
                                known.discard(key)
                            else:
                                known.add(key)
                        callback(etype, obj)
            return last_rv
        finally:
            conn.close()
