"""An in-cluster Kubernetes client on the standard library.

The node agents need seven verbs: ``get``, ``get_or_none``, ``list``,
``create``, ``update``, ``delete_if_exists`` over Node, Pod, Service and
DaemonSet, and ``evict`` (the Pod's eviction subresource). They go over
HTTPS to the API server with the pod's service-account token and CA, as
``tpu_operator/kube/rest.py``'s ``RestClient`` does; its paging,
watches, apply and connection pool belong to the control plane and wait
for its port.
"""

from __future__ import annotations

import json
import os
import ssl
import time
from http.client import HTTPException, HTTPSConnection
from typing import List, Optional
from urllib.parse import quote

from tpu_operator_torch.kube.client import (
    ConflictError,
    EvictionBlockedError,
    NotFoundError,
    Obj,
)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# kind -> (plural, namespaced)
KIND_TABLE = {
    "Pod": ("pods", True),
    "Node": ("nodes", False),
    "Service": ("services", True),
    "DaemonSet": ("daemonsets", True),
}


class TransientAPIError(RuntimeError):
    """429 or 5xx from the API server: a read retries it."""


class TooManyRequestsError(TransientAPIError):
    """HTTP 429: on the eviction subresource a disruption budget's veto."""


def _resource_path(api_version: str, kind: str, namespace: str = "", name: str = "") -> str:
    """``/api/v1/...`` for the core group, ``/apis/<group>/<version>/...``
    otherwise; a cluster-scoped kind ignores the namespace
    (``rest.py::_resource_path``)."""
    plural, namespaced = KIND_TABLE[kind]
    parts = [f"/apis/{api_version}" if "/" in api_version else f"/api/{api_version}"]
    if namespaced and namespace:
        parts.append(f"namespaces/{quote(namespace)}")
    parts.append(plural)
    if name:
        parts.append(quote(name))
    return "/".join(parts)


class InClusterClient:
    GET_ATTEMPTS = 3
    GET_BACKOFF_S = 0.5

    def __init__(
        self,
        host: Optional[str] = None,
        port: Optional[str] = None,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure: bool = False,
        timeout_s: float = 30.0,
    ):
        self.host = host or os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        self.port = int(port or os.environ.get("KUBERNETES_SERVICE_PORT", "443"))
        self.timeout_s = timeout_s
        # None: read the projected token per request (the kubelet rotates it)
        self._static_token = token
        if insecure:
            self._ctx = ssl.create_default_context()
            self._ctx.check_hostname = False
            self._ctx.verify_mode = ssl.CERT_NONE
        else:
            ca = ca_file or os.path.join(SA_DIR, "ca.crt")
            if not os.path.exists(ca):
                raise FileNotFoundError(
                    f"API server CA bundle not found at {ca}; pass ca_file= or "
                    "insecure=True for dev setups"
                )
            self._ctx = ssl.create_default_context(cafile=ca)

    def _token(self) -> str:
        if self._static_token is not None:
            return self._static_token
        try:
            with open(os.path.join(SA_DIR, "token")) as f:
                return f.read().strip()
        except OSError:
            return ""

    def _make_conn(self):
        return HTTPSConnection(self.host, self.port, context=self._ctx, timeout=self.timeout_s)

    def _request_once(self, method: str, path: str, body: Optional[Obj]) -> Obj:
        headers = {"Accept": "application/json", "Content-Type": "application/json"}
        token = self._token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        conn = self._make_conn()
        try:
            conn.request(
                method, path, body=json.dumps(body) if body is not None else None, headers=headers
            )
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        if resp.status == 404:
            raise NotFoundError(path)
        if resp.status == 409:
            raise ConflictError(path)
        if resp.status == 429:
            raise TooManyRequestsError(f"{method} {path} -> 429: {data[:512]!r}")
        if resp.status >= 500:
            raise TransientAPIError(f"{method} {path} -> {resp.status}: {data[:512]!r}")
        if resp.status >= 400:
            raise RuntimeError(f"{method} {path} -> {resp.status}: {data[:512]!r}")
        return json.loads(data) if data else {}

    def _request(self, method: str, path: str, body: Optional[Obj] = None) -> Obj:
        """One request; a GET retries transport errors, 429 and 5xx. A
        write is sent once: it may have been applied before the error."""
        retries = self.GET_ATTEMPTS - 1 if method == "GET" else 0
        for attempt in range(retries):
            try:
                return self._request_once(method, path, body)
            except (TransientAPIError, OSError, HTTPException):
                time.sleep(self.GET_BACKOFF_S * (2**attempt))
        return self._request_once(method, path, body)

    # -- the verbs ---------------------------------------------------------
    def get(self, api_version, kind, name, namespace="", copy=False) -> Obj:
        # ``copy`` for parity with the control plane's clients: every read
        # is freshly parsed JSON
        return self._request("GET", _resource_path(api_version, kind, namespace, name))

    def get_or_none(self, api_version, kind, name, namespace="", copy=False) -> Optional[Obj]:
        try:
            return self.get(api_version, kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, api_version, kind, namespace="") -> List[Obj]:
        result = self._request("GET", _resource_path(api_version, kind, namespace))
        items = result.get("items", [])
        for item in items:
            item.setdefault("apiVersion", api_version)
            item.setdefault("kind", kind)
        return items

    def create(self, obj: Obj) -> Obj:
        ns = obj.get("metadata", {}).get("namespace", "")
        return self._request("POST", _resource_path(obj["apiVersion"], obj["kind"], ns), obj)

    def update(self, obj: Obj) -> Obj:
        meta = obj.get("metadata", {})
        path = _resource_path(obj["apiVersion"], obj["kind"], meta.get("namespace", ""), meta["name"])
        return self._request("PUT", path, obj)

    def delete(self, api_version, kind, name, namespace="") -> None:
        self._request("DELETE", _resource_path(api_version, kind, namespace, name))

    def delete_if_exists(self, api_version, kind, name, namespace="") -> bool:
        try:
            self.delete(api_version, kind, name, namespace)
            return True
        except NotFoundError:
            return False

    def evict(self, name: str, namespace: str = "") -> None:
        """POST a ``policy/v1`` Eviction to the Pod's eviction
        subresource, so disruption budgets can veto (429 raises
        ``EvictionBlockedError``); a Pod already gone raises
        ``NotFoundError`` (``rest.py::create``'s Eviction branch)."""
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": name, "namespace": namespace},
        }
        path = _resource_path("v1", "Pod", namespace, name) + "/eviction"
        try:
            self._request("POST", path, body)
        except TooManyRequestsError as e:
            raise EvictionBlockedError(str(e)) from e
