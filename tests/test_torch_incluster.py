"""The port's in-cluster client (``kube/incluster.py``) against the
reference's ``RestClient`` on one plain-HTTP stub API server: for the same
calls both send the same method, path and body
(``tests/test_rest_client.py:81-100``) and map errors alike; and the
conflict-retried update (``kube/client.py::mutate_with_retry``)."""

import json
import threading
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tpu_operator.kube import client as ref_client
from tpu_operator.kube.rest import RestClient, _resource_path as ref_path
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube.incluster import InClusterClient, _resource_path


@pytest.mark.parametrize(
    "args",
    [
        ("v1", "Pod", "ns1", "p1"),
        ("v1", "Pod", "ns1"),
        ("v1", "Node", "", "n1"),
        ("v1", "Node", "ignored", "n1"),  # cluster-scoped: no namespace
        ("v1", "Node"),
        ("v1", "Service", "tpu-operator", "gang"),
        ("apps/v1", "DaemonSet", "ns1", "tpu-operator-validator"),
        ("apps/v1", "DaemonSet", "ns 1", "a/b"),  # quoted
    ],
)
def test_resource_paths_match_the_reference(args):
    assert _resource_path(*args) == ref_path(*args)


class _Handler(BaseHTTPRequestHandler):
    script = []  # (status, body bytes) popped per request; then 200 {}
    requests = []

    def _serve(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        type(self).requests.append((self.command, self.path, json.loads(body) if body else None,
                                    self.headers.get("Authorization", "")))
        status, payload = type(self).script.pop(0) if type(self).script else (200, b"{}")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    do_GET = do_POST = do_PUT = do_DELETE = _serve

    def log_message(self, *a):
        pass


class _HttpRestClient(RestClient):
    def _make_conn(self, timeout: float = 30):
        return HTTPConnection(self.host, self.port, timeout=timeout)


class _HttpInCluster(InClusterClient):
    def _make_conn(self):
        return HTTPConnection(self.host, self.port, timeout=self.timeout_s)


@pytest.fixture()
def server(monkeypatch):
    monkeypatch.setenv("REST_LIST_PAGE_SIZE", "0")  # the reference's paging off: one GET a list
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _Handler.script, _Handler.requests = [], []
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def _clients(port):
    ref = _HttpRestClient(host="127.0.0.1", port=str(port), token="tok", insecure=True)
    ref.GET_RETRY_BACKOFF_S = 0.001
    port_client = _HttpInCluster(host="127.0.0.1", port=str(port), token="tok", insecure=True)
    port_client.GET_BACKOFF_S = 0.001
    return ref, port_client


POD = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p", "namespace": "ns"},
       "spec": {"containers": []}}
NODE = {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n1", "resourceVersion": "7"}}

CALLS = [
    ("get", ("v1", "Node", "n1"), (200, json.dumps(NODE).encode())),
    ("get_or_none", ("v1", "Pod", "gone", "ns"), (404, b"{}")),
    ("get_or_none", ("apps/v1", "DaemonSet", "tpu-operator-validator", "ns"), (200, b"{}")),
    ("list", ("v1", "Node"), (200, json.dumps({"items": [NODE]}).encode())),
    ("list", ("v1", "Pod", "ns"), (200, json.dumps({"items": []}).encode())),
    ("create", (POD,), (201, json.dumps(POD).encode())),
    ("update", (NODE,), (200, json.dumps(NODE).encode())),
    ("delete_if_exists", ("v1", "Service", "gang", "ns"), (200, b"{}")),
    ("delete_if_exists", ("v1", "Pod", "gone", "ns"), (404, b"{}")),
]


@pytest.mark.parametrize("verb,args,reply", CALLS, ids=[f"{c[0]}-{c[1][1] if isinstance(c[1][0], str) else c[1][0]['kind']}"
                                                           for c in CALLS])
def test_same_requests_and_results_as_the_reference(server, verb, args, reply):
    results, sent = [], []
    for client in _clients(server):
        _Handler.script, _Handler.requests = [reply], []
        results.append(getattr(client, verb)(*args))
        sent.append(_Handler.requests)
    assert sent[1] == sent[0]
    assert sent[1][0][3] == "Bearer tok"
    assert results[1] == results[0]


@pytest.mark.parametrize(
    "status,exc",
    [(404, (ref_client.NotFoundError, kclient.NotFoundError)),
     (409, (ref_client.ConflictError, kclient.ConflictError)),
     (403, (RuntimeError, RuntimeError))],
)
def test_error_mapping_matches_the_reference(server, status, exc):
    for client, want in zip(_clients(server), exc):
        _Handler.script, _Handler.requests = [(status, b"{}")], []
        call = client.update if status == 409 else client.get
        with pytest.raises(want):
            call(NODE) if status == 409 else call("v1", "Node", "n1")
        assert len(_Handler.requests) == 1  # no retry on 404/409/403


def test_reads_retry_transient_errors_writes_do_not(server):
    _, client = _clients(server)
    _Handler.script = [(500, b"boom"), (429, b"slow down"), (200, b'{"ok": true}')]
    assert client.get("v1", "Node", "n1") == {"ok": True}
    assert len(_Handler.requests) == 3
    _Handler.script, _Handler.requests = [(503, b"down")], []
    with pytest.raises(RuntimeError, match="503"):
        client.create(POD)
    assert len(_Handler.requests) == 1


def test_mutate_with_retry_rereads_after_a_conflict(server):
    """A 409 re-GETs and re-applies; an unchanged object writes nothing."""
    _, client = _clients(server)
    fresh = dict(NODE, metadata={"name": "n1", "resourceVersion": "8"})
    _Handler.script = [(200, json.dumps(NODE).encode()), (409, b"{}"),
                       (200, json.dumps(fresh).encode()), (200, b"{}")]
    seen = []

    def mutate(obj):
        seen.append(obj["metadata"]["resourceVersion"])
        obj["metadata"].setdefault("annotations", {})["k"] = "v"
        return True

    out = kclient.mutate_with_retry(client, "v1", "Node", "n1", mutate=mutate, backoff_s=0.001)
    assert seen == ["7", "8"] and out["metadata"]["annotations"] == {"k": "v"}
    assert [r[0] for r in _Handler.requests] == ["GET", "PUT", "GET", "PUT"]
    _Handler.script, _Handler.requests = [(200, json.dumps(NODE).encode())], []
    kclient.mutate_with_retry(client, "v1", "Node", "n1", mutate=lambda obj: False)
    assert [r[0] for r in _Handler.requests] == ["GET"]


def test_no_client_outside_a_pod(tmp_path, monkeypatch):
    """Without the service account's CA there is no client; the sandbox
    components then validate without the workload-config gate."""
    import logging

    from tpu_operator_torch.kube import incluster
    from tpu_operator_torch.validator import main as cli

    monkeypatch.setattr(incluster, "SA_DIR", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="CA bundle"):
        InClusterClient()
    assert cli._client_or_none(logging.getLogger("t")) is None


@pytest.mark.parametrize(
    "status,exc",
    [(201, None), (404, (ref_client.NotFoundError, kclient.NotFoundError)),
     (429, (ref_client.EvictionBlockedError, kclient.EvictionBlockedError))],
)
def test_evict_matches_the_reference(server, status, exc):
    """``evict`` POSTs the reference's Eviction to the Pod's eviction
    subresource, once; 404 is the Pod already gone, 429 a disruption
    budget's veto."""
    sent = []
    for i, client in enumerate(_clients(server)):
        _Handler.script, _Handler.requests = [(status, b'{"kind": "Status"}')], []
        if exc is None:
            client.evict("train-0", "ns")
        else:
            with pytest.raises(exc[i]):
                client.evict("train-0", "ns")
        sent.append(_Handler.requests)
    assert sent[1] == sent[0]
    assert [(m, p) for m, p, _, _ in sent[1]] == [("POST", "/api/v1/namespaces/ns/pods/train-0/eviction")]
    assert sent[1][0][2] == {"apiVersion": "policy/v1", "kind": "Eviction",
                             "metadata": {"name": "train-0", "namespace": "ns"}}
