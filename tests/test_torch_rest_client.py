"""The port's REST client (``kube/rest.py``) against the JAX package's on a
plain-HTTP stub API server, on the 13 cases of ``tests/test_rest_client.py``:
resource paths, the bearer token, error mapping, transient retries of reads
and writes and their exhaustion, Retry-After, the per-call budget, the
circuit breaker (and 429s that never trip it), the CRUD paths, and the
list-then-watch stream.

Each case runs on each package (``two_sided.hold``) against its own stub
server answering the same script, with the reference's assertions made on
each side; the requests the stub saw (method, path, authorization), the
results, the error class names and the policy's counters must be equal.
The reference checks that a 0.2 s Retry-After was waited by reading the
clock; here the client's sleeps are recorded instead, so no time is
asserted. Tolerance: exact equality. Every stub server is shut down in a
``finally``.
"""

import json
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from tests.two_sided import BY_SIDE, hold
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import rest as ref_rest
from tpu_operator_torch import consts
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import rest

SIDES = {"reference": SimpleNamespace(name="reference", rest=ref_rest, k=ref_kclient),
         "port": SimpleNamespace(name="port", rest=rest, k=kclient)}


class Handler(BaseHTTPRequestHandler):
    """Pops one ``(status, body[, headers])`` a request from ``script``
    (200 ``{}`` when it is empty) and records each request."""

    script, requests = [], []

    def _serve(self):
        type(self).requests.append((self.command, self.path, self.headers.get("Authorization", "")))
        status, body, headers = 200, b"{}", {}
        if type(self).script:
            entry = type(self).script.pop(0)
            status, body = entry[0], entry[1]
            headers = entry[2] if len(entry) > 2 else {}
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = do_PUT = do_DELETE = _serve

    def log_message(self, *a):
        pass


def http_client(side, port):
    """The side's ``RestClient`` over plain HTTP to the stub."""

    class HttpRestClient(side.rest.RestClient):
        def _make_conn(self, timeout: float = 30):
            return HTTPConnection(self.host, self.port, timeout=timeout)

    return HttpRestClient(host="127.0.0.1", port=str(port), token="test-token", insecure=True)


def on_stub(fn):
    """``fn(side, client)`` against a fresh stub server, its script and
    log reset; returns ``fn``'s outcome and the requests the stub saw."""

    def script(side, *args):
        server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        Handler.script, Handler.requests = [], []
        try:
            client = http_client(side, server.server_address[1])
            client.GET_RETRY_BACKOFF_S = 0.01
            return fn(side, client, *args), list(Handler.requests)
        finally:
            server.shutdown()
            server.server_close()

    script.__qualname__ = fn.__qualname__
    return script


NODE = {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n"}}


def raised(cls, fn, *a, **kw):
    with pytest.raises(cls) as err:
        fn(*a, **kw)
    return type(err.value).__name__


@BY_SIDE
def test_resource_paths(side):
    def script(side):
        p = side.rest._resource_path
        cases = [(("v1", "Pod", "ns1", "p1"), "/api/v1/namespaces/ns1/pods/p1"),
                 (("v1", "Node", "", "n1"), "/api/v1/nodes/n1"),
                 (("apps/v1", "DaemonSet", "ns1"), "/apis/apps/v1/namespaces/ns1/daemonsets"),
                 ((f"{consts.GROUP}/v1", "ClusterPolicy", "", "cp"), f"/apis/{consts.GROUP}/v1/clusterpolicies/cp"),
                 (("v1", "Node", "ignored", "n1"), "/api/v1/nodes/n1")]  # cluster-scoped: no namespace
        got = [p(*args) for args, _ in cases]
        assert got == [want for _, want in cases]
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_get_and_bearer_token(side):
    @on_stub
    def script(side, client):
        Handler.script = [(200, json.dumps({"kind": "Node"}).encode())]
        obj = client.get("v1", "Node", "n1")
        assert obj["kind"] == "Node"
        assert Handler.requests[0] == ("GET", "/api/v1/nodes/n1", "Bearer test-token")
        return obj

    hold(SIDES, side, script)


@BY_SIDE
def test_error_mapping(side):
    @on_stub
    def script(side, client):
        Handler.script = [(404, b"{}")]
        got = [raised(side.k.NotFoundError, client.get, "v1", "Node", "gone")]
        Handler.script = [(409, b"{}")]
        got.append(raised(side.k.ConflictError, client.update, dict(NODE)))
        Handler.script = [(403, b"forbidden")]
        with pytest.raises(RuntimeError, match="403") as err:
            client.get("v1", "Node", "n1")
        got.append(type(err.value).__name__)
        assert len(Handler.requests) == 3  # no retry on 404, 409 or 403
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_get_retries_transient_then_succeeds(side):
    @on_stub
    def script(side, client):
        Handler.script = [(500, b"boom"), (429, b"slow down"), (200, json.dumps({"ok": True}).encode())]
        got = client.get("v1", "Node", "n1")
        assert got == {"ok": True} and len(Handler.requests) == 3
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_get_retries_exhausted(side):
    @on_stub
    def script(side, client):
        Handler.script = [(500, b"boom")] * 5
        got = raised(side.rest.TransientAPIError, client.get, "v1", "Node", "n1")
        assert len(Handler.requests) == client.GET_RETRIES
        return got, client.GET_RETRIES

    hold(SIDES, side, script)


@BY_SIDE
def test_writes_retry_transient_then_succeed(side):
    @on_stub
    def script(side, client):
        Handler.script = [(500, b"boom"), (503, b"still booting")]
        client.create({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p", "namespace": "ns1"}})
        assert len(Handler.requests) == 3
        assert client.retry_policy.stats()["retries_by_verb"]["POST"] == 2
        return client.retry_policy.stats()

    hold(SIDES, side, script)


@BY_SIDE
def test_writes_retry_exhausted(side):
    @on_stub
    def script(side, client):
        Handler.script = [(500, b"boom")] * 10
        got = raised(side.rest.TransientAPIError, client.update, dict(NODE))
        assert len(Handler.requests) == client.retry_policy.write_attempts
        return got, client.retry_policy.write_attempts

    hold(SIDES, side, script)


@BY_SIDE
def test_429_honors_retry_after(side, monkeypatch):
    """The server's delay wins over the (much smaller) base backoff."""
    real_sleep, slept = time.sleep, []

    def recording_sleep(s):
        slept.append(s)
        real_sleep(s)

    monkeypatch.setattr(time, "sleep", recording_sleep)

    @on_stub
    def script(side, client):
        slept.clear()
        Handler.script = [(429, b"slow down", {"Retry-After": "0.2"}), (200, b"{}")]
        client.update(dict(NODE))
        assert 0.2 in slept, slept
        assert len(Handler.requests) == 2
        assert client.retry_policy.stats()["retry_after_honored"] == 1
        return slept[-1], client.retry_policy.stats()["retry_after_honored"]

    hold(SIDES, side, script)


@BY_SIDE
def test_retry_budget_gives_up(side):
    """A hostile Retry-After cannot park the caller past its budget."""

    @on_stub
    def script(side, client):
        client.retry_policy.budget_s = 0.1
        Handler.script = [(429, b"slow down", {"Retry-After": "60"})] * 5
        got = raised(side.rest.TransientAPIError, client.update, dict(NODE))
        assert len(Handler.requests) == 1  # the budget refused the 60 s sleep
        assert client.retry_policy.stats()["giveups_total"] == 1
        return got, client.retry_policy.stats()

    hold(SIDES, side, script)


@BY_SIDE
def test_circuit_breaker_trips_and_fast_fails(side):
    @on_stub
    def script(side, client):
        client.retry_policy.read_attempts = 1
        client.retry_policy.write_attempts = 1
        client.breaker.threshold = 3
        client.breaker.cooldown_base_s = 30.0
        Handler.script = [(500, b"boom")] * 3
        for _ in range(3):
            raised(side.rest.TransientAPIError, client.get, "v1", "Node", "n1")
        assert client.breaker.stats()["state"] == "open"
        wire_calls = len(Handler.requests)
        fast = raised(side.rest.CircuitOpenError, client.get, "v1", "Node", "n1")
        assert len(Handler.requests) == wire_calls  # failed fast, off the wire
        assert client.breaker.stats()["fast_fails_total"] == 1
        client.breaker._open_until = 0.0  # the cooldown lapses: half-open
        assert client.get("v1", "Node", "n1") == {}
        assert client.breaker.stats()["state"] == "closed"
        return fast, wire_calls, client.breaker.stats()["trips_total"]

    hold(SIDES, side, script)


@BY_SIDE
def test_429_never_trips_breaker(side):
    @on_stub
    def script(side, client):
        client.retry_policy.write_attempts = 2
        client.breaker.threshold = 2
        Handler.script = [(429, b"slow", {"Retry-After": "0.01"})] * 4
        got = raised(side.rest.TransientAPIError, client.update, dict(NODE))
        assert client.breaker.stats()["state"] == "closed"
        return got, client.breaker.stats()["state"]

    hold(SIDES, side, script)


@BY_SIDE
def test_crud_paths(side):
    @on_stub
    def script(side, client):
        pod = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p", "namespace": "ns1"}}
        client.create(pod)
        client.update(pod)
        client.update_status(pod)
        client.delete("v1", "Pod", "p", "ns1")
        got = [(m, p) for m, p, _ in Handler.requests]
        assert got == [("POST", "/api/v1/namespaces/ns1/pods"), ("PUT", "/api/v1/namespaces/ns1/pods/p"),
                       ("PUT", "/api/v1/namespaces/ns1/pods/p/status"),
                       ("DELETE", "/api/v1/namespaces/ns1/pods/p")]
        return got

    hold(SIDES, side, script)


class WatchHandler(BaseHTTPRequestHandler):
    """The first GET is the list; the second (``watch=true``) streams a
    MODIFIED and a DELETED event."""

    def do_GET(self):
        if "watch=true" not in self.path:
            body = json.dumps({"metadata": {"resourceVersion": "5"}, "items": [{"metadata": {"name": "n1"}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        assert "resourceVersion=5" in self.path
        self.send_response(200)
        self.end_headers()
        for event in ({"type": "MODIFIED", "object": {"metadata": {"name": "n1"}}},
                      {"type": "DELETED", "object": {"metadata": {"name": "n1"}}}):
            self.wfile.write(json.dumps(event).encode() + b"\n")
            self.wfile.flush()

    def log_message(self, *a):
        pass


@BY_SIDE
def test_watch_list_then_stream(side):
    def script(side):
        server = ThreadingHTTPServer(("127.0.0.1", 0), WatchHandler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        events, stop = [], threading.Event()
        try:
            client = http_client(side, server.server_address[1])

            def cb(etype, obj):
                events.append((etype, obj["metadata"]["name"]))
                if etype == "DELETED":
                    stop.set()

            t = threading.Thread(target=client.watch, args=("v1", "Node", cb), kwargs={"stop_event": stop},
                                 daemon=True)
            t.start()
            assert stop.wait(timeout=60)
            t.join(timeout=60)
        finally:
            stop.set()
            server.shutdown()
            server.server_close()
        assert events[0] == ("ADDED", "n1")  # from the list
        assert ("MODIFIED", "n1") in events
        assert events[-1] == ("DELETED", "n1")
        return events

    hold(SIDES, side, script)
