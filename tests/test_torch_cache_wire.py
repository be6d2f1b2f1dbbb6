"""Two wire cases of ``tests/test_cache.py`` on each package that
``tests/test_torch_cache.py``'s matrix does not drive: an informer whose
watch goes silent without closing its socket recovers through a fresh
connection, and a stop event the caller passes stops the cache's own
threads.

Each case runs on each package (``two_sided.hold``), on the side's own
KubeSim seeded by its own ``seed_cluster`` (one node name for both) and
its own ``CachedClient`` over its own ``RestClient``; the outcomes (the
node names the informer converges on, whether every thread ended) must be
equal. The silent stream is the reference's TCP proxy, which swallows the
server's bytes on every connection open when it goes dark. Every wait is on a condition with a limit of 60 s or more (90 s for the
recovery, the reference's); no time is asserted. Every server, proxy and
socket is closed in a ``finally``.
"""

import socket
import threading
from types import SimpleNamespace

from tests.two_sided import BY_SIDE, hold
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube.cache import CachedClient as RefCachedClient
from tpu_operator_torch.kube import kubesim, testing
from tpu_operator_torch.kube.cache import CachedClient

NS = "tpu-operator"

SIDES = {
    "reference": SimpleNamespace(name="reference", kubesim=ref_kubesim, testing=ref_testing,
                                 CachedClient=RefCachedClient, node=ref_testing.make_tpu_node),
    "port": SimpleNamespace(name="port", kubesim=kubesim, testing=testing, CachedClient=CachedClient,
                            node=testing.make_gpu_node),
}


def wait_until(pred, timeout_s=60.0):
    return testing.wait_until(pred, timeout_s, 0.1)


class BlackholeProxy:
    """A TCP proxy in front of a server: connections open when it goes
    dark stop forwarding the server's bytes but stay open; connections
    dialled afterwards work."""

    def __init__(self, server_port):
        self.server_port = server_port
        self.frozen, self.conns = [], []
        self.stop = threading.Event()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(32)
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _pump(self, src, dst, dead, from_server):
        try:
            while not self.stop.is_set():
                data = src.recv(65536)
                if not data:
                    return
                if from_server and dead.is_set():
                    continue  # swallowed: the peer looks alive but is silent
                dst.sendall(data)
        except OSError:
            pass

    def _accept_loop(self):
        while not self.stop.is_set():
            try:
                cli, _ = self.sock.accept()
            except OSError:
                return
            srv = socket.create_connection(("127.0.0.1", self.server_port))
            self.conns.extend([cli, srv])
            dead = threading.Event()
            self.frozen.append(dead)
            threading.Thread(target=self._pump, args=(cli, srv, dead, False), daemon=True).start()
            threading.Thread(target=self._pump, args=(srv, cli, dead, True), daemon=True).start()

    def go_dark(self):
        for dead in list(self.frozen):
            dead.set()

    def close(self):
        self.stop.set()
        for s in [self.sock] + self.conns:
            try:
                s.close()
            except OSError:
                pass


@BY_SIDE
def test_informer_recovers_from_silently_dead_watch(side):
    """Every open stream goes silent; a node is deleted and one added
    meanwhile. The informer's read times out the dead window, re-lists
    over a fresh connection and converges."""

    def script(side):
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=0.5)).start()
        proxy, stop, names = None, threading.Event(), {}
        try:
            seed_client = side.kubesim.make_client(server.port)
            seed_client.GET_RETRY_BACKOFF_S = 0.05
            side.testing.seed_cluster(seed_client, NS, node_names=("bh-node-1",))
            proxy = BlackholeProxy(server.port)
            client = side.kubesim.make_client(proxy.port)
            client.GET_RETRY_BACKOFF_S = 0.05
            cached = side.CachedClient(client, namespace=NS, specs=[("v1", "Node", "")])
            assert cached.start_informers(stop, timeout_s=60)
            inf = cached._informers[("v1", "Node")]
            assert wait_until(lambda: len(inf.list()) == 1)
            names["before"] = sorted(n["metadata"]["name"] for n in inf.list())
            proxy.go_dark()
            seed_client.delete("v1", "Node", "bh-node-1")
            seed_client.create(side.node("bh-node-2"))
            converged = wait_until(lambda: {n["metadata"]["name"] for n in inf.list()} == {"bh-node-2"}, 90)
            names["after"] = sorted(n["metadata"]["name"] for n in inf.list())
            assert converged, names
            return names
        finally:
            stop.set()
            if proxy is not None:
                proxy.close()
            server.stop()

    hold(SIDES, side, script)


@BY_SIDE
def test_caller_stop_event_links_into_cache_stop(side):
    """A stop event the caller passes (the manager's) stops the cache's
    own threads too."""

    def script(side):
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(compact_keep=64, bookmark_interval_s=0.2)).start()
        try:
            client = side.kubesim.make_client(server.port)
            side.testing.seed_cluster(client, NS, node_names=("l-node-1",))
            stop = threading.Event()
            cached = side.CachedClient(client, namespace=NS, resync_interval_s=0.2)
            started = cached.start_informers(stop, timeout_s=60)
            assert started is True
            had_threads = bool(cached._threads)
            stop.set()
            ended = wait_until(lambda: all(not t.is_alive() for t in cached._threads), 60)
            assert ended, "the caller's stop event did not reach the cache's threads"
            return started, had_threads, ended
        finally:
            server.stop()

    hold(SIDES, side, script)
