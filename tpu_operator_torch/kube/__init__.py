"""The Kubernetes client stack: the ``Client`` interface and its
``FakeClient`` (``client.py``), server-side apply (``apply.py``), the REST
client with its retry policy and breaker (``rest.py``, ``retry.py``), the
node agents' in-cluster client (``incluster.py``), KubeSim, the API server
over HTTP (``kubesim.py``), and the kubelet's device manager
(``kubelet_sim.py``, the one module that needs grpc)."""
