"""The Kubernetes client stack: the ``Client`` interface and its
``FakeClient`` (``client.py``), server-side apply (``apply.py``), the REST
client with its retry policy and breaker (``rest.py``, ``retry.py``), the
node agents' in-cluster client (``incluster.py``), KubeSim, the API server
over HTTP (``kubesim.py``), the kubelet's device manager
(``kubelet_sim.py``, the one module that needs grpc), and the control
plane's read and write paths: the watch-fed informer cache (``cache.py``),
the bounded write pipeline (``write_pipeline.py``), Events
(``events.py``) and the warm-restart journal (``warm.py``)."""
