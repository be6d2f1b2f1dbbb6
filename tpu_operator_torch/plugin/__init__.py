"""The device plugin: CDI spec generation (``cdi.py``), the kubelet's
gRPC service (``server.py``, ``grpc_glue.py``, ``proto/``) and one server a
resource (``manager.py``). grpc, protobuf and PyYAML are imported inside
the functions that need them.

    python -m tpu_operator_torch.plugin            # the device plugin
    python -m tpu_operator_torch.plugin.manager    # the sandbox plugin
"""
