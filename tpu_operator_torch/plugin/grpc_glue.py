"""gRPC service and stub wiring for the DevicePlugin API.

The counterpart of ``tpu_operator/plugin/grpc_glue.py``: grpcio-tools is
not installed, so the servicer and stub wiring that ``protoc-gen-grpc``
would emit is written here by hand against the protoc-generated
``deviceplugin_pb2`` messages. grpc and protobuf are imported when a
handler or stub is built, never when this module is imported.
"""

from __future__ import annotations

API_VERSION = "v1beta1"
SERVICE_DEVICE_PLUGIN = "v1beta1.DevicePlugin"
SERVICE_REGISTRATION = "v1beta1.Registration"


def pb2():
    """The generated messages, by their package path."""
    from tpu_operator_torch.plugin.proto import deviceplugin_pb2

    return deviceplugin_pb2


def device_plugin_handler(servicer):
    """The generic handler for a DevicePlugin servicer exposing
    GetDevicePluginOptions / ListAndWatch / GetPreferredAllocation /
    Allocate / PreStartContainer."""
    import grpc

    m = pb2()
    rpcs = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=m.Empty.FromString,
            response_serializer=m.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=m.Empty.FromString,
            response_serializer=m.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=m.GetPreferredAllocationRequest.FromString,
            response_serializer=m.GetPreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=m.AllocateRequest.FromString,
            response_serializer=m.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=m.PreStartContainerRequest.FromString,
            response_serializer=m.PreStartContainerResponse.SerializeToString,
        ),
    }
    return grpc.method_handlers_generic_handler(SERVICE_DEVICE_PLUGIN, rpcs)


def registration_handler(servicer):
    """The generic handler for a Registration servicer (the kubelet's
    side; tests serve it)."""
    import grpc

    m = pb2()
    rpcs = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=m.RegisterRequest.FromString,
            response_serializer=m.Empty.SerializeToString,
        ),
    }
    return grpc.method_handlers_generic_handler(SERVICE_REGISTRATION, rpcs)


class DevicePluginStub:
    """Client stub: what the kubelet calls on the plugin's socket."""

    def __init__(self, channel):
        m = pb2()
        base = f"/{SERVICE_DEVICE_PLUGIN}/"
        self.GetDevicePluginOptions = channel.unary_unary(
            base + "GetDevicePluginOptions",
            request_serializer=m.Empty.SerializeToString,
            response_deserializer=m.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            base + "ListAndWatch",
            request_serializer=m.Empty.SerializeToString,
            response_deserializer=m.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            base + "GetPreferredAllocation",
            request_serializer=m.GetPreferredAllocationRequest.SerializeToString,
            response_deserializer=m.GetPreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            base + "Allocate",
            request_serializer=m.AllocateRequest.SerializeToString,
            response_deserializer=m.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            base + "PreStartContainer",
            request_serializer=m.PreStartContainerRequest.SerializeToString,
            response_deserializer=m.PreStartContainerResponse.FromString,
        )


class RegistrationStub:
    def __init__(self, channel):
        m = pb2()
        self.Register = channel.unary_unary(
            f"/{SERVICE_REGISTRATION}/Register",
            request_serializer=m.RegisterRequest.SerializeToString,
            response_deserializer=m.Empty.FromString,
        )
