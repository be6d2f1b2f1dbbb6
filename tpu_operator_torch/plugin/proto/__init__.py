"""The kubelet's DevicePlugin ``v1beta1`` wire API.

``deviceplugin_pb2`` is the protoc output of ``deviceplugin.proto``, the
same file as the JAX package's, byte for byte: protobuf's default pool
accepts an identical file twice, so both packages' messages are one set of
classes in a process that imports both. Import it by its package path
(``tpu_operator_torch.plugin.proto.deviceplugin_pb2``), inside the
function that needs it: importing this package needs no protobuf.
"""
