# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: deviceplugin.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12\x64\x65viceplugin.proto\x12\x07v1beta1\"\x07\n\x05\x45mpty\"]\n\x13\x44\x65vicePluginOptions\x12\x1a\n\x12pre_start_required\x18\x01 \x01(\x08\x12*\n\"get_preferred_allocation_available\x18\x02 \x01(\x08\"z\n\x0fRegisterRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x10\n\x08\x65ndpoint\x18\x02 \x01(\t\x12\x15\n\rresource_name\x18\x03 \x01(\t\x12-\n\x07options\x18\x04 \x01(\x0b\x32\x1c.v1beta1.DevicePluginOptions\"\x16\n\x08NUMANode\x12\n\n\x02ID\x18\x01 \x01(\x03\"0\n\x0cTopologyInfo\x12 \n\x05nodes\x18\x01 \x03(\x0b\x32\x11.v1beta1.NUMANode\"M\n\x06\x44\x65vice\x12\n\n\x02ID\x18\x01 \x01(\t\x12\x0e\n\x06health\x18\x02 \x01(\t\x12\'\n\x08topology\x18\x03 \x01(\x0b\x32\x15.v1beta1.TopologyInfo\"8\n\x14ListAndWatchResponse\x12 \n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x0f.v1beta1.Device\".\n\x18\x43ontainerAllocateRequest\x12\x12\n\ndevicesIDs\x18\x01 \x03(\t\"P\n\x0f\x41llocateRequest\x12=\n\x12\x63ontainer_requests\x18\x01 \x03(\x0b\x32!.v1beta1.ContainerAllocateRequest\"E\n\x05Mount\x12\x16\n\x0e\x63ontainer_path\x18\x01 \x01(\t\x12\x11\n\thost_path\x18\x02 \x01(\t\x12\x11\n\tread_only\x18\x03 \x01(\x08\"L\n\nDeviceSpec\x12\x16\n\x0e\x63ontainer_path\x18\x01 \x01(\t\x12\x11\n\thost_path\x18\x02 \x01(\t\x12\x13\n\x0bpermissions\x18\x03 \x01(\t\"\x19\n\tCDIDevice\x12\x0c\n\x04name\x18\x01 \x01(\t\"\xf1\x02\n\x19\x43ontainerAllocateResponse\x12:\n\x04\x65nvs\x18\x01 \x03(\x0b\x32,.v1beta1.ContainerAllocateResponse.EnvsEntry\x12\x1e\n\x06mounts\x18\x02 \x03(\x0b\x32\x0e.v1beta1.Mount\x12$\n\x07\x64\x65vices\x18\x03 \x03(\x0b\x32\x13.v1beta1.DeviceSpec\x12H\n\x0b\x61nnotations\x18\x04 \x03(\x0b\x32\x33.v1beta1.ContainerAllocateResponse.AnnotationsEntry\x12\'\n\x0b\x63\x64i_devices\x18\x05 \x03(\x0b\x32\x12.v1beta1.CDIDevice\x1a+\n\tEnvsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"S\n\x10\x41llocateResponse\x12?\n\x13\x63ontainer_responses\x18\x01 \x03(\x0b\x32\".v1beta1.ContainerAllocateResponse\".\n\x18PreStartContainerRequest\x12\x12\n\ndevicesIDs\x18\x01 \x03(\t\"\x1b\n\x19PreStartContainerResponse\"{\n#ContainerPreferredAllocationRequest\x12\x1b\n\x13\x61vailable_deviceIDs\x18\x01 \x03(\t\x12\x1e\n\x16must_include_deviceIDs\x18\x02 \x03(\t\x12\x17\n\x0f\x61llocation_size\x18\x03 \x01(\x05\"i\n\x1dGetPreferredAllocationRequest\x12H\n\x12\x63ontainer_requests\x18\x01 \x03(\x0b\x32,.v1beta1.ContainerPreferredAllocationRequest\"9\n$ContainerPreferredAllocationResponse\x12\x11\n\tdeviceIDs\x18\x01 \x03(\t\"l\n\x1eGetPreferredAllocationResponse\x12J\n\x13\x63ontainer_responses\x18\x01 \x03(\x0b\x32-.v1beta1.ContainerPreferredAllocationResponse2F\n\x0cRegistration\x12\x36\n\x08Register\x12\x18.v1beta1.RegisterRequest\x1a\x0e.v1beta1.Empty\"\x00\x32\xa9\x03\n\x0c\x44\x65vicePlugin\x12H\n\x16GetDevicePluginOptions\x12\x0e.v1beta1.Empty\x1a\x1c.v1beta1.DevicePluginOptions\"\x00\x12\x41\n\x0cListAndWatch\x12\x0e.v1beta1.Empty\x1a\x1d.v1beta1.ListAndWatchResponse\"\x00\x30\x01\x12k\n\x16GetPreferredAllocation\x12&.v1beta1.GetPreferredAllocationRequest\x1a\'.v1beta1.GetPreferredAllocationResponse\"\x00\x12\x41\n\x08\x41llocate\x12\x18.v1beta1.AllocateRequest\x1a\x19.v1beta1.AllocateResponse\"\x00\x12\\\n\x11PreStartContainer\x12!.v1beta1.PreStartContainerRequest\x1a\".v1beta1.PreStartContainerResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'deviceplugin_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CONTAINERALLOCATERESPONSE_ENVSENTRY._options = None
  _CONTAINERALLOCATERESPONSE_ENVSENTRY._serialized_options = b'8\001'
  _CONTAINERALLOCATERESPONSE_ANNOTATIONSENTRY._options = None
  _CONTAINERALLOCATERESPONSE_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _EMPTY._serialized_start=31
  _EMPTY._serialized_end=38
  _DEVICEPLUGINOPTIONS._serialized_start=40
  _DEVICEPLUGINOPTIONS._serialized_end=133
  _REGISTERREQUEST._serialized_start=135
  _REGISTERREQUEST._serialized_end=257
  _NUMANODE._serialized_start=259
  _NUMANODE._serialized_end=281
  _TOPOLOGYINFO._serialized_start=283
  _TOPOLOGYINFO._serialized_end=331
  _DEVICE._serialized_start=333
  _DEVICE._serialized_end=410
  _LISTANDWATCHRESPONSE._serialized_start=412
  _LISTANDWATCHRESPONSE._serialized_end=468
  _CONTAINERALLOCATEREQUEST._serialized_start=470
  _CONTAINERALLOCATEREQUEST._serialized_end=516
  _ALLOCATEREQUEST._serialized_start=518
  _ALLOCATEREQUEST._serialized_end=598
  _MOUNT._serialized_start=600
  _MOUNT._serialized_end=669
  _DEVICESPEC._serialized_start=671
  _DEVICESPEC._serialized_end=747
  _CDIDEVICE._serialized_start=749
  _CDIDEVICE._serialized_end=774
  _CONTAINERALLOCATERESPONSE._serialized_start=777
  _CONTAINERALLOCATERESPONSE._serialized_end=1146
  _CONTAINERALLOCATERESPONSE_ENVSENTRY._serialized_start=1051
  _CONTAINERALLOCATERESPONSE_ENVSENTRY._serialized_end=1094
  _CONTAINERALLOCATERESPONSE_ANNOTATIONSENTRY._serialized_start=1096
  _CONTAINERALLOCATERESPONSE_ANNOTATIONSENTRY._serialized_end=1146
  _ALLOCATERESPONSE._serialized_start=1148
  _ALLOCATERESPONSE._serialized_end=1231
  _PRESTARTCONTAINERREQUEST._serialized_start=1233
  _PRESTARTCONTAINERREQUEST._serialized_end=1279
  _PRESTARTCONTAINERRESPONSE._serialized_start=1281
  _PRESTARTCONTAINERRESPONSE._serialized_end=1308
  _CONTAINERPREFERREDALLOCATIONREQUEST._serialized_start=1310
  _CONTAINERPREFERREDALLOCATIONREQUEST._serialized_end=1433
  _GETPREFERREDALLOCATIONREQUEST._serialized_start=1435
  _GETPREFERREDALLOCATIONREQUEST._serialized_end=1540
  _CONTAINERPREFERREDALLOCATIONRESPONSE._serialized_start=1542
  _CONTAINERPREFERREDALLOCATIONRESPONSE._serialized_end=1599
  _GETPREFERREDALLOCATIONRESPONSE._serialized_start=1601
  _GETPREFERREDALLOCATIONRESPONSE._serialized_end=1709
  _REGISTRATION._serialized_start=1711
  _REGISTRATION._serialized_end=1781
  _DEVICEPLUGIN._serialized_start=1784
  _DEVICEPLUGIN._serialized_end=2209
# @@protoc_insertion_point(module_scope)
