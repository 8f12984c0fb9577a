# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/compat/unitypb.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n!channeld_tpu/compat/unitypb.proto\x12\nchanneldpb\"+\n\x08Vector3f\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\"6\n\x08Vector4f\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\x12\t\n\x01w\x18\x04 \x01(\x02\"\x96\x01\n\x0eTransformState\x12\x0f\n\x07removed\x18\x01 \x01(\x08\x12&\n\x08position\x18\x02 \x01(\x0b\x32\x14.channeldpb.Vector3f\x12&\n\x08rotation\x18\x03 \x01(\x0b\x32\x14.channeldpb.Vector4f\x12#\n\x05scale\x18\x04 \x01(\x0b\x32\x14.channeldpb.Vector3fb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.compat.unitypb_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VECTOR3F._serialized_start=49
  _VECTOR3F._serialized_end=92
  _VECTOR4F._serialized_start=94
  _VECTOR4F._serialized_end=148
  _TRANSFORMSTATE._serialized_start=151
  _TRANSFORMSTATE._serialized_end=301
# @@protoc_insertion_point(module_scope)
