# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/protocol/wal.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2
from channeld_tpu_torch.protocol import wire_pb2 as channeld__tpu_dot_protocol_dot_wire__pb2
from channeld_tpu_torch.protocol import control_pb2 as channeld__tpu_dot_protocol_dot_control__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1fchanneld_tpu/protocol/wal.proto\x12\x05chtpu\x1a\x19google/protobuf/any.proto\x1a channeld_tpu/protocol/wire.proto\x1a#channeld_tpu/protocol/control.proto"\xbc\x06\n\tWalRecord\x12\x0b\n\x03seq\x18\x01 \x01(\x04\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x11\n\tchannelId\x18\x03 \x01(\r\x12\'\n\x0bchannelType\x18\x04 \x01(\x0e2\x12.chtpu.ChannelType\x12\x10\n\x08metadata\x18\x05 \x01(\t\x12"\n\x04data\x18\x06 \x01(\x0b2\x14.google.protobuf.Any\x124\n\x0cmergeOptions\x18\x07 \x01(\x0b2\x1e.chtpu.ChannelDataMergeOptions\x12\n\n\x02op\x18\x08 \x01(\t\x12\r\n\x05txnId\x18\t \x01(\x04\x12\x10\n\x08entityId\x18\n \x01(\r\x12\x14\n\x0csrcChannelId\x18\x0b \x01(\r\x12\x14\n\x0cdstChannelId\x18\x0c \x01(\r\x12\x0e\n\x06remote\x18\r \x01(\x08\x12\x0f\n\x07batchId\x18\x0e \x01(\x04\x12\x0c\n\x04peer\x18\x0f \x01(\t\x12\x11\n\tentityIds\x18\x10 \x03(\r\x12\x0b\n\x03pit\x18\x11 \x01(\t\x12\x18\n\x10handleChannelIds\x18\x12 \x03(\r\x12\x18\n\x10directoryVersion\x18\x13 \x01(\x04\x12\x15\n\roverrideCells\x18\x14 \x03(\r\x12\x18\n\x10overrideGateways\x18\x15 \x03(\t\x12\x15\n\rblacklistKind\x18\x16 \x01(\t\x12\x14\n\x0cblacklistKey\x18\x17 \x01(\t\x12\x15\n\rgeometryEpoch\x18\x18 \x01(\x04\x12\x12\n\nsplitCells\x18\x19 \x03(\r\x12\x10\n\x08queryKey\x18\x1a \x01(\x04\x12\x12\n\nqueryScope\x18\x1b \x01(\t\x12\x11\n\tqueryName\x18\x1c \x01(\t\x12\x11\n\tqueryKind\x18\x1d \x01(\r\x12\x13\n\x0bqueryParams\x18\x1e \x03(\x02\x12\x16\n\x0equerySpotDists\x18\x1f \x03(\r\x12\x0f\n\x07simTick\x18  \x01(\x04\x12\x0f\n\x07simSeed\x18! \x01(\r\x12\x13\n\x0bsimAgentIds\x18" \x03(\r\x12\x13\n\x0bsimAgentPos\x18# \x03(\x02\x12\x13\n\x0bsimAgentVel\x18$ \x03(\x02\x12\x15\n\rsimAgentState\x18% \x03(\r\x12\x16\n\x0esimAgentTarget\x18& \x03(\x02b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.protocol.wal_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _WALRECORD._serialized_start=141
  _WALRECORD._serialized_end=969
# @@protoc_insertion_point(module_scope)
