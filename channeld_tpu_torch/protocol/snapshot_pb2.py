# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/protocol/snapshot.proto
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


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n$channeld_tpu/protocol/snapshot.proto\x12\x05chtpu\x1a\x19google/protobuf/any.proto\x1a channeld_tpu/protocol/wire.proto\x1a#channeld_tpu/protocol/control.proto"\xb9\x01\n\x0fChannelSnapshot\x12\x11\n\tchannelId\x18\x01 \x01(\r\x12\'\n\x0bchannelType\x18\x02 \x01(\x0e2\x12.chtpu.ChannelType\x12\x10\n\x08metadata\x18\x03 \x01(\t\x12"\n\x04data\x18\x04 \x01(\x0b2\x14.google.protobuf.Any\x124\n\x0cmergeOptions\x18\x05 \x01(\x0b2\x1e.chtpu.ChannelDataMergeOptions"7\n\x14StagedHandleSnapshot\x12\x0b\n\x03pit\x18\x01 \x01(\t\x12\x12\n\nchannelIds\x18\x02 \x03(\r"\xb1\x01\n\x0fJournalSnapshot\x12\r\n\x05txnId\x18\x01 \x01(\x04\x12\x10\n\x08entityId\x18\x02 \x01(\r\x12\x14\n\x0csrcChannelId\x18\x03 \x01(\r\x12\x14\n\x0cdstChannelId\x18\x04 \x01(\r\x12\x0e\n\x06remote\x18\x05 \x01(\x08\x12"\n\x04data\x18\x06 \x01(\x0b2\x14.google.protobuf.Any\x12\x0f\n\x07batchId\x18\x07 \x01(\x04\x12\x0c\n\x04peer\x18\x08 \x01(\t"c\n\x14AppliedBatchSnapshot\x12\x11\n\tinitiator\x18\x01 \x01(\t\x12\x0f\n\x07batchId\x18\x02 \x01(\x04\x12\x14\n\x0cdstChannelId\x18\x03 \x01(\r\x12\x11\n\tentityIds\x18\x04 \x03(\r"r\n\x15StandingQuerySnapshot\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12\r\n\x05scope\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x0c\n\x04kind\x18\x04 \x01(\r\x12\x0e\n\x06params\x18\x05 \x03(\x02\x12\x11\n\tspotDists\x18\x06 \x03(\r"\xbc\x03\n\x0fGatewaySnapshot\x12\x0f\n\x07takenAt\x18\x01 \x01(\x03\x12(\n\x08channels\x18\x02 \x03(\x0b2\x16.chtpu.ChannelSnapshot\x12\x11\n\tbannedIps\x18\x03 \x03(\t\x12\x12\n\nbannedPits\x18\x04 \x03(\t\x122\n\rstagedHandles\x18\x05 \x03(\x0b2\x1b.chtpu.StagedHandleSnapshot\x12\x18\n\x10directoryVersion\x18\x06 \x01(\x04\x12\x15\n\roverrideCells\x18\x07 \x03(\r\x12\x18\n\x10overrideGateways\x18\x08 \x03(\t\x12(\n\x08inFlight\x18\t \x03(\x0b2\x16.chtpu.JournalSnapshot\x12,\n\x07applied\x18\n \x03(\x0b2\x1b.chtpu.AppliedBatchSnapshot\x12\x0e\n\x06walSeq\x18\x0b \x01(\x04\x12\x15\n\rgeometryEpoch\x18\x0c \x01(\x04\x12\x12\n\nsplitCells\x18\r \x03(\r\x125\n\x0fstandingQueries\x18\x0e \x03(\x0b2\x1c.chtpu.StandingQuerySnapshotb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.protocol.snapshot_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CHANNELSNAPSHOT._serialized_start=146
  _CHANNELSNAPSHOT._serialized_end=331
  _STAGEDHANDLESNAPSHOT._serialized_start=333
  _STAGEDHANDLESNAPSHOT._serialized_end=388
  _JOURNALSNAPSHOT._serialized_start=391
  _JOURNALSNAPSHOT._serialized_end=568
  _APPLIEDBATCHSNAPSHOT._serialized_start=570
  _APPLIEDBATCHSNAPSHOT._serialized_end=669
  _STANDINGQUERYSNAPSHOT._serialized_start=671
  _STANDINGQUERYSNAPSHOT._serialized_end=785
  _GATEWAYSNAPSHOT._serialized_start=788
  _GATEWAYSNAPSHOT._serialized_end=1232
# @@protoc_insertion_point(module_scope)
