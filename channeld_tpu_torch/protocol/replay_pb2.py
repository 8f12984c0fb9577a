# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/protocol/replay.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from channeld_tpu_torch.protocol import wire_pb2 as channeld__tpu_dot_protocol_dot_wire__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n"channeld_tpu/protocol/replay.proto\x12\x05chtpu\x1a channeld_tpu/protocol/wire.proto"A\n\x0cReplayPacket\x12\x12\n\noffsetTime\x18\x01 \x01(\x03\x12\x1d\n\x06packet\x18\x02 \x01(\x0b2\r.chtpu.Packet"5\n\rReplaySession\x12$\n\x07packets\x18\x01 \x03(\x0b2\x13.chtpu.ReplayPacketb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.protocol.replay_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REPLAYPACKET._serialized_start=79
  _REPLAYPACKET._serialized_end=144
  _REPLAYSESSION._serialized_start=146
  _REPLAYSESSION._serialized_end=199
# @@protoc_insertion_point(module_scope)
