# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/protocol/wire.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n channeld_tpu/protocol/wire.proto\x12\x05chtpu".\n\x06Packet\x12$\n\x08messages\x18\x01 \x03(\x0b2\x12.chtpu.MessagePack"e\n\x0bMessagePack\x12\x11\n\tchannelId\x18\x01 \x01(\r\x12\x11\n\tbroadcast\x18\x02 \x01(\r\x12\x0e\n\x06stubId\x18\x03 \x01(\r\x12\x0f\n\x07msgType\x18\x04 \x01(\r\x12\x0f\n\x07msgBody\x18\x05 \x01(\x0c"=\n\x14ServerForwardMessage\x12\x14\n\x0cclientConnId\x18\x01 \x01(\r\x12\x0f\n\x07payload\x18\x02 \x01(\x0c*\xa7\x01\n\rBroadcastType\x12\x10\n\x0cNO_BROADCAST\x10\x00\x12\x15\n\x11SINGLE_CONNECTION\x10\x01\x12\x07\n\x03ALL\x10\x02\x12\x12\n\x0eALL_BUT_SENDER\x10\x04\x12\x11\n\rALL_BUT_OWNER\x10\x08\x12\x12\n\x0eALL_BUT_CLIENT\x10\x10\x12\x12\n\x0eALL_BUT_SERVER\x10 \x12\x15\n\x11ADJACENT_CHANNELS\x10@*;\n\x0eConnectionType\x12\x11\n\rNO_CONNECTION\x10\x00\x12\n\n\x06SERVER\x10\x01\x12\n\n\x06CLIENT\x10\x02*\x90\x01\n\x0bChannelType\x12\x0b\n\x07UNKNOWN\x10\x00\x12\n\n\x06GLOBAL\x10\x01\x12\x0b\n\x07PRIVATE\x10\x02\x12\x0c\n\x08SUBWORLD\x10\x03\x12\x0b\n\x07SPATIAL\x10\x04\x12\n\n\x06ENTITY\x10\x05\x12\x08\n\x04TEST\x10d\x12\t\n\x05TEST1\x10e\x12\t\n\x05TEST2\x10f\x12\t\n\x05TEST3\x10g\x12\t\n\x05TEST4\x10h*1\n\x0fCompressionType\x12\x12\n\x0eNO_COMPRESSION\x10\x00\x12\n\n\x06SNAPPY\x10\x01*\xb7\x08\n\x0bMessageType\x12\x0b\n\x07INVALID\x10\x00\x12\x08\n\x04AUTH\x10\x01\x12\x12\n\x0eCREATE_CHANNEL\x10\x03\x12\x12\n\x0eREMOVE_CHANNEL\x10\x04\x12\x10\n\x0cLIST_CHANNEL\x10\x05\x12\x12\n\x0eSUB_TO_CHANNEL\x10\x06\x12\x16\n\x12UNSUB_FROM_CHANNEL\x10\x07\x12\x17\n\x13CHANNEL_DATA_UPDATE\x10\x08\x12\x0e\n\nDISCONNECT\x10\t\x12\x1a\n\x16CREATE_SPATIAL_CHANNEL\x10\n\x12\x19\n\x15QUERY_SPATIAL_CHANNEL\x10\x0b\x12\x19\n\x15CHANNEL_DATA_HANDOVER\x10\x0c\x12\x1a\n\x16SPATIAL_REGIONS_UPDATE\x10\r\x12\x1b\n\x17UPDATE_SPATIAL_INTEREST\x10\x0e\x12\x19\n\x15CREATE_ENTITY_CHANNEL\x10\x0f\x12\x14\n\x10ENTITY_GROUP_ADD\x10\x10\x12\x17\n\x13ENTITY_GROUP_REMOVE\x10\x11\x12\x1a\n\x16SPATIAL_CHANNELS_READY\x10\x12\x12\x19\n\x15RECOVERY_CHANNEL_DATA\x10\x14\x12\x10\n\x0cRECOVERY_END\x10\x15\x12\x16\n\x12CHANNEL_OWNER_LOST\x10\x16\x12\x1b\n\x17CHANNEL_OWNER_RECOVERED\x10\x17\x12\x0f\n\x0bSERVER_BUSY\x10\x18\x12\x11\n\rCELL_REHOSTED\x10\x19\x12\x11\n\rCELL_MIGRATED\x10\x1a\x12\x13\n\x0fCLIENT_REDIRECT\x10\x1b\x12\x18\n\x14CELL_GEOMETRY_UPDATE\x10\x1c\x12\x0f\n\x0bTRUNK_HELLO\x10\x1e\x12\x13\n\x0fTRUNK_HEARTBEAT\x10\x1f\x12\x1a\n\x16TRUNK_HANDOVER_PREPARE\x10 \x12\x16\n\x12TRUNK_HANDOVER_ACK\x10!\x12\x16\n\x12TRUNK_ABORT_NOTICE\x10"\x12\x18\n\x14TRUNK_STAGE_REDIRECT\x10#\x12\x13\n\x0fTRUNK_STAGE_ACK\x10$\x12\x1a\n\x16TRUNK_DIRECTORY_UPDATE\x10%\x12\x15\n\x11TRUNK_LOAD_REPORT\x10&\x12\x15\n\x11TRUNK_SHARD_EPOCH\x10\'\x12\x17\n\x13TRUNK_SHARD_MIGRATE\x10(\x12\x18\n\x14TRUNK_MIGRATE_STATUS\x10)\x12\x16\n\x12TRUNK_GATEWAY_DEAD\x10*\x12\x14\n\x10TRUNK_ADOPT_DONE\x10+\x12\x15\n\x11TRUNK_ADOPT_QUERY\x10,\x12\x16\n\x12TRUNK_ADOPT_CLAIMS\x10-\x12\x19\n\x15TRUNK_RESURRECT_HELLO\x10.\x12\x1d\n\x19DEBUG_GET_SPATIAL_REGIONS\x10c\x12\x14\n\x10USER_SPACE_START\x10db\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.protocol.wire_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BROADCASTTYPE._serialized_start=258
  _BROADCASTTYPE._serialized_end=425
  _CONNECTIONTYPE._serialized_start=427
  _CONNECTIONTYPE._serialized_end=486
  _CHANNELTYPE._serialized_start=489
  _CHANNELTYPE._serialized_end=633
  _COMPRESSIONTYPE._serialized_start=635
  _COMPRESSIONTYPE._serialized_end=684
  _MESSAGETYPE._serialized_start=687
  _MESSAGETYPE._serialized_end=1766
  _PACKET._serialized_start=43
  _PACKET._serialized_end=89
  _MESSAGEPACK._serialized_start=91
  _MESSAGEPACK._serialized_end=192
  _SERVERFORWARDMESSAGE._serialized_start=194
  _SERVERFORWARDMESSAGE._serialized_end=255
# @@protoc_insertion_point(module_scope)
