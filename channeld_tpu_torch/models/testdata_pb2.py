# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/models/testdata.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\"channeld_tpu/models/testdata.proto\x12\x0e\x63htpu.testdata\"*\n\tTestEntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07removed\x18\x02 \x01(\x08\"\xb3\x02\n\x16TestChannelDataMessage\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x0b\n\x03num\x18\x02 \x01(\r\x12\x0c\n\x04list\x18\x03 \x03(\t\x12:\n\x02kv\x18\x04 \x03(\x0b\x32..chtpu.testdata.TestChannelDataMessage.KvEntry\x12@\n\x05\x61ttrs\x18\x05 \x03(\x0b\x32\x31.chtpu.testdata.TestChannelDataMessage.AttrsEntry\x1a\x44\n\x07KvEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.chtpu.testdata.TestEntry:\x02\x38\x01\x1a,\n\nAttrsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.models.testdata_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TESTCHANNELDATAMESSAGE_KVENTRY._options = None
  _TESTCHANNELDATAMESSAGE_KVENTRY._serialized_options = b'8\001'
  _TESTCHANNELDATAMESSAGE_ATTRSENTRY._options = None
  _TESTCHANNELDATAMESSAGE_ATTRSENTRY._serialized_options = b'8\001'
  _TESTENTRY._serialized_start=54
  _TESTENTRY._serialized_end=96
  _TESTCHANNELDATAMESSAGE._serialized_start=99
  _TESTCHANNELDATAMESSAGE._serialized_end=406
  _TESTCHANNELDATAMESSAGE_KVENTRY._serialized_start=292
  _TESTCHANNELDATAMESSAGE_KVENTRY._serialized_end=360
  _TESTCHANNELDATAMESSAGE_ATTRSENTRY._serialized_start=362
  _TESTCHANNELDATAMESSAGE_ATTRSENTRY._serialized_end=406
# @@protoc_insertion_point(module_scope)
