# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/ops/service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x63hanneld_tpu/ops/service.proto\x12\tchtpu.ops\"C\n\x0e\x45ntityPosition\x12\x10\n\x08\x65ntityId\x18\x01 \x01(\r\x12\t\n\x01x\x18\x02 \x01(\x02\x12\t\n\x01y\x18\x03 \x01(\x02\x12\t\n\x01z\x18\x04 \x01(\x02\"\xcd\x01\n\rInterestQuery\x12\x0e\n\x06\x63onnId\x18\x01 \x01(\r\x12\x0c\n\x04kind\x18\x02 \x01(\r\x12\x0f\n\x07\x63\x65nterX\x18\x03 \x01(\x02\x12\x0f\n\x07\x63\x65nterZ\x18\x04 \x01(\x02\x12\x0f\n\x07\x65xtentX\x18\x05 \x01(\x02\x12\x0f\n\x07\x65xtentZ\x18\x06 \x01(\x02\x12\x0c\n\x04\x64irX\x18\x07 \x01(\x02\x12\x0c\n\x04\x64irZ\x18\x08 \x01(\x02\x12\r\n\x05\x61ngle\x18\t \x01(\x02\x12\r\n\x05spotX\x18\n \x03(\x02\x12\r\n\x05spotZ\x18\x0b \x03(\x02\x12\x11\n\tspotDists\x18\x0c \x03(\r\"K\n\x0cSubscription\x12\r\n\x05subId\x18\x01 \x01(\r\x12\x18\n\x10\x66\x61nOutIntervalMs\x18\x02 \x01(\r\x12\x12\n\nfirstDueMs\x18\x03 \x01(\x05\"\x89\x02\n\x0bStepRequest\x12*\n\x07updates\x18\x01 \x03(\x0b\x32\x19.chtpu.ops.EntityPosition\x12\x18\n\x10removedEntityIds\x18\x02 \x03(\r\x12)\n\x07queries\x18\x03 \x03(\x0b\x32\x18.chtpu.ops.InterestQuery\x12\x1b\n\x13removedQueryConnIds\x18\x04 \x03(\r\x12\x31\n\x10\x61\x64\x64Subscriptions\x18\x05 \x03(\x0b\x32\x17.chtpu.ops.Subscription\x12\x14\n\x0cremoveSubIds\x18\x06 \x03(\r\x12\r\n\x05nowMs\x18\x07 \x01(\x05\x12\x14\n\x0c\x66ullInterest\x18\x08 \x01(\x08\"A\n\x0bHandoverRow\x12\x10\n\x08\x65ntityId\x18\x01 \x01(\r\x12\x0f\n\x07srcCell\x18\x02 \x01(\r\x12\x0f\n\x07\x64stCell\x18\x03 \x01(\r\">\n\x0eInterestResult\x12\x0e\n\x06\x63onnId\x18\x01 \x01(\r\x12\r\n\x05\x63\x65lls\x18\x02 \x03(\r\x12\r\n\x05\x64ists\x18\x03 \x03(\r\"\xc9\x01\n\x0cStepResponse\x12)\n\thandovers\x18\x01 \x03(\x0b\x32\x16.chtpu.ops.HandoverRow\x12\x15\n\rhandoverCount\x18\x02 \x01(\r\x12\x12\n\ncellCounts\x18\x03 \x03(\r\x12,\n\tinterests\x18\x04 \x03(\x0b\x32\x19.chtpu.ops.InterestResult\x12\x11\n\tdueSubIds\x18\x05 \x03(\r\x12\x13\n\x0b\x65ngineNowMs\x18\x06 \x01(\x05\x12\r\n\x05\x65rror\x18\x07 \x01(\t\"\xf2\x01\n\rConfigRequest\x12\x14\n\x0cworldOffsetX\x18\x01 \x01(\x01\x12\x14\n\x0cworldOffsetZ\x18\x02 \x01(\x01\x12\x11\n\tgridWidth\x18\x03 \x01(\x01\x12\x12\n\ngridHeight\x18\x04 \x01(\x01\x12\x10\n\x08gridCols\x18\x05 \x01(\r\x12\x10\n\x08gridRows\x18\x06 \x01(\r\x12\x16\n\x0e\x65ntityCapacity\x18\x07 \x01(\r\x12\x15\n\rqueryCapacity\x18\x08 \x01(\r\x12\x13\n\x0bsubCapacity\x18\t \x01(\r\x12\x13\n\x0bmeshDevices\x18\n \x01(\r\x12\x11\n\tmeshHosts\x18\x0b \x01(\r\"\x07\n\x05\x45mpty2\xc6\x01\n\x0fSpatialDecision\x12\x37\n\tConfigure\x12\x18.chtpu.ops.ConfigRequest\x1a\x10.chtpu.ops.Empty\x12\x37\n\x04Step\x12\x16.chtpu.ops.StepRequest\x1a\x17.chtpu.ops.StepResponse\x12\x41\n\nStepStream\x12\x16.chtpu.ops.StepRequest\x1a\x17.chtpu.ops.StepResponse(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.ops.service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTITYPOSITION._serialized_start=45
  _ENTITYPOSITION._serialized_end=112
  _INTERESTQUERY._serialized_start=115
  _INTERESTQUERY._serialized_end=320
  _SUBSCRIPTION._serialized_start=322
  _SUBSCRIPTION._serialized_end=397
  _STEPREQUEST._serialized_start=400
  _STEPREQUEST._serialized_end=665
  _HANDOVERROW._serialized_start=667
  _HANDOVERROW._serialized_end=732
  _INTERESTRESULT._serialized_start=734
  _INTERESTRESULT._serialized_end=796
  _STEPRESPONSE._serialized_start=799
  _STEPRESPONSE._serialized_end=1000
  _CONFIGREQUEST._serialized_start=1003
  _CONFIGREQUEST._serialized_end=1245
  _EMPTY._serialized_start=1247
  _EMPTY._serialized_end=1254
  _SPATIALDECISION._serialized_start=1257
  _SPATIALDECISION._serialized_end=1455
# @@protoc_insertion_point(module_scope)
