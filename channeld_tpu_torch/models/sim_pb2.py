# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/models/sim.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1d\x63hanneld_tpu/models/sim.proto\x12\tchtpu.sim\"H\n\x04Vec3\x12\x0e\n\x01x\x18\x01 \x01(\x02H\x00\x88\x01\x01\x12\x0e\n\x01y\x18\x02 \x01(\x02H\x01\x88\x01\x01\x12\x0e\n\x01z\x18\x03 \x01(\x02H\x02\x88\x01\x01\x42\x04\n\x02_xB\x04\n\x02_yB\x04\n\x02_z\"q\n\tTransform\x12!\n\x08position\x18\x01 \x01(\x0b\x32\x0f.chtpu.sim.Vec3\x12!\n\x08rotation\x18\x02 \x01(\x0b\x32\x0f.chtpu.sim.Vec3\x12\x1e\n\x05scale\x18\x03 \x01(\x0b\x32\x0f.chtpu.sim.Vec3\"\xa3\x01\n\x0b\x45ntityState\x12\x10\n\x08\x65ntityId\x18\x01 \x01(\r\x12\'\n\ttransform\x18\x02 \x01(\x0b\x32\x14.chtpu.sim.Transform\x12!\n\x08velocity\x18\x03 \x01(\x0b\x32\x0f.chtpu.sim.Vec3\x12\x0f\n\x07payload\x18\x04 \x01(\x0c\x12\x0f\n\x07removed\x18\x05 \x01(\x08\x12\x14\n\x0cowningConnId\x18\x06 \x01(\r\"\xa2\x01\n\x15SimSpatialChannelData\x12@\n\x08\x65ntities\x18\x01 \x03(\x0b\x32..chtpu.sim.SimSpatialChannelData.EntitiesEntry\x1aG\n\rEntitiesEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.chtpu.sim.EntityState:\x02\x38\x01\"=\n\x14SimEntityChannelData\x12%\n\x05state\x18\x01 \x01(\x0b\x32\x16.chtpu.sim.EntityState\"v\n\x14SimGlobalChannelData\x12\x33\n\x02kv\x18\x01 \x03(\x0b\x32\'.chtpu.sim.SimGlobalChannelData.KvEntry\x1a)\n\x07KvEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"A\n\tObjectRef\x12\r\n\x05netId\x18\x01 \x01(\r\x12\x14\n\x0cowningConnId\x18\x02 \x01(\r\x12\x0f\n\x07\x63ontext\x18\x03 \x01(\x0c\"m\n\x12SpawnObjectMessage\x12!\n\x03obj\x18\x01 \x01(\x0b\x32\x14.chtpu.sim.ObjectRef\x12\x11\n\tchannelId\x18\x02 \x01(\r\x12!\n\x08location\x18\x03 \x01(\x0b\x32\x0f.chtpu.sim.Vec3\"%\n\x14\x44\x65stroyObjectMessage\x12\r\n\x05netId\x18\x01 \x01(\r\"\xac\x01\n\x12\x45ngineRecoveryData\x12I\n\x0espawnedObjects\x18\x01 \x03(\x0b\x32\x31.chtpu.sim.EngineRecoveryData.SpawnedObjectsEntry\x1aK\n\x13SpawnedObjectsEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.chtpu.sim.ObjectRef:\x02\x38\x01\"_\n\x0fHandoverContext\x12!\n\x03obj\x18\x01 \x01(\x0b\x32\x14.chtpu.sim.ObjectRef\x12\x14\n\x0c\x63lientConnId\x18\x02 \x01(\r\x12\x13\n\x0b\x63lientState\x18\x03 \x01(\x0c\"u\n\x0fSimHandoverData\x12\x35\n\x0b\x63hannelData\x18\x01 \x01(\x0b\x32 .chtpu.sim.SimSpatialChannelData\x12+\n\x07\x63ontext\x18\x02 \x03(\x0b\x32\x1a.chtpu.sim.HandoverContextb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.models.sim_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SIMSPATIALCHANNELDATA_ENTITIESENTRY._options = None
  _SIMSPATIALCHANNELDATA_ENTITIESENTRY._serialized_options = b'8\001'
  _SIMGLOBALCHANNELDATA_KVENTRY._options = None
  _SIMGLOBALCHANNELDATA_KVENTRY._serialized_options = b'8\001'
  _ENGINERECOVERYDATA_SPAWNEDOBJECTSENTRY._options = None
  _ENGINERECOVERYDATA_SPAWNEDOBJECTSENTRY._serialized_options = b'8\001'
  _VEC3._serialized_start=44
  _VEC3._serialized_end=116
  _TRANSFORM._serialized_start=118
  _TRANSFORM._serialized_end=231
  _ENTITYSTATE._serialized_start=234
  _ENTITYSTATE._serialized_end=397
  _SIMSPATIALCHANNELDATA._serialized_start=400
  _SIMSPATIALCHANNELDATA._serialized_end=562
  _SIMSPATIALCHANNELDATA_ENTITIESENTRY._serialized_start=491
  _SIMSPATIALCHANNELDATA_ENTITIESENTRY._serialized_end=562
  _SIMENTITYCHANNELDATA._serialized_start=564
  _SIMENTITYCHANNELDATA._serialized_end=625
  _SIMGLOBALCHANNELDATA._serialized_start=627
  _SIMGLOBALCHANNELDATA._serialized_end=745
  _SIMGLOBALCHANNELDATA_KVENTRY._serialized_start=704
  _SIMGLOBALCHANNELDATA_KVENTRY._serialized_end=745
  _OBJECTREF._serialized_start=747
  _OBJECTREF._serialized_end=812
  _SPAWNOBJECTMESSAGE._serialized_start=814
  _SPAWNOBJECTMESSAGE._serialized_end=923
  _DESTROYOBJECTMESSAGE._serialized_start=925
  _DESTROYOBJECTMESSAGE._serialized_end=962
  _ENGINERECOVERYDATA._serialized_start=965
  _ENGINERECOVERYDATA._serialized_end=1137
  _ENGINERECOVERYDATA_SPAWNEDOBJECTSENTRY._serialized_start=1062
  _ENGINERECOVERYDATA_SPAWNEDOBJECTSENTRY._serialized_end=1137
  _HANDOVERCONTEXT._serialized_start=1139
  _HANDOVERCONTEXT._serialized_end=1234
  _SIMHANDOVERDATA._serialized_start=1236
  _SIMHANDOVERDATA._serialized_end=1353
# @@protoc_insertion_point(module_scope)
