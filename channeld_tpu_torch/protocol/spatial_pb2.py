# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/protocol/spatial.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2
from channeld_tpu_torch.protocol import control_pb2 as channeld__tpu_dot_protocol_dot_control__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n#channeld_tpu/protocol/spatial.proto\x12\x05chtpu\x1a\x19google/protobuf/any.proto\x1a#channeld_tpu/protocol/control.proto".\n\x0bSpatialInfo\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01"e\n"CreateSpatialChannelsResultMessage\x12\x18\n\x10spatialChannelId\x18\x01 \x03(\r\x12\x10\n\x08metadata\x18\x02 \x01(\t\x12\x13\n\x0bownerConnId\x18\x03 \x01(\r"E\n\x1aQuerySpatialChannelMessage\x12\'\n\x0bspatialInfo\x18\x01 \x03(\x0b2\x12.chtpu.SpatialInfo"5\n QuerySpatialChannelResultMessage\x12\x11\n\tchannelId\x18\x01 \x03(\r"G\n\x1bSpatialChannelsReadyMessage\x12\x13\n\x0bserverIndex\x18\x01 \x01(\r\x12\x13\n\x0bserverCount\x18\x02 \x01(\r"\x83\x01\n\x1aChannelDataHandoverMessage\x12\x14\n\x0csrcChannelId\x18\x01 \x01(\r\x12\x14\n\x0cdstChannelId\x18\x02 \x01(\r\x12\x15\n\rcontextConnId\x18\x03 \x01(\r\x12"\n\x04data\x18\x04 \x01(\x0b2\x14.google.protobuf.Any"y\n\rSpatialRegion\x12\x1f\n\x03min\x18\x01 \x01(\x0b2\x12.chtpu.SpatialInfo\x12\x1f\n\x03max\x18\x02 \x01(\x0b2\x12.chtpu.SpatialInfo\x12\x11\n\tchannelId\x18\x03 \x01(\r\x12\x13\n\x0bserverIndex\x18\x04 \x01(\r"D\n\x1bSpatialRegionsUpdateMessage\x12%\n\x07regions\x18\x01 \x03(\x0b2\x14.chtpu.SpatialRegion"\xfe\x04\n\x14SpatialInterestQuery\x12;\n\x08spotsAOI\x18\x01 \x01(\x0b2$.chtpu.SpatialInterestQuery.SpotsAOIH\x00\x88\x01\x01\x127\n\x06boxAOI\x18\x02 \x01(\x0b2".chtpu.SpatialInterestQuery.BoxAOIH\x01\x88\x01\x01\x12=\n\tsphereAOI\x18\x03 \x01(\x0b2%.chtpu.SpatialInterestQuery.SphereAOIH\x02\x88\x01\x01\x129\n\x07coneAOI\x18\x04 \x01(\x0b2#.chtpu.SpatialInterestQuery.ConeAOIH\x03\x88\x01\x01\x1a<\n\x08SpotsAOI\x12!\n\x05spots\x18\x01 \x03(\x0b2\x12.chtpu.SpatialInfo\x12\r\n\x05dists\x18\x02 \x03(\r\x1aP\n\x06BoxAOI\x12"\n\x06center\x18\x01 \x01(\x0b2\x12.chtpu.SpatialInfo\x12"\n\x06extent\x18\x02 \x01(\x0b2\x12.chtpu.SpatialInfo\x1a?\n\tSphereAOI\x12"\n\x06center\x18\x01 \x01(\x0b2\x12.chtpu.SpatialInfo\x12\x0e\n\x06radius\x18\x02 \x01(\x01\x1as\n\x07ConeAOI\x12"\n\x06center\x18\x01 \x01(\x0b2\x12.chtpu.SpatialInfo\x12%\n\tdirection\x18\x02 \x01(\x0b2\x12.chtpu.SpatialInfo\x12\r\n\x05angle\x18\x03 \x01(\x01\x12\x0e\n\x06radius\x18\x04 \x01(\x01B\x0b\n\t_spotsAOIB\t\n\x07_boxAOIB\x0c\n\n_sphereAOIB\n\n\x08_coneAOI"r\n\x1cUpdateSpatialInterestMessage\x12\x0e\n\x06connId\x18\x01 \x01(\r\x12*\n\x05query\x18\x02 \x01(\x0b2\x1b.chtpu.SpatialInterestQuery\x12\x16\n\x0efollowEntityId\x18\x03 \x01(\r"\xe6\x01\n\x1aCreateEntityChannelMessage\x12\x10\n\x08entityId\x18\x01 \x01(\r\x12\x10\n\x08metadata\x18\x02 \x01(\t\x125\n\nsubOptions\x18\x03 \x01(\x0b2!.chtpu.ChannelSubscriptionOptions\x12"\n\x04data\x18\x04 \x01(\x0b2\x14.google.protobuf.Any\x124\n\x0cmergeOptions\x18\x05 \x01(\x0b2\x1e.chtpu.ChannelDataMergeOptions\x12\x13\n\x0bisWellKnown\x18\x06 \x01(\x08"T\n\x15AddEntityGroupMessage\x12$\n\x04type\x18\x01 \x01(\x0e2\x16.chtpu.EntityGroupType\x12\x15\n\rEntitiesToAdd\x18\x02 \x03(\r"Z\n\x18RemoveEntityGroupMessage\x12$\n\x04type\x18\x01 \x01(\x0e2\x16.chtpu.EntityGroupType\x12\x18\n\x10EntitiesToRemove\x18\x02 \x03(\r"\xdb\x01\n\x13CellRehostedMessage\x12\x1c\n\tchannelId\x18\x01 \x01(\rR\tchannelId\x12(\n\x0fprevOwnerConnId\x18\x02 \x01(\rR\x0fprevOwnerConnId\x12&\n\x0enewOwnerConnId\x18\x03 \x01(\rR\x0enewOwnerConnId\x12\x1c\n\tentityIds\x18\x04 \x03(\rR\tentityIds\x126\n\x0bchannelData\x18\x05 \x01(\x0b2\x14.google.protobuf.AnyR\x0bchannelData"\xfd\x01\n\x13CellMigratedMessage\x12\x1c\n\tchannelId\x18\x01 \x01(\rR\tchannelId\x12(\n\x0fprevOwnerConnId\x18\x02 \x01(\rR\x0fprevOwnerConnId\x12&\n\x0enewOwnerConnId\x18\x03 \x01(\rR\x0enewOwnerConnId\x12\x1c\n\tentityIds\x18\x04 \x03(\rR\tentityIds\x126\n\x0bchannelData\x18\x05 \x01(\x0b2\x14.google.protobuf.AnyR\x0bchannelData\x12 \n\x0bmigrationId\x18\x06 \x01(\rR\x0bmigrationId"\xed\x01\n\x19CellGeometryUpdateMessage\x12\x11\n\tchannelId\x18\x01 \x01(\r\x12\x17\n\x0fprevOwnerConnId\x18\x02 \x01(\r\x12\x16\n\x0enewOwnerConnId\x18\x03 \x01(\r\x12\x11\n\tentityIds\x18\x04 \x03(\r\x12)\n\x0bchannelData\x18\x05 \x01(\x0b2\x14.google.protobuf.Any\x12\x15\n\rgeometryEpoch\x18\x06 \x01(\x04\x12\x12\n\nsplitCells\x18\x07 \x03(\r\x12\n\n\x02op\x18\x08 \x01(\t\x12\x17\n\x0fparentChannelId\x18\t \x01(\r"\x1f\n\x1dDebugGetSpatialRegionsMessage*)\n\x0fEntityGroupType\x12\x0c\n\x08HANDOVER\x10\x00\x12\x08\n\x04LOCK\x10\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.protocol.spatial_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTITYGROUPTYPE._serialized_start=2706
  _ENTITYGROUPTYPE._serialized_end=2747
  _SPATIALINFO._serialized_start=110
  _SPATIALINFO._serialized_end=156
  _CREATESPATIALCHANNELSRESULTMESSAGE._serialized_start=158
  _CREATESPATIALCHANNELSRESULTMESSAGE._serialized_end=259
  _QUERYSPATIALCHANNELMESSAGE._serialized_start=261
  _QUERYSPATIALCHANNELMESSAGE._serialized_end=330
  _QUERYSPATIALCHANNELRESULTMESSAGE._serialized_start=332
  _QUERYSPATIALCHANNELRESULTMESSAGE._serialized_end=385
  _SPATIALCHANNELSREADYMESSAGE._serialized_start=387
  _SPATIALCHANNELSREADYMESSAGE._serialized_end=458
  _CHANNELDATAHANDOVERMESSAGE._serialized_start=461
  _CHANNELDATAHANDOVERMESSAGE._serialized_end=592
  _SPATIALREGION._serialized_start=594
  _SPATIALREGION._serialized_end=715
  _SPATIALREGIONSUPDATEMESSAGE._serialized_start=717
  _SPATIALREGIONSUPDATEMESSAGE._serialized_end=785
  _SPATIALINTERESTQUERY._serialized_start=788
  _SPATIALINTERESTQUERY._serialized_end=1426
  _SPATIALINTERESTQUERY_SPOTSAOI._serialized_start=1052
  _SPATIALINTERESTQUERY_SPOTSAOI._serialized_end=1112
  _SPATIALINTERESTQUERY_BOXAOI._serialized_start=1114
  _SPATIALINTERESTQUERY_BOXAOI._serialized_end=1194
  _SPATIALINTERESTQUERY_SPHEREAOI._serialized_start=1196
  _SPATIALINTERESTQUERY_SPHEREAOI._serialized_end=1259
  _SPATIALINTERESTQUERY_CONEAOI._serialized_start=1261
  _SPATIALINTERESTQUERY_CONEAOI._serialized_end=1376
  _UPDATESPATIALINTERESTMESSAGE._serialized_start=1428
  _UPDATESPATIALINTERESTMESSAGE._serialized_end=1542
  _CREATEENTITYCHANNELMESSAGE._serialized_start=1545
  _CREATEENTITYCHANNELMESSAGE._serialized_end=1775
  _ADDENTITYGROUPMESSAGE._serialized_start=1777
  _ADDENTITYGROUPMESSAGE._serialized_end=1861
  _REMOVEENTITYGROUPMESSAGE._serialized_start=1863
  _REMOVEENTITYGROUPMESSAGE._serialized_end=1953
  _CELLREHOSTEDMESSAGE._serialized_start=1956
  _CELLREHOSTEDMESSAGE._serialized_end=2175
  _CELLMIGRATEDMESSAGE._serialized_start=2178
  _CELLMIGRATEDMESSAGE._serialized_end=2431
  _CELLGEOMETRYUPDATEMESSAGE._serialized_start=2434
  _CELLGEOMETRYUPDATEMESSAGE._serialized_end=2671
  _DEBUGGETSPATIALREGIONSMESSAGE._serialized_start=2673
  _DEBUGGETSPATIALREGIONSMESSAGE._serialized_end=2704
# @@protoc_insertion_point(module_scope)
