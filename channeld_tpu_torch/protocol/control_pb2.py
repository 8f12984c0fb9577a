# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/protocol/control.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2
from channeld_tpu_torch.protocol import wire_pb2 as channeld__tpu_dot_protocol_dot_wire__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n#channeld_tpu/protocol/control.proto\x12\x05chtpu\x1a\x19google/protobuf/any.proto\x1a channeld_tpu/protocol/wire.proto"@\n\x0bAuthMessage\x12\x1d\n\x15playerIdentifierToken\x18\x01 \x01(\t\x12\x12\n\nloginToken\x18\x02 \x01(\t"\xdf\x01\n\x11AuthResultMessage\x123\n\x06result\x18\x01 \x01(\x0e2#.chtpu.AuthResultMessage.AuthResult\x12\x0e\n\x06connId\x18\x02 \x01(\r\x12/\n\x0fcompressionType\x18\x03 \x01(\x0e2\x16.chtpu.CompressionType\x12\x15\n\rshouldRecover\x18\x04 \x01(\x08"=\n\nAuthResult\x12\x0e\n\nSUCCESSFUL\x10\x00\x12\x0f\n\x0bINVALID_PIT\x10\x01\x12\x0e\n\nINVALID_LT\x10\x02"\xc6\x02\n\x1aChannelSubscriptionOptions\x121\n\ndataAccess\x18\x01 \x01(\x0e2\x18.chtpu.ChannelDataAccessH\x00\x88\x01\x01\x12\x16\n\x0edataFieldMasks\x18\x02 \x03(\t\x12\x1d\n\x10fanOutIntervalMs\x18\x03 \x01(\rH\x01\x88\x01\x01\x12\x1a\n\rfanOutDelayMs\x18\x04 \x01(\x05H\x02\x88\x01\x01\x12!\n\x14skipSelfUpdateFanOut\x18\x05 \x01(\x08H\x03\x88\x01\x01\x12\x1c\n\x0fskipFirstFanOut\x18\x06 \x01(\x08H\x04\x88\x01\x01B\r\n\x0b_dataAccessB\x13\n\x11_fanOutIntervalMsB\x10\n\x0e_fanOutDelayMsB\x17\n\x15_skipSelfUpdateFanOutB\x12\n\x10_skipFirstFanOut"\x86\x01\n\x17ChannelDataMergeOptions\x12\x19\n\x11shouldReplaceList\x18\x01 \x01(\x08\x12\x15\n\rlistSizeLimit\x18\x02 \x01(\r\x12\x13\n\x0btruncateTop\x18\x03 \x01(\x08\x12$\n\x1cshouldCheckRemovableMapField\x18\x04 \x01(\x08"\xe2\x01\n\x14CreateChannelMessage\x12\'\n\x0bchannelType\x18\x01 \x01(\x0e2\x12.chtpu.ChannelType\x12\x10\n\x08metadata\x18\x02 \x01(\t\x125\n\nsubOptions\x18\x03 \x01(\x0b2!.chtpu.ChannelSubscriptionOptions\x12"\n\x04data\x18\x04 \x01(\x0b2\x14.google.protobuf.Any\x124\n\x0cmergeOptions\x18\x05 \x01(\x0b2\x1e.chtpu.ChannelDataMergeOptions"\x7f\n\x1aCreateChannelResultMessage\x12\'\n\x0bchannelType\x18\x01 \x01(\x0e2\x12.chtpu.ChannelType\x12\x10\n\x08metadata\x18\x02 \x01(\t\x12\x13\n\x0bownerConnId\x18\x03 \x01(\r\x12\x11\n\tchannelId\x18\x04 \x01(\r")\n\x14RemoveChannelMessage\x12\x11\n\tchannelId\x18\x01 \x01(\r"U\n\x12ListChannelMessage\x12&\n\ntypeFilter\x18\x01 \x01(\x0e2\x12.chtpu.ChannelType\x12\x17\n\x0fmetadataFilters\x18\x02 \x03(\t"\xb6\x01\n\x18ListChannelResultMessage\x12=\n\x08channels\x18\x01 \x03(\x0b2+.chtpu.ListChannelResultMessage.ChannelInfo\x1a[\n\x0bChannelInfo\x12\x11\n\tchannelId\x18\x01 \x01(\r\x12\'\n\x0bchannelType\x18\x02 \x01(\x0e2\x12.chtpu.ChannelType\x12\x10\n\x08metadata\x18\x03 \x01(\t"c\n\x1aSubscribedToChannelMessage\x12\x0e\n\x06connId\x18\x01 \x01(\r\x125\n\nsubOptions\x18\x02 \x01(\x0b2!.chtpu.ChannelSubscriptionOptions"\xbb\x01\n SubscribedToChannelResultMessage\x12\x0e\n\x06connId\x18\x01 \x01(\r\x125\n\nsubOptions\x18\x02 \x01(\x0b2!.chtpu.ChannelSubscriptionOptions\x12\'\n\x08connType\x18\x03 \x01(\x0e2\x15.chtpu.ConnectionType\x12\'\n\x0bchannelType\x18\x04 \x01(\x0e2\x12.chtpu.ChannelType"0\n\x1eUnsubscribedFromChannelMessage\x12\x0e\n\x06connId\x18\x01 \x01(\r"\x88\x01\n$UnsubscribedFromChannelResultMessage\x12\x0e\n\x06connId\x18\x01 \x01(\r\x12\'\n\x08connType\x18\x02 \x01(\x0e2\x15.chtpu.ConnectionType\x12\'\n\x0bchannelType\x18\x03 \x01(\x0e2\x12.chtpu.ChannelType"U\n\x18ChannelDataUpdateMessage\x12"\n\x04data\x18\x01 \x01(\x0b2\x14.google.protobuf.Any\x12\x15\n\rcontextConnId\x18\x02 \x01(\r"#\n\x11DisconnectMessage\x12\x0e\n\x06connId\x18\x01 \x01(\r"\xb4\x02\n\x1aChannelDataRecoveryMessage\x12\x11\n\tchannelId\x18\x01 \x01(\r\x12\'\n\x0bchannelType\x18\x02 \x01(\x0e2\x12.chtpu.ChannelType\x12\x10\n\x08metadata\x18\x03 \x01(\t\x12\x13\n\x0bownerConnId\x18\x04 \x01(\r\x12\x0f\n\x07subTime\x18\x05 \x01(\x03\x125\n\nsubOptions\x18\x06 \x01(\x0b2!.chtpu.ChannelSubscriptionOptions\x12)\n\x0bchannelData\x18\x07 \x01(\x0b2\x14.google.protobuf.Any\x12/\n\x0crecoveryData\x18\x08 \x01(\x0b2\x14.google.protobuf.AnyH\x00\x88\x01\x01B\x0f\n\r_recoveryData"\x14\n\x12EndRecoveryMessage"\x19\n\x17ChannelOwnerLostMessage"\x1e\n\x1cChannelOwnerRecoveredMessage"P\n\x11ServerBusyMessage\x12\x0e\n\x06reason\x18\x01 \x01(\t\x12\x14\n\x0cretryAfterMs\x18\x02 \x01(\r\x12\x15\n\roverloadLevel\x18\x03 \x01(\r"t\n\x15ClientRedirectMessage\x12\x11\n\tgatewayId\x18\x01 \x01(\t\x12\x0c\n\x04addr\x18\x02 \x01(\t\x12\x10\n\x08entityId\x18\x03 \x01(\r\x12\x11\n\tchannelId\x18\x04 \x01(\r\x12\x15\n\rrecoveryToken\x18\x05 \x01(\t"6\n\x11TrunkHelloMessage\x12\x11\n\tgatewayId\x18\x01 \x01(\t\x12\x0e\n\x06secret\x18\x02 \x01(\t"G\n\x15TrunkHeartbeatMessage\x12\x10\n\x08sentAtMs\x18\x01 \x01(\x04\x12\x0b\n\x03ack\x18\x02 \x01(\x08\x12\x0f\n\x07goodbye\x18\x03 \x01(\x08"Z\n\x13TrunkHandoverEntity\x12\x10\n\x08entityId\x18\x01 \x01(\r\x12\r\n\x05txnId\x18\x02 \x01(\x04\x12"\n\x04data\x18\x03 \x01(\x0b2\x14.google.protobuf.Any"\xa2\x01\n\x1bTrunkHandoverPrepareMessage\x12\x0f\n\x07batchId\x18\x01 \x01(\x04\x12\x14\n\x0csrcChannelId\x18\x02 \x01(\r\x12\x14\n\x0cdstChannelId\x18\x03 \x01(\r\x12,\n\x08entities\x18\x04 \x03(\x0b2\x1a.chtpu.TrunkHandoverEntity\x12\x18\n\x07traceId\x18\x05 \x01(\tR\x07traceId"\x8f\x01\n\x17TrunkHandoverAckMessage\x12\x0f\n\x07batchId\x18\x01 \x01(\x04\x12\x11\n\tcommitted\x18\x02 \x01(\x08\x12&\n\x04busy\x18\x03 \x01(\x0b2\x18.chtpu.ServerBusyMessage\x12\x0e\n\x06reason\x18\x04 \x01(\t\x12\x18\n\x07traceId\x18\x05 \x01(\tR\x07traceId"I\n\x17TrunkAbortNoticeMessage\x12\x10\n\x08batchIds\x18\x01 \x03(\x04\x12\x1c\n\tinitiator\x18\x02 \x01(\tR\tinitiator"w\n\x19TrunkStageRedirectMessage\x12\x0b\n\x03pit\x18\x01 \x01(\t\x12\x10\n\x08entityId\x18\x02 \x01(\r\x12\x12\n\nchannelIds\x18\x03 \x03(\r\x12\r\n\x05token\x18\x04 \x01(\t\x12\x18\n\x07traceId\x18\x05 \x01(\tR\x07traceId"E\n\x14TrunkStageAckMessage\x12\x0b\n\x03pit\x18\x01 \x01(\t\x12\n\n\x02ok\x18\x02 \x01(\x08\x12\x14\n\x0cstagedConnId\x18\x03 \x01(\r"\xd4\x01\n\x1bTrunkDirectoryUpdateMessage\x12B\n\toverrides\x18\x01 \x03(\x0b2/.chtpu.TrunkDirectoryUpdateMessage.CellOverride\x12\x0f\n\x07version\x18\x02 \x01(\x04\x12*\n\x10replaceOverrides\x18\x03 \x01(\x08R\x10replaceOverrides\x1a4\n\x0cCellOverride\x12\x11\n\tchannelId\x18\x01 \x01(\r\x12\x11\n\tgatewayId\x18\x02 \x01(\t"\xb3\x02\n\x16TrunkLoadReportMessage\x12\x11\n\tgatewayId\x18\x01 \x01(\t\x12\r\n\x05epoch\x18\x02 \x01(\x04\x12\x10\n\x08pressure\x18\x03 \x01(\x02\x12\x15\n\roverloadLevel\x18\x04 \x01(\r\x12\x10\n\x08entities\x18\x05 \x01(\r\x12\r\n\x05cells\x18\x06 \x01(\r\x12\x14\n\x0ccrossingRate\x18\x07 \x01(\x02\x12\x12\n\ntrunkRttMs\x18\x08 \x01(\x02\x12\x14\n\x0cblockIndices\x18\t \x03(\r\x12\x15\n\rblockEntities\x18\n \x03(\r\x12*\n\x10directoryVersion\x18\x0b \x01(\x04R\x10directoryVersion\x12\x13\n\x0bmetricsJson\x18\x0c \x01(\x0c\x12\x15\n\rgeometryEpoch\x18\r \x01(\x04"\xc6\x06\n\x16TrunkShardEpochMessage\x12\x10\n\x08epochSeq\x18\x01 \x01(\x04\x128\n\x05cells\x18\x02 \x03(\x0b2).chtpu.TrunkShardEpochMessage.ReplicaCell\x12<\n\x07handles\x18\x03 \x03(\x0b2+.chtpu.TrunkShardEpochMessage.ReplicaHandle\x126\n\x04txns\x18\x04 \x03(\x0b2(.chtpu.TrunkShardEpochMessage.ReplicaTxn\x12=\n\x07applied\x18\x05 \x03(\x0b2,.chtpu.TrunkShardEpochMessage.ReplicaApplied\x12;\n\x07queries\x18\x07 \x03(\x0b2*.chtpu.TrunkShardEpochMessage.ReplicaQuery\x12\x14\n\x05delta\x18\x06 \x01(\x08R\x05delta\x1aW\n\x0bReplicaCell\x12\x11\n\tchannelId\x18\x01 \x01(\r\x12"\n\x04data\x18\x02 \x01(\x0b2\x14.google.protobuf.Any\x12\x11\n\tentityIds\x18\x03 \x03(\r\x1aB\n\rReplicaHandle\x12\x0b\n\x03pit\x18\x01 \x01(\t\x12\x12\n\nchannelIds\x18\x02 \x03(\r\x12\x10\n\x08entityId\x18\x03 \x01(\r\x1a\x85\x01\n\nReplicaTxn\x12\x0f\n\x07batchId\x18\x01 \x01(\x04\x12\x14\n\x0csrcChannelId\x18\x02 \x01(\r\x12\x14\n\x0cdstChannelId\x18\x03 \x01(\r\x12\x0c\n\x04peer\x18\x04 \x01(\t\x12,\n\x08entities\x18\x05 \x03(\x0b2\x1a.chtpu.TrunkHandoverEntity\x1aH\n\x0eReplicaApplied\x12\x0f\n\x07batchId\x18\x01 \x01(\x04\x12\x11\n\tentityIds\x18\x02 \x03(\r\x12\x12\n\x04peer\x18\x03 \x01(\tR\x04peer\x1ai\n\x0cReplicaQuery\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12\r\n\x05scope\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x0c\n\x04kind\x18\x04 \x01(\r\x12\x0e\n\x06params\x18\x05 \x03(\x02\x12\x11\n\tspotDists\x18\x06 \x03(\r"\x99\x01\n\x18TrunkShardMigrateMessage\x12\x0e\n\x06planId\x18\x01 \x01(\x04\x12\x11\n\tchannelId\x18\x02 \x01(\r\x12\x12\n\nsrcGateway\x18\x03 \x01(\t\x12\x12\n\ndstGateway\x18\x04 \x01(\t\x12\x18\n\x10directoryVersion\x18\x05 \x01(\x04\x12\x18\n\x07traceId\x18\x06 \x01(\tR\x07traceId"w\n\x19TrunkMigrateStatusMessage\x12\x0e\n\x06planId\x18\x01 \x01(\x04\x12\x0e\n\x06result\x18\x02 \x01(\t\x12\x0e\n\x06reason\x18\x03 \x01(\t\x12\x10\n\x08entities\x18\x04 \x01(\r\x12\x18\n\x07traceId\x18\x05 \x01(\tR\x07traceId"\x9a\x01\n\x17TrunkGatewayDeadMessage\x12\x13\n\x0bdeadGateway\x18\x01 \x01(\t\x12\x16\n\x0eadopterGateway\x18\x02 \x01(\t\x12\r\n\x05epoch\x18\x03 \x01(\x04\x12\x18\n\x10directoryVersion\x18\x04 \x01(\x04\x12\x0f\n\x07cellIds\x18\x05 \x03(\r\x12\x18\n\x07traceId\x18\x06 \x01(\tR\x07traceId"\xaa\x01\n\x15TrunkAdoptDoneMessage\x12\x13\n\x0bdeadGateway\x18\x01 \x01(\t\x12\x16\n\x0eadopterGateway\x18\x02 \x01(\t\x12\r\n\x05cells\x18\x03 \x01(\r\x12\x10\n\x08entities\x18\x04 \x01(\r\x12\x0f\n\x07handles\x18\x05 \x01(\r\x12\x18\n\x07traceId\x18\x06 \x01(\tR\x07traceId\x12\x18\n\x10restoreEntityIds\x18\x07 \x03(\r"g\n\x16TrunkAdoptQueryMessage\x12\x13\n\x0bdeadGateway\x18\x01 \x01(\t\x12\x11\n\tentityIds\x18\x02 \x03(\r\x12\x18\n\x07traceId\x18\x03 \x01(\tR\x07traceId\x12\x0b\n\x03seq\x18\x04 \x01(\r"\xd2\x01\n\x1aTrunkResurrectHelloMessage\x12\x11\n\tgatewayId\x18\x01 \x01(\t\x12\x18\n\x10directoryVersion\x18\x02 \x01(\x04\x12\x0f\n\x07cellIds\x18\x03 \x03(\r\x12\x11\n\tentityIds\x18\x04 \x03(\r\x12\x0b\n\x03ack\x18\x05 \x01(\x08\x12\x14\n\x0cshardAdopted\x18\x06 \x01(\x08\x12\x11\n\tisAdopter\x18\x07 \x01(\x08\x12\x18\n\x10missingEntityIds\x18\x08 \x03(\r\x12\x13\n\x0bwalReplayed\x18\t \x01(\x04"\xa7\x01\n\x17TrunkAdoptClaimsMessage\x12\x13\n\x0bdeadGateway\x18\x01 \x01(\t\x12\x11\n\tgatewayId\x18\x02 \x01(\t\x12\x11\n\tentityIds\x18\x03 \x03(\r\x12\x0b\n\x03seq\x18\x04 \x01(\r\x12\x14\n\x0ccandidateIds\x18\x05 \x03(\r\x12.\n\x07replica\x18\x06 \x01(\x0b2\x1d.chtpu.TrunkShardEpochMessage*E\n\x11ChannelDataAccess\x12\r\n\tNO_ACCESS\x10\x00\x12\x0f\n\x0bREAD_ACCESS\x10\x01\x12\x10\n\x0cWRITE_ACCESS\x10\x02b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.protocol.control_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CHANNELDATAACCESS._serialized_start=5994
  _CHANNELDATAACCESS._serialized_end=6063
  _AUTHMESSAGE._serialized_start=107
  _AUTHMESSAGE._serialized_end=171
  _AUTHRESULTMESSAGE._serialized_start=174
  _AUTHRESULTMESSAGE._serialized_end=397
  _AUTHRESULTMESSAGE_AUTHRESULT._serialized_start=336
  _AUTHRESULTMESSAGE_AUTHRESULT._serialized_end=397
  _CHANNELSUBSCRIPTIONOPTIONS._serialized_start=400
  _CHANNELSUBSCRIPTIONOPTIONS._serialized_end=726
  _CHANNELDATAMERGEOPTIONS._serialized_start=729
  _CHANNELDATAMERGEOPTIONS._serialized_end=863
  _CREATECHANNELMESSAGE._serialized_start=866
  _CREATECHANNELMESSAGE._serialized_end=1092
  _CREATECHANNELRESULTMESSAGE._serialized_start=1094
  _CREATECHANNELRESULTMESSAGE._serialized_end=1221
  _REMOVECHANNELMESSAGE._serialized_start=1223
  _REMOVECHANNELMESSAGE._serialized_end=1264
  _LISTCHANNELMESSAGE._serialized_start=1266
  _LISTCHANNELMESSAGE._serialized_end=1351
  _LISTCHANNELRESULTMESSAGE._serialized_start=1354
  _LISTCHANNELRESULTMESSAGE._serialized_end=1536
  _LISTCHANNELRESULTMESSAGE_CHANNELINFO._serialized_start=1445
  _LISTCHANNELRESULTMESSAGE_CHANNELINFO._serialized_end=1536
  _SUBSCRIBEDTOCHANNELMESSAGE._serialized_start=1538
  _SUBSCRIBEDTOCHANNELMESSAGE._serialized_end=1637
  _SUBSCRIBEDTOCHANNELRESULTMESSAGE._serialized_start=1640
  _SUBSCRIBEDTOCHANNELRESULTMESSAGE._serialized_end=1827
  _UNSUBSCRIBEDFROMCHANNELMESSAGE._serialized_start=1829
  _UNSUBSCRIBEDFROMCHANNELMESSAGE._serialized_end=1877
  _UNSUBSCRIBEDFROMCHANNELRESULTMESSAGE._serialized_start=1880
  _UNSUBSCRIBEDFROMCHANNELRESULTMESSAGE._serialized_end=2016
  _CHANNELDATAUPDATEMESSAGE._serialized_start=2018
  _CHANNELDATAUPDATEMESSAGE._serialized_end=2103
  _DISCONNECTMESSAGE._serialized_start=2105
  _DISCONNECTMESSAGE._serialized_end=2140
  _CHANNELDATARECOVERYMESSAGE._serialized_start=2143
  _CHANNELDATARECOVERYMESSAGE._serialized_end=2451
  _ENDRECOVERYMESSAGE._serialized_start=2453
  _ENDRECOVERYMESSAGE._serialized_end=2473
  _CHANNELOWNERLOSTMESSAGE._serialized_start=2475
  _CHANNELOWNERLOSTMESSAGE._serialized_end=2500
  _CHANNELOWNERRECOVEREDMESSAGE._serialized_start=2502
  _CHANNELOWNERRECOVEREDMESSAGE._serialized_end=2532
  _SERVERBUSYMESSAGE._serialized_start=2534
  _SERVERBUSYMESSAGE._serialized_end=2614
  _CLIENTREDIRECTMESSAGE._serialized_start=2616
  _CLIENTREDIRECTMESSAGE._serialized_end=2732
  _TRUNKHELLOMESSAGE._serialized_start=2734
  _TRUNKHELLOMESSAGE._serialized_end=2788
  _TRUNKHEARTBEATMESSAGE._serialized_start=2790
  _TRUNKHEARTBEATMESSAGE._serialized_end=2861
  _TRUNKHANDOVERENTITY._serialized_start=2863
  _TRUNKHANDOVERENTITY._serialized_end=2953
  _TRUNKHANDOVERPREPAREMESSAGE._serialized_start=2956
  _TRUNKHANDOVERPREPAREMESSAGE._serialized_end=3118
  _TRUNKHANDOVERACKMESSAGE._serialized_start=3121
  _TRUNKHANDOVERACKMESSAGE._serialized_end=3264
  _TRUNKABORTNOTICEMESSAGE._serialized_start=3266
  _TRUNKABORTNOTICEMESSAGE._serialized_end=3339
  _TRUNKSTAGEREDIRECTMESSAGE._serialized_start=3341
  _TRUNKSTAGEREDIRECTMESSAGE._serialized_end=3460
  _TRUNKSTAGEACKMESSAGE._serialized_start=3462
  _TRUNKSTAGEACKMESSAGE._serialized_end=3531
  _TRUNKDIRECTORYUPDATEMESSAGE._serialized_start=3534
  _TRUNKDIRECTORYUPDATEMESSAGE._serialized_end=3746
  _TRUNKDIRECTORYUPDATEMESSAGE_CELLOVERRIDE._serialized_start=3694
  _TRUNKDIRECTORYUPDATEMESSAGE_CELLOVERRIDE._serialized_end=3746
  _TRUNKLOADREPORTMESSAGE._serialized_start=3749
  _TRUNKLOADREPORTMESSAGE._serialized_end=4056
  _TRUNKSHARDEPOCHMESSAGE._serialized_start=4059
  _TRUNKSHARDEPOCHMESSAGE._serialized_end=4897
  _TRUNKSHARDEPOCHMESSAGE_REPLICACELL._serialized_start=4425
  _TRUNKSHARDEPOCHMESSAGE_REPLICACELL._serialized_end=4512
  _TRUNKSHARDEPOCHMESSAGE_REPLICAHANDLE._serialized_start=4514
  _TRUNKSHARDEPOCHMESSAGE_REPLICAHANDLE._serialized_end=4580
  _TRUNKSHARDEPOCHMESSAGE_REPLICATXN._serialized_start=4583
  _TRUNKSHARDEPOCHMESSAGE_REPLICATXN._serialized_end=4716
  _TRUNKSHARDEPOCHMESSAGE_REPLICAAPPLIED._serialized_start=4718
  _TRUNKSHARDEPOCHMESSAGE_REPLICAAPPLIED._serialized_end=4790
  _TRUNKSHARDEPOCHMESSAGE_REPLICAQUERY._serialized_start=4792
  _TRUNKSHARDEPOCHMESSAGE_REPLICAQUERY._serialized_end=4897
  _TRUNKSHARDMIGRATEMESSAGE._serialized_start=4900
  _TRUNKSHARDMIGRATEMESSAGE._serialized_end=5053
  _TRUNKMIGRATESTATUSMESSAGE._serialized_start=5055
  _TRUNKMIGRATESTATUSMESSAGE._serialized_end=5174
  _TRUNKGATEWAYDEADMESSAGE._serialized_start=5177
  _TRUNKGATEWAYDEADMESSAGE._serialized_end=5331
  _TRUNKADOPTDONEMESSAGE._serialized_start=5334
  _TRUNKADOPTDONEMESSAGE._serialized_end=5504
  _TRUNKADOPTQUERYMESSAGE._serialized_start=5506
  _TRUNKADOPTQUERYMESSAGE._serialized_end=5609
  _TRUNKRESURRECTHELLOMESSAGE._serialized_start=5612
  _TRUNKRESURRECTHELLOMESSAGE._serialized_end=5822
  _TRUNKADOPTCLAIMSMESSAGE._serialized_start=5825
  _TRUNKADOPTCLAIMSMESSAGE._serialized_end=5992
# @@protoc_insertion_point(module_scope)
