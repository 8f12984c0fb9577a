# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: channeld_tpu/compat/unrealpb.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2
from google.protobuf import descriptor_pb2 as google_dot_protobuf_dot_descriptor__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\"channeld_tpu/compat/unrealpb.proto\x12\x08unrealpb\x1a\x19google/protobuf/any.proto\x1a google/protobuf/descriptor.proto\"K\n\x07\x46Vector\x12\x0e\n\x01x\x18\x01 \x01(\x02H\x00\x88\x01\x01\x12\x0e\n\x01y\x18\x02 \x01(\x02H\x01\x88\x01\x01\x12\x0e\n\x01z\x18\x03 \x01(\x02H\x02\x88\x01\x01\x42\x04\n\x02_xB\x04\n\x02_yB\x04\n\x02_z\"\xe4\x02\n\x0fUnrealObjectRef\x12\x14\n\x07netGUID\x18\x01 \x01(\rH\x00\x88\x01\x01\x12;\n\x07\x63ontext\x18\x02 \x03(\x0b\x32*.unrealpb.UnrealObjectRef.GuidCachedObject\x12\x19\n\x0cnetGUIDBunch\x18\x03 \x01(\x0cH\x01\x88\x01\x01\x12\x19\n\x0c\x62unchBitsNum\x18\x04 \x01(\rH\x02\x88\x01\x01\x12\x16\n\tclassPath\x18\x06 \x01(\tH\x03\x88\x01\x01\x12\x19\n\x0cowningConnId\x18\x07 \x01(\rH\x04\x88\x01\x01\x1aH\n\x10GuidCachedObject\x12\x0f\n\x07netGUID\x18\x01 \x01(\r\x12\x10\n\x08pathName\x18\x02 \x01(\t\x12\x11\n\touterGUID\x18\x03 \x01(\rB\n\n\x08_netGUIDB\x0f\n\r_netGUIDBunchB\x0f\n\r_bunchBitsNumB\x0c\n\n_classPathB\x0f\n\r_owningConnId\"p\n\x11\x41\x63torComponentRef\x12-\n\x05owner\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRefH\x00\x88\x01\x01\x12\x15\n\x08\x63ompName\x18\x02 \x01(\tH\x01\x88\x01\x01\x42\x08\n\x06_ownerB\x0b\n\t_compName\"\x1e\n\x08\x41ssetRef\x12\x12\n\nobjectPath\x18\x01 \x01(\t\"\xa5\x01\n\x15RemoteFunctionMessage\x12,\n\ttargetObj\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\x14\n\x0c\x66unctionName\x18\x02 \x01(\t\x12\x15\n\rparamsPayload\x18\x03 \x01(\x0c\x12\x1a\n\x12redirectionCounter\x18\x04 \x01(\x05\x12\x15\n\rsubObjectPath\x18\x05 \x01(\t\"\xbf\x01\n\x12SpawnObjectMessage\x12&\n\x03obj\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\x16\n\tchannelId\x18\x02 \x01(\rH\x00\x88\x01\x01\x12\x16\n\tlocalRole\x18\x03 \x01(\rH\x01\x88\x01\x01\x12(\n\x08location\x18\x05 \x01(\x0b\x32\x11.unrealpb.FVectorH\x02\x88\x01\x01\x42\x0c\n\n_channelIdB\x0c\n\n_localRoleB\x0b\n\t_location\"5\n\x14\x44\x65stroyObjectMessage\x12\r\n\x05netId\x18\x01 \x01(\r\x12\x0e\n\x06reason\x18\x02 \x01(\r\"e\n\x0fHandoverContext\x12&\n\x03obj\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\x19\n\x0c\x63lientConnId\x18\x02 \x01(\rH\x00\x88\x01\x01\x42\x0f\n\r_clientConnId\"z\n\x0cHandoverData\x12*\n\x07\x63ontext\x18\x01 \x03(\x0b\x32\x19.unrealpb.HandoverContext\x12.\n\x0b\x63hannelData\x18\x02 \x01(\x0b\x32\x14.google.protobuf.AnyH\x00\x88\x01\x01\x42\x0e\n\x0c_channelData\",\n\x19GetUnrealObjectRefMessage\x12\x0f\n\x07netGUID\x18\x01 \x03(\r\"L\n\x1fGetUnrealObjectRefResultMessage\x12)\n\x06objRef\x18\x01 \x03(\x0b\x32\x19.unrealpb.UnrealObjectRef\"\x9e\x01\n\x10SyncNetIdMessage\x12\x38\n\nnetIdPaths\x18\x01 \x03(\x0b\x32$.unrealpb.SyncNetIdMessage.NetIdPath\x1aP\n\tNetIdPath\x12\r\n\x05netId\x18\x01 \x01(\r\x12\x0c\n\x04path\x18\x02 \x01(\t\x12\x17\n\nouterNetId\x18\x03 \x01(\rH\x00\x88\x01\x01\x42\r\n\x0b_outerNetId\"\x8e\x01\n\x12SpatialEntityState\x12)\n\x06objRef\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\x0f\n\x07removed\x18\x02 \x01(\x08\x12-\n\nentityData\x18\x03 \x01(\x0b\x32\x14.google.protobuf.AnyH\x00\x88\x01\x01\x42\r\n\x0b_entityData\"\xa1\x01\n\x12SpatialChannelData\x12<\n\x08\x65ntities\x18\x01 \x03(\x0b\x32*.unrealpb.SpatialChannelData.EntitiesEntry\x1aM\n\rEntitiesEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12+\n\x05value\x18\x02 \x01(\x0b\x32\x1c.unrealpb.SpatialEntityState:\x02\x38\x01\"\x9d\x01\n\x13\x43hannelRecoveryData\x12;\n\x07objRefs\x18\x01 \x03(\x0b\x32*.unrealpb.ChannelRecoveryData.ObjRefsEntry\x1aI\n\x0cObjRefsEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef:\x02\x38\x01\"\x81\x05\n\nActorState\x12\x0f\n\x07removed\x18\x01 \x01(\x08\x12\x19\n\x0cowningConnId\x18\x02 \x01(\rH\x00\x88\x01\x01\x12\x1f\n\x12\x62ReplicateMovement\x18\x03 \x01(\x08H\x01\x88\x01\x01\x12\x16\n\tlocalRole\x18\x04 \x01(\rH\x02\x88\x01\x01\x12\x17\n\nremoteRole\x18\x05 \x01(\rH\x03\x88\x01\x01\x12-\n\x05owner\x18\x06 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRefH\x04\x88\x01\x01\x12\x14\n\x07\x62Hidden\x18\x07 \x01(\x08H\x05\x88\x01\x01\x12\x15\n\x08\x62TearOff\x18\x08 \x01(\x08H\x06\x88\x01\x01\x12\x1a\n\rbCanBeDamaged\x18\t \x01(\x08H\x07\x88\x01\x01\x12\x32\n\ninstigator\x18\n \x01(\x0b\x32\x19.unrealpb.UnrealObjectRefH\x08\x88\x01\x01\x12\x37\n\x12replicatedMovement\x18\x0b \x01(\x0b\x32\x16.unrealpb.FRepMovementH\t\x88\x01\x01\x12<\n\x15\x61ttachmentReplication\x18\x0c \x01(\x0b\x32\x18.unrealpb.FRepAttachmentH\n\x88\x01\x01:\x18\x8a\xb5\x18\x14/Script/Engine.ActorB\x0f\n\r_owningConnIdB\x15\n\x13_bReplicateMovementB\x0c\n\n_localRoleB\r\n\x0b_remoteRoleB\x08\n\x06_ownerB\n\n\x08_bHiddenB\x0b\n\t_bTearOffB\x10\n\x0e_bCanBeDamagedB\r\n\x0b_instigatorB\x15\n\x13_replicatedMovementB\x18\n\x16_attachmentReplication\"\xec\x02\n\x0c\x46RepMovement\x12.\n\x0elinearVelocity\x18\x01 \x01(\x0b\x32\x11.unrealpb.FVectorH\x00\x88\x01\x01\x12/\n\x0f\x61ngularVelocity\x18\x02 \x01(\x0b\x32\x11.unrealpb.FVectorH\x01\x88\x01\x01\x12(\n\x08location\x18\x03 \x01(\x0b\x32\x11.unrealpb.FVectorH\x02\x88\x01\x01\x12(\n\x08rotation\x18\x04 \x01(\x0b\x32\x11.unrealpb.FVectorH\x03\x88\x01\x01\x12\"\n\x15\x62SimulatedPhysicSleep\x18\x05 \x01(\x08H\x04\x88\x01\x01\x12\x18\n\x0b\x62RepPhysics\x18\x06 \x01(\x08H\x05\x88\x01\x01\x42\x11\n\x0f_linearVelocityB\x12\n\x10_angularVelocityB\x0b\n\t_locationB\x0b\n\t_rotationB\x18\n\x16_bSimulatedPhysicSleepB\x0e\n\x0c_bRepPhysics\"\x99\x03\n\x0e\x46RepAttachment\x12\x34\n\x0c\x61ttachParent\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRefH\x00\x88\x01\x01\x12.\n\x0elocationOffset\x18\x02 \x01(\x0b\x32\x11.unrealpb.FVectorH\x01\x88\x01\x01\x12-\n\rrelativeScale\x18\x03 \x01(\x0b\x32\x11.unrealpb.FVectorH\x02\x88\x01\x01\x12.\n\x0erotationOffset\x18\x04 \x01(\x0b\x32\x11.unrealpb.FVectorH\x03\x88\x01\x01\x12\x19\n\x0c\x61ttachSocket\x18\x05 \x01(\tH\x04\x88\x01\x01\x12\x39\n\x0f\x61ttachComponent\x18\x06 \x01(\x0b\x32\x1b.unrealpb.ActorComponentRefH\x05\x88\x01\x01\x42\x0f\n\r_attachParentB\x11\n\x0f_locationOffsetB\x10\n\x0e_relativeScaleB\x11\n\x0f_rotationOffsetB\x0f\n\r_attachSocketB\x12\n\x10_attachComponent\"\xbd\x01\n\x13\x41\x63torComponentState\x12\x0f\n\x07removed\x18\x01 \x01(\x08\x12\x16\n\tbIsActive\x18\x02 \x01(\x08H\x00\x88\x01\x01\x12\x18\n\x0b\x62Replicated\x18\x03 \x01(\x08H\x01\x88\x01\x01\x12\x15\n\x08\x63ompName\x18\x04 \x01(\tH\x02\x88\x01\x01:!\x8a\xb5\x18\x1d/Script/Engine.ActorComponentB\x0c\n\n_bIsActiveB\x0e\n\x0c_bReplicatedB\x0b\n\t_compName\"\xa0\x01\n\x14\x41\x63torComponentStates\x12:\n\x06states\x18\x01 \x03(\x0b\x32*.unrealpb.ActorComponentStates.StatesEntry\x1aL\n\x0bStatesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12,\n\x05value\x18\x02 \x01(\x0b\x32\x1d.unrealpb.ActorComponentState:\x02\x38\x01\"\xe4\x06\n\x13SceneComponentState\x12\x0f\n\x07removed\x18\x01 \x01(\x08\x12\x1e\n\x11\x62\x41\x62soluteLocation\x18\x02 \x01(\x08H\x00\x88\x01\x01\x12\x1e\n\x11\x62\x41\x62soluteRotation\x18\x03 \x01(\x08H\x01\x88\x01\x01\x12\x1b\n\x0e\x62\x41\x62soluteScale\x18\x04 \x01(\x08H\x02\x88\x01\x01\x12\x15\n\x08\x62Visible\x18\x05 \x01(\x08H\x03\x88\x01\x01\x12\x1e\n\x11\x62ShouldBeAttached\x18\x06 \x01(\x08H\x04\x88\x01\x01\x12,\n\x1f\x62ShouldSnapLocationWhenAttached\x18\x07 \x01(\x08H\x05\x88\x01\x01\x12,\n\x1f\x62ShouldSnapRotationWhenAttached\x18\x08 \x01(\x08H\x06\x88\x01\x01\x12\x36\n\x0c\x61ttachParent\x18\t \x01(\x0b\x32\x1b.unrealpb.ActorComponentRefH\x07\x88\x01\x01\x12\x33\n\x0e\x61ttachChildren\x18\n \x03(\x0b\x32\x1b.unrealpb.ActorComponentRef\x12\x1d\n\x10\x61ttachSocketName\x18\x0b \x01(\tH\x08\x88\x01\x01\x12\x30\n\x10relativeLocation\x18\x0c \x01(\x0b\x32\x11.unrealpb.FVectorH\t\x88\x01\x01\x12\x30\n\x10relativeRotation\x18\r \x01(\x0b\x32\x11.unrealpb.FVectorH\n\x88\x01\x01\x12-\n\rrelativeScale\x18\x0e \x01(\x0b\x32\x11.unrealpb.FVectorH\x0b\x88\x01\x01:!\x8a\xb5\x18\x1d/Script/Engine.SceneComponentB\x14\n\x12_bAbsoluteLocationB\x14\n\x12_bAbsoluteRotationB\x11\n\x0f_bAbsoluteScaleB\x0b\n\t_bVisibleB\x14\n\x12_bShouldBeAttachedB\"\n _bShouldSnapLocationWhenAttachedB\"\n _bShouldSnapRotationWhenAttachedB\x0f\n\r_attachParentB\x13\n\x11_attachSocketNameB\x13\n\x11_relativeLocationB\x13\n\x11_relativeRotationB\x10\n\x0e_relativeScale\"\x9f\x03\n\x12\x46\x42\x61sedMovementInfo\x12\x36\n\x0cmovementBase\x18\x01 \x01(\x0b\x32\x1b.unrealpb.ActorComponentRefH\x00\x88\x01\x01\x12\x15\n\x08\x62oneName\x18\x02 \x01(\tH\x01\x88\x01\x01\x12(\n\x08location\x18\x03 \x01(\x0b\x32\x11.unrealpb.FVectorH\x02\x88\x01\x01\x12(\n\x08rotation\x18\x04 \x01(\x0b\x32\x11.unrealpb.FVectorH\x03\x88\x01\x01\x12$\n\x17\x62ServerHasBaseComponent\x18\x05 \x01(\x08H\x04\x88\x01\x01\x12\x1e\n\x11\x62RelativeRotation\x18\x06 \x01(\x08H\x05\x88\x01\x01\x12\x1f\n\x12\x62ServerHasVelocity\x18\x07 \x01(\x08H\x06\x88\x01\x01\x42\x0f\n\r_movementBaseB\x0b\n\t_boneNameB\x0b\n\t_locationB\x0b\n\t_rotationB\x1a\n\x18_bServerHasBaseComponentB\x14\n\x12_bRelativeRotationB\x15\n\x13_bServerHasVelocity\"\xcf\x07\n\x11\x46RootMotionSource\x12\x15\n\x08priority\x18\x01 \x01(\rH\x00\x88\x01\x01\x12\x14\n\x07localId\x18\x02 \x01(\rH\x01\x88\x01\x01\x12\x1c\n\x0f\x61\x63\x63umulatedMode\x18\x03 \x01(\rH\x02\x88\x01\x01\x12\x19\n\x0cinstanceName\x18\x04 \x01(\tH\x03\x88\x01\x01\x12\x16\n\tstartTime\x18\x05 \x01(\x02H\x04\x88\x01\x01\x12\x18\n\x0b\x63urrentTime\x18\x06 \x01(\x02H\x05\x88\x01\x01\x12\x19\n\x0cpreviousTime\x18\x07 \x01(\x02H\x06\x88\x01\x01\x12\x15\n\x08\x64uration\x18\x08 \x01(\x02H\x07\x88\x01\x01\x12\x13\n\x06status\x18\t \x01(\rH\x08\x88\x01\x01\x12\x15\n\x08settings\x18\n \x01(\rH\t\x88\x01\x01\x12\x1a\n\rbInLocalSpace\x18\x0b \x01(\x08H\n\x88\x01\x01\x12#\n\x16\x62NeedsSimulatedCatchup\x18\x0c \x01(\x08H\x0b\x88\x01\x01\x12%\n\x18\x62SimulatedNeedsSmoothing\x18\r \x01(\x08H\x0c\x88\x01\x01\x12\x1b\n\x0e\x62HasRootMotion\x18\x0e \x01(\x08H\r\x88\x01\x01\x12\x18\n\x0b\x62lendWeight\x18\x0f \x01(\x02H\x0e\x88\x01\x01\x12`\n\x14\x66inishVelocityParams\x18\x10 \x01(\x0b\x32=.unrealpb.FRootMotionSource.FRootMotionFinishVelocitySettingsH\x0f\x88\x01\x01\x1a\xaa\x01\n!FRootMotionFinishVelocitySettings\x12\x11\n\x04mode\x18\x01 \x01(\rH\x00\x88\x01\x01\x12+\n\x0bsetVelocity\x18\x02 \x01(\x0b\x32\x11.unrealpb.FVectorH\x01\x88\x01\x01\x12\x1a\n\rclampVelocity\x18\x03 \x01(\x02H\x02\x88\x01\x01\x42\x07\n\x05_modeB\x0e\n\x0c_setVelocityB\x10\n\x0e_clampVelocityB\x0b\n\t_priorityB\n\n\x08_localIdB\x12\n\x10_accumulatedModeB\x0f\n\r_instanceNameB\x0c\n\n_startTimeB\x0e\n\x0c_currentTimeB\x0f\n\r_previousTimeB\x0b\n\t_durationB\t\n\x07_statusB\x0b\n\t_settingsB\x10\n\x0e_bInLocalSpaceB\x19\n\x17_bNeedsSimulatedCatchupB\x1b\n\x19_bSimulatedNeedsSmoothingB\x11\n\x0f_bHasRootMotionB\x0e\n\x0c_blendWeightB\x17\n\x15_finishVelocityParams\"\xc9\x04\n\x16\x46RootMotionSourceGroup\x12\x36\n\x11rootMotionSources\x18\x01 \x03(\x0b\x32\x1b.unrealpb.FRootMotionSource\x12@\n\x1bpendingAddRootMotionSources\x18\x02 \x03(\x0b\x32\x1b.unrealpb.FRootMotionSource\x12 \n\x13\x62HasAdditiveSources\x18\x03 \x01(\x08H\x00\x88\x01\x01\x12 \n\x13\x62HasOverrideSources\x18\x04 \x01(\x08H\x01\x88\x01\x01\x12\x35\n(bHasOverrideSourcesWithIgnoreZAccumulate\x18\x05 \x01(\x08H\x02\x88\x01\x01\x12\'\n\x1a\x62IsAdditiveVelocityApplied\x18\x06 \x01(\x08H\x03\x88\x01\x01\x12$\n\x17lastAccumulatedSettings\x18\x07 \x01(\rH\x04\x88\x01\x01\x12\x37\n\x17lastPreAdditiveVelocity\x18\x08 \x01(\x0b\x32\x11.unrealpb.FVectorH\x05\x88\x01\x01\x42\x16\n\x14_bHasAdditiveSourcesB\x16\n\x14_bHasOverrideSourcesB+\n)_bHasOverrideSourcesWithIgnoreZAccumulateB\x1d\n\x1b_bIsAdditiveVelocityAppliedB\x1a\n\x18_lastAccumulatedSettingsB\x1a\n\x18_lastPreAdditiveVelocity\"\xeb\x05\n\x15\x46RepRootMotionMontage\x12\x16\n\tbIsActive\x18\x01 \x01(\x08H\x00\x88\x01\x01\x12\x33\n\x0b\x61nimMontage\x18\x02 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRefH\x01\x88\x01\x01\x12\x15\n\x08position\x18\x03 \x01(\x02H\x02\x88\x01\x01\x12(\n\x08location\x18\x04 \x01(\x0b\x32\x11.unrealpb.FVectorH\x03\x88\x01\x01\x12(\n\x08rotation\x18\x05 \x01(\x0b\x32\x11.unrealpb.FVectorH\x04\x88\x01\x01\x12\x36\n\x0cmovementBase\x18\x06 \x01(\x0b\x32\x1b.unrealpb.ActorComponentRefH\x05\x88\x01\x01\x12!\n\x14movementBaseBoneName\x18\x07 \x01(\tH\x06\x88\x01\x01\x12\x1e\n\x11\x62RelativePosition\x18\x08 \x01(\x08H\x07\x88\x01\x01\x12\x1e\n\x11\x62RelativeRotation\x18\t \x01(\x08H\x08\x88\x01\x01\x12\x46\n\x17\x61uthoritativeRootMotion\x18\n \x01(\x0b\x32 .unrealpb.FRootMotionSourceGroupH\t\x88\x01\x01\x12,\n\x0c\x61\x63\x63\x65leration\x18\x0b \x01(\x0b\x32\x11.unrealpb.FVectorH\n\x88\x01\x01\x12.\n\x0elinearVelocity\x18\x0c \x01(\x0b\x32\x11.unrealpb.FVectorH\x0b\x88\x01\x01\x42\x0c\n\n_bIsActiveB\x0e\n\x0c_animMontageB\x0b\n\t_positionB\x0b\n\t_locationB\x0b\n\t_rotationB\x0f\n\r_movementBaseB\x17\n\x15_movementBaseBoneNameB\x14\n\x12_bRelativePositionB\x14\n\x12_bRelativeRotationB\x1a\n\x18_authoritativeRootMotionB\x0f\n\r_accelerationB\x11\n\x0f_linearVelocity\"\xdd\x04\n\x0e\x43haracterState\x12\x38\n\nrootMotion\x18\x02 \x01(\x0b\x32\x1f.unrealpb.FRepRootMotionMontageH\x00\x88\x01\x01\x12\x38\n\rbasedMovement\x18\x03 \x01(\x0b\x32\x1c.unrealpb.FBasedMovementInfoH\x01\x88\x01\x01\x12/\n\"serverLastTransformUpdateTimeStamp\x18\x04 \x01(\x02H\x02\x88\x01\x01\x12\x19\n\x0cmovementMode\x18\x05 \x01(\rH\x03\x88\x01\x01\x12\x18\n\x0b\x62IsCrouched\x18\x06 \x01(\x08H\x04\x88\x01\x01\x12%\n\x18\x62ProxyIsJumpForceApplied\x18\x07 \x01(\x08H\x05\x88\x01\x01\x12+\n\x1e\x61nimRootMotionTranslationScale\x18\x08 \x01(\x02H\x06\x88\x01\x01\x12/\n\"replayLastTransformUpdateTimeStamp\x18\t \x01(\x02H\x07\x88\x01\x01:\x1c\x8a\xb5\x18\x18/Script/Engine.CharacterB\r\n\x0b_rootMotionB\x10\n\x0e_basedMovementB%\n#_serverLastTransformUpdateTimeStampB\x0f\n\r_movementModeB\x0e\n\x0c_bIsCrouchedB\x1b\n\x19_bProxyIsJumpForceAppliedB!\n\x1f_animRootMotionTranslationScaleB%\n#_replayLastTransformUpdateTimeStamp\"H\n!Character_ServerMovePacked_Params\x12\x0f\n\x07\x62itsNum\x18\x01 \x01(\r\x12\x12\n\npackedBits\x18\x02 \x01(\x0c\"P\n)Character_ClientMoveResponsePacked_Params\x12\x0f\n\x07\x62itsNum\x18\x01 \x01(\r\x12\x12\n\npackedBits\x18\x02 \x01(\x0c\"\x93\x01\n\x0bPlayerState\x12\x12\n\x05score\x18\x02 \x01(\x02H\x00\x88\x01\x01\x12\x15\n\x08playerId\x18\x03 \x01(\x05H\x01\x88\x01\x01\x12\x11\n\x04ping\x18\x04 \x01(\rH\x02\x88\x01\x01\x12\x17\n\nplayerName\x18\x05 \x01(\tH\x03\x88\x01\x01\x42\x08\n\x06_scoreB\x0b\n\t_playerIdB\x07\n\x05_pingB\r\n\x0b_playerName\"\x89\x01\n\x0f\x43ontrollerState\x12.\n\x0bplayerState\x18\x02 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\'\n\x04pawn\x18\x03 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef:\x1d\x8a\xb5\x18\x19/Script/Engine.Controller\"u\n#Controller_ClientSetLocation_Params\x12&\n\x0bnewLocation\x18\x01 \x01(\x0b\x32\x11.unrealpb.FVector\x12&\n\x0bnewRotation\x18\x02 \x01(\x0b\x32\x11.unrealpb.FVector\"c\n#Controller_ClientSetRotation_Params\x12&\n\x0bnewRotation\x18\x01 \x01(\x0b\x32\x11.unrealpb.FVector\x12\x14\n\x0c\x62ResetCamera\x18\x02 \x01(\x08\"\xc8\x01\n\x15PlayerControllerState\x12\x32\n\x12targetViewRotation\x18\x02 \x01(\x0b\x32\x11.unrealpb.FVectorH\x00\x88\x01\x01\x12-\n\rspawnLocation\x18\x03 \x01(\x0b\x32\x11.unrealpb.FVectorH\x01\x88\x01\x01:#\x8a\xb5\x18\x1f/Script/Engine.PlayerControllerB\x15\n\x13_targetViewRotationB\x10\n\x0e_spawnLocation\"g\n*PlayerController_ServerUpdateCamera_Params\x12!\n\x06\x63\x61mLoc\x18\x01 \x01(\x0b\x32\x11.unrealpb.FVector\x12\x16\n\x0e\x63\x61mPitchAndYaw\x18\x02 \x01(\x05\"R\n$PlayerController_ClientSetHUD_Params\x12\x19\n\x0chudClassName\x18\x01 \x01(\tH\x00\x88\x01\x01\x42\x0f\n\r_hudClassName\"\xaa\x01\n+PlayerController_ClientSetViewTarget_Params\x12(\n\x05\x61\x63tor\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\x11\n\tblendTime\x18\x02 \x01(\x02\x12\x15\n\rblendFunction\x18\x03 \x01(\r\x12\x10\n\x08\x62lendExp\x18\x04 \x01(\x02\x12\x15\n\rbLockOutgoing\x18\x05 \x01(\x08\"T\n0PlayerController_ClientEnableNetworkVoice_Params\x12\x14\n\x07\x62\x45nable\x18\x01 \x01(\x08H\x00\x88\x01\x01\x42\n\n\x08_bEnable\"9\n*PlayerController_ClientCapBandwidth_Params\x12\x0b\n\x03\x63\x61p\x18\x01 \x01(\x05\"P\n%PlayerController_ClientRestart_Params\x12\'\n\x04pawn\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\"A\n+PlayerController_ClientSetCameraMode_Params\x12\x12\n\nnewCamMode\x18\x01 \x01(\t\"[\n0PlayerController_ClientRetryClientRestart_Params\x12\'\n\x04pawn\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\"z\n2PlayerController_ServerSetSpectatorLocation_Params\x12!\n\x06newLoc\x18\x01 \x01(\x0b\x32\x11.unrealpb.FVector\x12!\n\x06newRot\x18\x02 \x01(\x0b\x32\x11.unrealpb.FVector\"^\n3PlayerController_ServerAcknowledgePossession_Params\x12\'\n\x04pawn\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\";\n\'PlayerController_ClientGotoState_Params\x12\x10\n\x08newState\x18\x01 \x01(\t\"\xfd\x01\n5PlayerController_ClientReceiveLocalizedMessage_Params\x12\x0f\n\x07message\x18\x01 \x01(\t\x12\x0e\n\x06switch\x18\x02 \x01(\x05\x12\x37\n\x14relatedPlayerState_1\x18\x03 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\x37\n\x14relatedPlayerState_2\x18\x04 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\x31\n\x0eoptionalObject\x18\x05 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\"\xa9\x02\n\rGameStateBase\x12\x1f\n\x12spectatorClassName\x18\x02 \x01(\tH\x00\x88\x01\x01\x12\x1e\n\x11gameModeClassName\x18\x03 \x01(\tH\x01\x88\x01\x01\x12\'\n\x1areplicatedWorldTimeSeconds\x18\x04 \x01(\x01H\x02\x88\x01\x01\x12$\n\x17\x62ReplicatedHasBegunPlay\x18\x05 \x01(\x08H\x03\x88\x01\x01: \x8a\xb5\x18\x1c/Script/Engine.GameStateBaseB\x15\n\x13_spectatorClassNameB\x14\n\x12_gameModeClassNameB\x1d\n\x1b_replicatedWorldTimeSecondsB\x1a\n\x18_bReplicatedHasBegunPlay\"\xb5\x01\n\tPawnState\x12.\n\x0bplayerState\x18\x01 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12-\n\ncontroller\x18\x02 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRef\x12\x1c\n\x0fremoteViewPitch\x18\x03 \x01(\rH\x00\x88\x01\x01:\x17\x8a\xb5\x18\x13/Script/Engine.PawnB\x12\n\x10_remoteViewPitch\"\x8c\x05\n\x11\x46\x43lientAdjustment\x12\x19\n\x0c\x62\x41\x63kGoodMove\x18\x01 \x01(\x08H\x00\x88\x01\x01\x12\x16\n\ttimeStamp\x18\x02 \x01(\x02H\x01\x88\x01\x01\x12&\n\x06newLoc\x18\x03 \x01(\x0b\x32\x11.unrealpb.FVectorH\x02\x88\x01\x01\x12&\n\x06newVel\x18\x04 \x01(\x0b\x32\x11.unrealpb.FVectorH\x03\x88\x01\x01\x12&\n\x06newRot\x18\x05 \x01(\x0b\x32\x11.unrealpb.FVectorH\x04\x88\x01\x01\x12/\n\x07newBase\x18\x06 \x01(\x0b\x32\x19.unrealpb.UnrealObjectRefH\x05\x88\x01\x01\x12\x1c\n\x0fnewBaseBoneName\x18\x07 \x01(\tH\x06\x88\x01\x01\x12\"\n\x15\x62\x42\x61seRelativePosition\x18\x08 \x01(\x08H\x07\x88\x01\x01\x12I\n\x1arootMotionSourceCorrection\x18\t \x01(\x0b\x32 .unrealpb.FRootMotionSourceGroupH\x08\x88\x01\x01\x12\x32\n\x12rootMotionRotation\x18\n \x01(\x0b\x32\x11.unrealpb.FVectorH\t\x88\x01\x01\x12\x19\n\x0cmovementMode\x18\x0b \x01(\rH\n\x88\x01\x01\x42\x0f\n\r_bAckGoodMoveB\x0c\n\n_timeStampB\t\n\x07_newLocB\t\n\x07_newVelB\t\n\x07_newRotB\n\n\x08_newBaseB\x12\n\x10_newBaseBoneNameB\x18\n\x16_bBaseRelativePositionB\x1d\n\x1b_rootMotionSourceCorrectionB\x15\n\x13_rootMotionRotationB\x0f\n\r_movementMode\"{\n\x18StaticMeshComponentState\x12\x0f\n\x07removed\x18\x01 \x01(\x08\x12&\n\nstaticMesh\x18\x02 \x01(\x0b\x32\x12.unrealpb.AssetRef:&\x8a\xb5\x18\"/Script/Engine.StaticMeshComponent*\x9a\x01\n\x0bMessageType\x12\x0b\n\x07INVALID\x10\x00\x12\r\n\tLOW_LEVEL\x10\x64\x12\x07\n\x03\x41NY\x10\x65\x12\x07\n\x03RPC\x10\x66\x12\t\n\x05SPAWN\x10g\x12\x0b\n\x07\x44\x45STROY\x10h\x12\x0f\n\x0bSYNC_NET_ID\x10k\x12\x1a\n\x15SERVER_PLAYER_SPAWNED\x10\xc9\x01\x12\x18\n\x13SERVER_PLAYER_LEAVE\x10\xca\x01*\xa9\x01\n\x10UnrealObjectType\x12\x0f\n\x0bUOT_Unknown\x10\x00\x12\x11\n\rUOT_GameState\x10\x01\x12\r\n\tUOT_Actor\x10\x02\x12\x0c\n\x08UOT_Pawn\x10\x03\x12\x11\n\rUOT_Character\x10\x04\x12\x13\n\x0fUOT_PlayerState\x10\x05\x12\x12\n\x0eUOT_Controller\x10\x06\x12\x18\n\x14UOT_PlayerController\x10\x07:?\n\x11unreal_class_path\x12\x1f.google.protobuf.MessageOptions\x18\xd1\x86\x03 \x01(\t\x88\x01\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'channeld_tpu_torch.compat.unrealpb_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:
  google_dot_protobuf_dot_descriptor__pb2.MessageOptions.RegisterExtension(unreal_class_path)

  DESCRIPTOR._options = None
  _SPATIALCHANNELDATA_ENTITIESENTRY._options = None
  _SPATIALCHANNELDATA_ENTITIESENTRY._serialized_options = b'8\001'
  _CHANNELRECOVERYDATA_OBJREFSENTRY._options = None
  _CHANNELRECOVERYDATA_OBJREFSENTRY._serialized_options = b'8\001'
  _ACTORSTATE._options = None
  _ACTORSTATE._serialized_options = b'\212\265\030\024/Script/Engine.Actor'
  _ACTORCOMPONENTSTATE._options = None
  _ACTORCOMPONENTSTATE._serialized_options = b'\212\265\030\035/Script/Engine.ActorComponent'
  _ACTORCOMPONENTSTATES_STATESENTRY._options = None
  _ACTORCOMPONENTSTATES_STATESENTRY._serialized_options = b'8\001'
  _SCENECOMPONENTSTATE._options = None
  _SCENECOMPONENTSTATE._serialized_options = b'\212\265\030\035/Script/Engine.SceneComponent'
  _CHARACTERSTATE._options = None
  _CHARACTERSTATE._serialized_options = b'\212\265\030\030/Script/Engine.Character'
  _CONTROLLERSTATE._options = None
  _CONTROLLERSTATE._serialized_options = b'\212\265\030\031/Script/Engine.Controller'
  _PLAYERCONTROLLERSTATE._options = None
  _PLAYERCONTROLLERSTATE._serialized_options = b'\212\265\030\037/Script/Engine.PlayerController'
  _GAMESTATEBASE._options = None
  _GAMESTATEBASE._serialized_options = b'\212\265\030\034/Script/Engine.GameStateBase'
  _PAWNSTATE._options = None
  _PAWNSTATE._serialized_options = b'\212\265\030\023/Script/Engine.Pawn'
  _STATICMESHCOMPONENTSTATE._options = None
  _STATICMESHCOMPONENTSTATE._serialized_options = b'\212\265\030\"/Script/Engine.StaticMeshComponent'
  _MESSAGETYPE._serialized_start=11500
  _MESSAGETYPE._serialized_end=11654
  _UNREALOBJECTTYPE._serialized_start=11657
  _UNREALOBJECTTYPE._serialized_end=11826
  _FVECTOR._serialized_start=109
  _FVECTOR._serialized_end=184
  _UNREALOBJECTREF._serialized_start=187
  _UNREALOBJECTREF._serialized_end=543
  _UNREALOBJECTREF_GUIDCACHEDOBJECT._serialized_start=394
  _UNREALOBJECTREF_GUIDCACHEDOBJECT._serialized_end=466
  _ACTORCOMPONENTREF._serialized_start=545
  _ACTORCOMPONENTREF._serialized_end=657
  _ASSETREF._serialized_start=659
  _ASSETREF._serialized_end=689
  _REMOTEFUNCTIONMESSAGE._serialized_start=692
  _REMOTEFUNCTIONMESSAGE._serialized_end=857
  _SPAWNOBJECTMESSAGE._serialized_start=860
  _SPAWNOBJECTMESSAGE._serialized_end=1051
  _DESTROYOBJECTMESSAGE._serialized_start=1053
  _DESTROYOBJECTMESSAGE._serialized_end=1106
  _HANDOVERCONTEXT._serialized_start=1108
  _HANDOVERCONTEXT._serialized_end=1209
  _HANDOVERDATA._serialized_start=1211
  _HANDOVERDATA._serialized_end=1333
  _GETUNREALOBJECTREFMESSAGE._serialized_start=1335
  _GETUNREALOBJECTREFMESSAGE._serialized_end=1379
  _GETUNREALOBJECTREFRESULTMESSAGE._serialized_start=1381
  _GETUNREALOBJECTREFRESULTMESSAGE._serialized_end=1457
  _SYNCNETIDMESSAGE._serialized_start=1460
  _SYNCNETIDMESSAGE._serialized_end=1618
  _SYNCNETIDMESSAGE_NETIDPATH._serialized_start=1538
  _SYNCNETIDMESSAGE_NETIDPATH._serialized_end=1618
  _SPATIALENTITYSTATE._serialized_start=1621
  _SPATIALENTITYSTATE._serialized_end=1763
  _SPATIALCHANNELDATA._serialized_start=1766
  _SPATIALCHANNELDATA._serialized_end=1927
  _SPATIALCHANNELDATA_ENTITIESENTRY._serialized_start=1850
  _SPATIALCHANNELDATA_ENTITIESENTRY._serialized_end=1927
  _CHANNELRECOVERYDATA._serialized_start=1930
  _CHANNELRECOVERYDATA._serialized_end=2087
  _CHANNELRECOVERYDATA_OBJREFSENTRY._serialized_start=2014
  _CHANNELRECOVERYDATA_OBJREFSENTRY._serialized_end=2087
  _ACTORSTATE._serialized_start=2090
  _ACTORSTATE._serialized_end=2731
  _FREPMOVEMENT._serialized_start=2734
  _FREPMOVEMENT._serialized_end=3098
  _FREPATTACHMENT._serialized_start=3101
  _FREPATTACHMENT._serialized_end=3510
  _ACTORCOMPONENTSTATE._serialized_start=3513
  _ACTORCOMPONENTSTATE._serialized_end=3702
  _ACTORCOMPONENTSTATES._serialized_start=3705
  _ACTORCOMPONENTSTATES._serialized_end=3865
  _ACTORCOMPONENTSTATES_STATESENTRY._serialized_start=3789
  _ACTORCOMPONENTSTATES_STATESENTRY._serialized_end=3865
  _SCENECOMPONENTSTATE._serialized_start=3868
  _SCENECOMPONENTSTATE._serialized_end=4736
  _FBASEDMOVEMENTINFO._serialized_start=4739
  _FBASEDMOVEMENTINFO._serialized_end=5154
  _FROOTMOTIONSOURCE._serialized_start=5157
  _FROOTMOTIONSOURCE._serialized_end=6132
  _FROOTMOTIONSOURCE_FROOTMOTIONFINISHVELOCITYSETTINGS._serialized_start=5682
  _FROOTMOTIONSOURCE_FROOTMOTIONFINISHVELOCITYSETTINGS._serialized_end=5852
  _FROOTMOTIONSOURCEGROUP._serialized_start=6135
  _FROOTMOTIONSOURCEGROUP._serialized_end=6720
  _FREPROOTMOTIONMONTAGE._serialized_start=6723
  _FREPROOTMOTIONMONTAGE._serialized_end=7470
  _CHARACTERSTATE._serialized_start=7473
  _CHARACTERSTATE._serialized_end=8078
  _CHARACTER_SERVERMOVEPACKED_PARAMS._serialized_start=8080
  _CHARACTER_SERVERMOVEPACKED_PARAMS._serialized_end=8152
  _CHARACTER_CLIENTMOVERESPONSEPACKED_PARAMS._serialized_start=8154
  _CHARACTER_CLIENTMOVERESPONSEPACKED_PARAMS._serialized_end=8234
  _PLAYERSTATE._serialized_start=8237
  _PLAYERSTATE._serialized_end=8384
  _CONTROLLERSTATE._serialized_start=8387
  _CONTROLLERSTATE._serialized_end=8524
  _CONTROLLER_CLIENTSETLOCATION_PARAMS._serialized_start=8526
  _CONTROLLER_CLIENTSETLOCATION_PARAMS._serialized_end=8643
  _CONTROLLER_CLIENTSETROTATION_PARAMS._serialized_start=8645
  _CONTROLLER_CLIENTSETROTATION_PARAMS._serialized_end=8744
  _PLAYERCONTROLLERSTATE._serialized_start=8747
  _PLAYERCONTROLLERSTATE._serialized_end=8947
  _PLAYERCONTROLLER_SERVERUPDATECAMERA_PARAMS._serialized_start=8949
  _PLAYERCONTROLLER_SERVERUPDATECAMERA_PARAMS._serialized_end=9052
  _PLAYERCONTROLLER_CLIENTSETHUD_PARAMS._serialized_start=9054
  _PLAYERCONTROLLER_CLIENTSETHUD_PARAMS._serialized_end=9136
  _PLAYERCONTROLLER_CLIENTSETVIEWTARGET_PARAMS._serialized_start=9139
  _PLAYERCONTROLLER_CLIENTSETVIEWTARGET_PARAMS._serialized_end=9309
  _PLAYERCONTROLLER_CLIENTENABLENETWORKVOICE_PARAMS._serialized_start=9311
  _PLAYERCONTROLLER_CLIENTENABLENETWORKVOICE_PARAMS._serialized_end=9395
  _PLAYERCONTROLLER_CLIENTCAPBANDWIDTH_PARAMS._serialized_start=9397
  _PLAYERCONTROLLER_CLIENTCAPBANDWIDTH_PARAMS._serialized_end=9454
  _PLAYERCONTROLLER_CLIENTRESTART_PARAMS._serialized_start=9456
  _PLAYERCONTROLLER_CLIENTRESTART_PARAMS._serialized_end=9536
  _PLAYERCONTROLLER_CLIENTSETCAMERAMODE_PARAMS._serialized_start=9538
  _PLAYERCONTROLLER_CLIENTSETCAMERAMODE_PARAMS._serialized_end=9603
  _PLAYERCONTROLLER_CLIENTRETRYCLIENTRESTART_PARAMS._serialized_start=9605
  _PLAYERCONTROLLER_CLIENTRETRYCLIENTRESTART_PARAMS._serialized_end=9696
  _PLAYERCONTROLLER_SERVERSETSPECTATORLOCATION_PARAMS._serialized_start=9698
  _PLAYERCONTROLLER_SERVERSETSPECTATORLOCATION_PARAMS._serialized_end=9820
  _PLAYERCONTROLLER_SERVERACKNOWLEDGEPOSSESSION_PARAMS._serialized_start=9822
  _PLAYERCONTROLLER_SERVERACKNOWLEDGEPOSSESSION_PARAMS._serialized_end=9916
  _PLAYERCONTROLLER_CLIENTGOTOSTATE_PARAMS._serialized_start=9918
  _PLAYERCONTROLLER_CLIENTGOTOSTATE_PARAMS._serialized_end=9977
  _PLAYERCONTROLLER_CLIENTRECEIVELOCALIZEDMESSAGE_PARAMS._serialized_start=9980
  _PLAYERCONTROLLER_CLIENTRECEIVELOCALIZEDMESSAGE_PARAMS._serialized_end=10233
  _GAMESTATEBASE._serialized_start=10236
  _GAMESTATEBASE._serialized_end=10533
  _PAWNSTATE._serialized_start=10536
  _PAWNSTATE._serialized_end=10717
  _FCLIENTADJUSTMENT._serialized_start=10720
  _FCLIENTADJUSTMENT._serialized_end=11372
  _STATICMESHCOMPONENTSTATE._serialized_start=11374
  _STATICMESHCOMPONENTSTATE._serialized_end=11497
# @@protoc_insertion_point(module_scope)
