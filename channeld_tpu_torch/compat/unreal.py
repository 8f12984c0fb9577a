"""unrealpb behavior layer: the hand-written extensions and user-space
handlers a UE-side channeld deployment relies on, over the wire-compatible
`compat/unrealpb.proto` types.

Capability parity targets:
- pkg/unrealpb/extension.go:10-94 — FVector.ToSpatialInfo (Z-up -> Y-up
  swap), HandoverData.ClearPayload, SpatialChannelData Init/Merge/
  AddEntity/RemoveEntity.
- pkg/unreal/message.go:12-196 — SPAWN (103) re-routes to the location's
  spatial channel and inserts the SpatialEntityState; DESTROY (104)
  removes the entity + its channel; both then forward server->clients.

Register with ``-imports channeld_tpu.compat.unreal`` (or call
``register_unreal_types()``): a gateway then speaks the UE SDK's wire
types out of the box.
"""

from __future__ import annotations

from ..core.channel import get_channel, remove_channel
from ..core.data import IncompatibleUpdateError
from ..core.message import (
    MessageContext,
    handle_server_to_client_user_message,
    register_message_handler,
)
from ..core.types import ChannelType
from ..protocol import wire_pb2
from ..spatial.controller import SpatialInfo, get_spatial_controller
from ..utils.logger import get_logger
from . import unrealpb_pb2 as unrealpb

logger = get_logger("compat.unreal")

MSG_SPAWN = 103    # unrealpb.MessageType.SPAWN
MSG_DESTROY = 104  # unrealpb.MessageType.DESTROY


def to_spatial_info(vec: unrealpb.FVector) -> SpatialInfo:
    """UE is Z-up, the spatial plane is Y-up: swap Y and Z
    (ref: extension.go:11-24)."""
    return SpatialInfo(
        vec.x if vec.HasField("x") else 0.0,
        vec.z if vec.HasField("z") else 0.0,
        vec.y if vec.HasField("y") else 0.0,
    )


# ---- SpatialChannelData seams (ref: extension.go:31-94) -------------------


def _spatial_merge(self, src, options, spatial_notifier) -> None:
    """removed -> drop the entry AND the entity channel; new entries are
    added only if absent (the reference never merges into an existing
    SpatialEntityState, extension.go:55-58)."""
    if not isinstance(src, unrealpb.SpatialChannelData):
        raise IncompatibleUpdateError("src is not an unrealpb.SpatialChannelData")
    for net_id, entity in src.entities.items():
        if entity.removed:
            self.entities.pop(net_id, None)
            if net_id == 0:
                continue  # never resolve GLOBAL from a defaulted key
            entity_ch = get_channel(net_id)
            if entity_ch is not None and not entity_ch.is_removing():
                logger.info(
                    "removing entity channel %d from SpatialChannelData merge",
                    net_id,
                )
                remove_channel(entity_ch)
        elif net_id not in self.entities:
            self.entities[net_id].CopyFrom(entity)


def _spatial_add_entity(self, entity_id: int, entity_data) -> None:
    """Accepts an entity channel data message exposing ``objRef`` (the
    EntityChannelDataWithObjRef duck type, extension.go:66-80), a bare
    UnrealObjectRef, or a SpatialEntityState."""
    state = self.entities[entity_id]
    if isinstance(entity_data, unrealpb.UnrealObjectRef):
        state.objRef.CopyFrom(entity_data)
    elif isinstance(entity_data, unrealpb.SpatialEntityState):
        state.CopyFrom(entity_data)
    else:
        obj_ref = getattr(entity_data, "objRef", None)
        if not isinstance(obj_ref, unrealpb.UnrealObjectRef):
            raise IncompatibleUpdateError(
                f"{type(entity_data).__name__} has no UnrealObjectRef objRef"
            )
        state.objRef.CopyFrom(obj_ref)
    if not state.objRef.HasField("netGUID"):
        state.objRef.netGUID = entity_id


def _spatial_remove_entity(self, entity_id: int) -> None:
    self.entities.pop(entity_id, None)


unrealpb.SpatialChannelData.merge = _spatial_merge
unrealpb.SpatialChannelData.add_entity = _spatial_add_entity
unrealpb.SpatialChannelData.remove_entity = _spatial_remove_entity


def _handover_clear_payload(self) -> None:
    """Identity context stays; bulk channel data goes
    (ref: extension.go:26-29)."""
    self.ClearField("channelData")


unrealpb.HandoverData.clear_payload = _handover_clear_payload


# ---- SPAWN / DESTROY handlers (ref: message.go:20-196) --------------------


def _add_spatial_entity(channel, obj: unrealpb.UnrealObjectRef) -> None:
    if channel.channel_type != ChannelType.SPATIAL:
        return
    data_msg = channel.get_data_message()
    if not isinstance(data_msg, unrealpb.SpatialChannelData):
        # Reference behavior: warn, don't silently drop — without the
        # entry, handover cannot see this entity (message.go:141-145).
        logger.warning(
            "channel %d data is %s, not unrealpb.SpatialChannelData; "
            "spawn of %d not recorded", channel.id,
            type(data_msg).__name__, obj.netGUID,
        )
        return
    data_msg.entities[obj.netGUID].objRef.CopyFrom(obj)


def _remove_spatial_entity(channel, net_id: int) -> None:
    if channel.channel_type != ChannelType.SPATIAL:
        return
    data_msg = channel.get_data_message()
    if isinstance(data_msg, unrealpb.SpatialChannelData):
        data_msg.entities.pop(net_id, None)
    else:
        logger.warning(
            "channel %d data is %s, not unrealpb.SpatialChannelData; "
            "destroy of %d not recorded", channel.id,
            type(data_msg).__name__, net_id,
        )


class UnrealRecoverableExtension:
    """Spawned-object refs shipped in ChannelDataRecoveryMessage's
    recovery data for GLOBAL/SUBWORLD worlds — a recovering client needs
    them to respawn existing actors (ref: pkg/unreal/recovery.go:10-40,
    unrealpb.ChannelRecoveryData)."""

    def __init__(self):
        self.obj_refs: dict[int, unrealpb.UnrealObjectRef] = {}

    def init(self, channel) -> None:
        self.obj_refs = {}

    def get_recovery_data_message(self):
        data = unrealpb.ChannelRecoveryData()
        for net_id, obj in self.obj_refs.items():
            data.objRefs[net_id].CopyFrom(obj)
        return data

    def on_spawn(self, obj: unrealpb.UnrealObjectRef) -> None:
        ref = unrealpb.UnrealObjectRef()
        ref.CopyFrom(obj)
        self.obj_refs[obj.netGUID] = ref

    def on_destroy(self, net_id: int) -> None:
        self.obj_refs.pop(net_id, None)


def _record_spawn(channel, obj: unrealpb.UnrealObjectRef) -> None:
    ext = channel.data.extension if channel.data else None
    if isinstance(ext, UnrealRecoverableExtension):
        ext.on_spawn(obj)


def _record_destroy(channel, net_id: int) -> None:
    ext = channel.data.extension if channel.data else None
    if isinstance(ext, UnrealRecoverableExtension):
        ext.on_destroy(net_id)


def handle_unreal_spawn_object(ctx: MessageContext) -> None:
    """(ref: message.go:20-128 handleUnrealSpawnObject)."""
    msg = ctx.msg
    if not isinstance(msg, wire_pb2.ServerForwardMessage):
        logger.error("SPAWN payload is not a ServerForwardMessage")
        return
    spawn = unrealpb.SpawnObjectMessage()
    try:
        spawn.ParseFromString(msg.payload)
    except Exception:
        logger.exception("failed to unmarshal unrealpb.SpawnObjectMessage")
        return
    if not spawn.HasField("obj") or spawn.obj.netGUID == 0:
        logger.error("invalid NetGUID in SpawnObjectMessage")
        return

    controller = get_spatial_controller()
    if spawn.HasField("location") and controller is not None:
        try:
            spatial_ch_id = controller.get_channel_id(
                to_spatial_info(spawn.location)
            )
        except ValueError as e:
            logger.warning("failed to map spawn location: %s", e)
            return
        old_ch_id = spawn.channelId
        spawn.channelId = spatial_ch_id
        if spatial_ch_id != old_ch_id:
            # Re-route so the owning spatial channel applies the insert in
            # its own execution context (message.go:69-79).
            ctx.msg = wire_pb2.ServerForwardMessage(
                clientConnId=msg.clientConnId,
                payload=spawn.SerializeToString(),
            )
            target = get_channel(spatial_ch_id)
            if target is None:
                logger.error("spawn target channel %d missing", spatial_ch_id)
                return
            ctx.channel = target
            ctx.channel_id = spatial_ch_id
            target.execute(lambda ch: _add_spatial_entity(ch, spawn.obj))
            target.put_message_context(ctx, handle_server_to_client_user_message)
        else:
            _add_spatial_entity(ctx.channel, spawn.obj)
            handle_server_to_client_user_message(ctx)
    else:
        if ctx.channel.channel_type in (ChannelType.GLOBAL,
                                        ChannelType.SUBWORLD):
            # Non-spatial worlds track spawns for connection recovery
            # (message.go:111-117 onSpawnObject -> recovery.go:26-33).
            _record_spawn(ctx.channel, spawn.obj)
        elif ctx.channel.channel_type == ChannelType.SPATIAL:
            _add_spatial_entity(ctx.channel, spawn.obj)
        handle_server_to_client_user_message(ctx)

    # The entity channel (id == netGUID) carries the objRef in its data.
    entity_channel = get_channel(spawn.obj.netGUID)
    if entity_channel is None:
        return

    def _set_ref(ch) -> None:
        data_msg = ch.get_data_message()
        obj_ref = getattr(data_msg, "objRef", None)
        if isinstance(obj_ref, unrealpb.UnrealObjectRef):
            obj_ref.CopyFrom(spawn.obj)

    entity_channel.execute(_set_ref)


def handle_unreal_destroy_object(ctx: MessageContext) -> None:
    """(ref: message.go:172-196 handleUnrealDestroyObject)."""
    msg = ctx.msg
    if not isinstance(msg, wire_pb2.ServerForwardMessage):
        return
    destroy = unrealpb.DestroyObjectMessage()
    try:
        destroy.ParseFromString(msg.payload)
    except Exception:
        logger.exception("failed to unmarshal unrealpb.DestroyObjectMessage")
        return
    if destroy.netId == 0:
        # A defaulted netId would resolve get_channel(0) = GLOBAL and
        # tear down the control plane (the reference shares this hazard;
        # guarded here like the spawn side's netGUID check).
        logger.error("invalid netId 0 in DestroyObjectMessage")
        return
    if ctx.channel.channel_type in (ChannelType.GLOBAL, ChannelType.SUBWORLD):
        _record_destroy(ctx.channel, destroy.netId)
    else:
        _remove_spatial_entity(ctx.channel, destroy.netId)
    handle_server_to_client_user_message(ctx)
    entity_ch = get_channel(destroy.netId)
    if entity_ch is not None and not entity_ch.is_removing():
        remove_channel(entity_ch)


def handle_entity_channel_spatially_owned(data) -> None:
    """An entity channel just became owned by a spatial server: insert it
    into that spatial channel's entity table or handover cannot see it
    (ref: message.go:205-215 handleEntityChannelSpatiallyOwned). The
    entity data's objRef rides in via the EntityChannelDataWithObjRef
    duck type (_spatial_add_entity)."""
    entity_data = data.entity_channel.get_data_message()
    entity_id = data.entity_channel.id

    def _add(ch) -> None:
        data_msg = ch.get_data_message()
        adder = getattr(data_msg, "add_entity", None)
        if adder is None:
            return
        try:
            adder(entity_id, entity_data)
        except IncompatibleUpdateError as e:
            logger.warning("spatially-owned entity %d not inserted: %s",
                           entity_id, e)

    data.spatial_channel.execute(_add)


def register_unreal_types() -> None:
    """Wire the unrealpb family into a gateway: SPATIAL channels hold
    unrealpb.SpatialChannelData, SPAWN/DESTROY get the UE semantics,
    GLOBAL/SUBWORLD track spawns for recovery, and spatially-owned
    entity channels land in the spatial entity table
    (ref: message.go:12-17 InitMessageHandlers)."""
    from ..core import events
    from ..core.data import (
        reflect_channel_data_message,
        register_channel_data_type,
        set_channel_data_extension,
    )

    register_channel_data_type(
        ChannelType.SPATIAL, unrealpb.SpatialChannelData()
    )
    # Explicit config wins (register_channel_data_type warn-skips
    # duplicates): if another SPATIAL type ended up registered, handlers
    # still install — the reference always registers them — but every
    # spawn will hit the per-occurrence warning in _add_spatial_entity,
    # so surface the mismatch once, loudly, at boot.
    registered = reflect_channel_data_message(ChannelType.SPATIAL)
    if registered is not None and not isinstance(
        registered, unrealpb.SpatialChannelData
    ):
        logger.warning(
            "SPATIAL data type is %s, not unrealpb.SpatialChannelData — "
            "UE spawns will NOT be recorded in spatial channel data "
            "(handover will miss them)",
            type(registered).__name__,
        )
    register_message_handler(
        MSG_SPAWN, wire_pb2.ServerForwardMessage, handle_unreal_spawn_object
    )
    register_message_handler(
        MSG_DESTROY, wire_pb2.ServerForwardMessage, handle_unreal_destroy_object
    )
    set_channel_data_extension(ChannelType.GLOBAL, UnrealRecoverableExtension)
    set_channel_data_extension(ChannelType.SUBWORLD, UnrealRecoverableExtension)
    events.entity_channel_spatially_owned.listen(
        handle_entity_channel_spatially_owned
    )


# -imports hook (core.channel.init_channels).
register_channel_data_types = register_unreal_types
