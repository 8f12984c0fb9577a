"""Engine integration adapter: spawn/destroy routing over the core.

Capability parity with the reference's engine-side package
(ref: pkg/unreal/message.go, handover.go, recovery.go) — the proof that
the core is engine-agnostic: everything here uses only public core APIs.

- SPAWN (user-space 103): rewrites the message's spatial channel from the
  object's location, inserts the entity into the spatial channel data,
  sets the entity channel's object ref, records the spawn for recovery,
  then forwards server->clients.
- DESTROY (user-space 104): removes the entity from the spatial data,
  removes its entity channel, forwards.
- check_entity_handover: the position-delta test feeding the spatial
  notifier (the reference swaps UE's Z-up to Y-up; the sim family is
  already Y-up so the swap is optional).
- RecoverableChannelDataExtension: spawned-object table shipped in
  ChannelDataRecoveryMessage.recoveryData.
"""

from __future__ import annotations

from typing import Optional

from ..core.channel import get_channel
from ..core.data import set_channel_data_extension
from ..core.message import (
    MessageContext,
    handle_server_to_client_user_message,
    register_message_handler,
)
from ..core.types import ChannelType, MessageType
from ..protocol import wire_pb2
from ..spatial.controller import SpatialInfo, get_spatial_controller
from ..utils.logger import get_logger
from . import sim_pb2

logger = get_logger("models.engine")

# User-space message types (ref: pkg/unrealpb/unreal_common.proto:25-29).
MSG_SPAWN = 103
MSG_DESTROY = 104


class RecoverableChannelDataExtension:
    """(ref: pkg/unreal/recovery.go:10-40)."""

    def __init__(self):
        self.spawned_objs: dict[int, sim_pb2.ObjectRef] = {}

    def init(self, channel) -> None:
        self.spawned_objs = {}

    def get_recovery_data_message(self):
        data = sim_pb2.EngineRecoveryData()
        for net_id, obj in self.spawned_objs.items():
            data.spawnedObjects[net_id].CopyFrom(obj)
        return data

    def on_spawn(self, obj: sim_pb2.ObjectRef) -> None:
        self.spawned_objs[obj.netId] = obj

    def on_destroy(self, net_id: int) -> None:
        self.spawned_objs.pop(net_id, None)


def init_message_handlers() -> None:
    """(ref: pkg/unreal/message.go:12-17)."""
    from ..core import events

    register_message_handler(
        MSG_SPAWN, wire_pb2.ServerForwardMessage, handle_spawn_object
    )
    register_message_handler(
        MSG_DESTROY, wire_pb2.ServerForwardMessage, handle_destroy_object
    )
    set_channel_data_extension(ChannelType.GLOBAL, RecoverableChannelDataExtension)
    set_channel_data_extension(ChannelType.SUBWORLD, RecoverableChannelDataExtension)
    events.entity_channel_spatially_owned.listen(
        handle_entity_channel_spatially_owned
    )


def handle_entity_channel_spatially_owned(data) -> None:
    """An entity channel just became owned by a spatial server: insert the
    entity into that spatial channel's entity table, or handover cannot
    see it (ref: pkg/unreal/message.go:205-215
    handleEntityChannelSpatiallyOwned)."""
    entity_data = data.entity_channel.get_data_message()
    if entity_data is None or not hasattr(entity_data, "state"):
        logger.error(
            "spatially-owned entity channel %d has no usable data",
            data.entity_channel.id,
        )
        return
    state = entity_data.state
    # The entity channel id IS the netId (channel.go:229-241); the data's
    # state.entityId may legitimately still be unset at this point (it is
    # filled by the SPAWN path).
    entity_id = data.entity_channel.id

    def _add(ch) -> None:
        data_msg = ch.get_data_message()
        adder = getattr(data_msg, "add_entity", None)
        if adder is not None:
            adder(entity_id, state)

    data.spatial_channel.execute(_add)


def _add_spatial_entity(channel, obj: sim_pb2.ObjectRef, location) -> None:
    """Insert the entity into the spatial channel data so handover can see
    it (ref: message.go addSpatialEntity)."""
    data_msg = channel.get_data_message()
    adder = getattr(data_msg, "add_entity", None)
    if adder is None:
        return
    state = sim_pb2.EntityState(entityId=obj.netId, owningConnId=obj.owningConnId)
    if location is not None:
        state.transform.position.CopyFrom(location)
    adder(obj.netId, state)


def _record_spawn(channel, obj: sim_pb2.ObjectRef) -> None:
    ext = channel.data.extension if channel.data else None
    if isinstance(ext, RecoverableChannelDataExtension):
        ext.on_spawn(obj)


def handle_spawn_object(ctx: MessageContext) -> None:
    """(ref: message.go:20-128)."""
    msg = ctx.msg
    if not isinstance(msg, wire_pb2.ServerForwardMessage):
        logger.error("SPAWN payload is not a ServerForwardMessage")
        return
    spawn = sim_pb2.SpawnObjectMessage()
    try:
        spawn.ParseFromString(msg.payload)
    except Exception:
        logger.exception("failed to unmarshal SpawnObjectMessage")
        return
    if not spawn.HasField("obj") or spawn.obj.netId == 0:
        logger.error("invalid ObjectRef in SpawnObjectMessage")
        return

    controller = get_spatial_controller()
    if spawn.HasField("location") and controller is not None:
        loc = spawn.location
        try:
            spatial_ch_id = controller.get_channel_id(SpatialInfo(loc.x, loc.y, loc.z))
        except ValueError as e:
            logger.warning("failed to map spawn location: %s", e)
            return
        old_ch_id = spawn.channelId
        spawn.channelId = spatial_ch_id
        if spatial_ch_id != old_ch_id:
            # Re-route to the correct spatial channel and let it handle the
            # forward inside its own execution context.
            ctx.msg = wire_pb2.ServerForwardMessage(
                clientConnId=msg.clientConnId, payload=spawn.SerializeToString()
            )
            target = get_channel(spatial_ch_id)
            if target is None:
                logger.error("spawn target channel %d missing", spatial_ch_id)
                return
            ctx.channel = target
            ctx.channel_id = spatial_ch_id
            target.execute(lambda ch: _add_spatial_entity(ch, spawn.obj, loc))
            target.put_message_context(ctx, handle_server_to_client_user_message)
        else:
            _add_spatial_entity(ctx.channel, spawn.obj, loc)
            handle_server_to_client_user_message(ctx)
    else:
        if ctx.channel.channel_type in (ChannelType.GLOBAL, ChannelType.SUBWORLD):
            _record_spawn(ctx.channel, spawn.obj)
        elif ctx.channel.channel_type == ChannelType.SPATIAL:
            _add_spatial_entity(
                ctx.channel, spawn.obj,
                spawn.location if spawn.HasField("location") else None,
            )
        handle_server_to_client_user_message(ctx)

    # Wire the object ref into the entity channel's data, if it exists.
    entity_channel = get_channel(spawn.obj.netId)
    if entity_channel is None:
        return

    def _set_ref(ch) -> None:
        data_msg = ch.get_data_message()
        if isinstance(data_msg, sim_pb2.SimEntityChannelData):
            data_msg.state.entityId = spawn.obj.netId
            data_msg.state.owningConnId = spawn.obj.owningConnId

    entity_channel.execute(_set_ref)


def handle_destroy_object(ctx: MessageContext) -> None:
    """(ref: message.go:165-196)."""
    from ..core.channel import remove_channel

    msg = ctx.msg
    if not isinstance(msg, wire_pb2.ServerForwardMessage):
        return
    destroy = sim_pb2.DestroyObjectMessage()
    try:
        destroy.ParseFromString(msg.payload)
    except Exception:
        logger.exception("failed to unmarshal DestroyObjectMessage")
        return

    data_msg = ctx.channel.get_data_message()
    remover = getattr(data_msg, "remove_entity", None)
    if remover is not None:
        remover(destroy.netId)
    ext = ctx.channel.data.extension if ctx.channel.data else None
    if isinstance(ext, RecoverableChannelDataExtension):
        ext.on_destroy(destroy.netId)

    entity_channel = get_channel(destroy.netId)
    if entity_channel is not None and not entity_channel.is_removing():
        remove_channel(entity_channel)

    handle_server_to_client_user_message(ctx)


def check_entity_handover(
    net_id: int, new_loc, old_loc, swap_yz: bool = False
) -> tuple[bool, Optional[SpatialInfo], Optional[SpatialInfo]]:
    """Position-delta handover test (ref: pkg/unreal/handover.go:8-47).

    Axis-presence aware when the locations are sim ``Vec3`` protos: an
    absent axis in ``new_loc`` falls back to the OLD value (the engine
    replicated only the axes that changed — exactly the reference's
    ``newLoc.X != nil`` ladder). ``swap_yz=True`` applies the UE Z-up ->
    Y-up axis swap.
    """
    def axis(loc, name, fallback):
        has_field = getattr(loc, "HasField", None)
        if has_field is not None:
            try:
                if not has_field(name):
                    return fallback
            except ValueError:
                pass  # non-optional field: plain read below
        return getattr(loc, name)

    ox, oy, oz = old_loc.x, old_loc.y, old_loc.z
    nx = axis(new_loc, "x", ox)
    ny = axis(new_loc, "y", oy)
    nz = axis(new_loc, "z", oz)
    if (nx, ny, nz) == (ox, oy, oz):
        return False, None, None
    if swap_yz:
        return True, SpatialInfo(ox, oz, oy), SpatialInfo(nx, nz, ny)
    return True, SpatialInfo(ox, oy, oz), SpatialInfo(nx, ny, nz)
