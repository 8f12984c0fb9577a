"""Spatial message handlers (ref: pkg/channeld/message_spatial.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.settings import global_settings
from ..core.types import ChannelType, ConnectionType, MessageType
from ..protocol import control_pb2, spatial_pb2
from ..utils.logger import get_logger
from .controller import SpatialInfo, get_spatial_controller

logger = get_logger("spatial.msg")


@dataclass
class SpatialDampingSettings:
    """Fan-out cadence + masks as a function of grid distance
    (ref: message_spatial.go:10-14)."""

    max_distance: int
    fanout_interval_ms: int
    data_field_masks: list[str] = field(default_factory=list)


# Near cells update fast and fully; far cells are damped
# (ref: message_spatial.go:16-29).
spatial_damping_settings: list[SpatialDampingSettings] = [
    SpatialDampingSettings(max_distance=0, fanout_interval_ms=20),
    SpatialDampingSettings(max_distance=1, fanout_interval_ms=50),
    SpatialDampingSettings(max_distance=2, fanout_interval_ms=100),
]


def get_spatial_damping_settings(dist: int) -> Optional[SpatialDampingSettings]:
    for s in spatial_damping_settings:
        if dist <= s.max_distance:
            return s
    return None


def sub_options_for_distance(dist: int) -> control_pb2.ChannelSubscriptionOptions:
    damp = get_spatial_damping_settings(dist)
    if damp is None:
        return control_pb2.ChannelSubscriptionOptions(
            fanOutIntervalMs=global_settings.get_channel_settings(
                ChannelType.SPATIAL
            ).default_fanout_interval_ms
        )
    return control_pb2.ChannelSubscriptionOptions(
        fanOutIntervalMs=damp.fanout_interval_ms,
        dataFieldMasks=damp.data_field_masks,
    )


def apply_interest_diff(conn, desired: dict, origin_channel=None,
                        origin_channel_id: int = 0, stub_id: int = 0) -> None:
    """Diff ``desired`` ({channel_id: grid_distance}) against the
    connection's current spatial subscriptions and enqueue sub/unsub into
    each target channel's own queue (ref: message_spatial.go:82-129).
    Desired channels are always (re)subscribed so distance-damped options
    refresh via the sub-merge."""
    from ..core.channel import get_channel
    from ..core.message import (
        MessageContext,
        handle_sub_to_channel,
        handle_unsub_from_channel,
    )

    to_unsub = set(conn.spatial_subscriptions.keys()) - set(desired.keys())
    for ch_id in to_unsub:
        target = get_channel(ch_id)
        if target is None:
            continue
        unsub_ctx = MessageContext(
            msg_type=MessageType.UNSUB_FROM_CHANNEL,
            msg=control_pb2.UnsubscribedFromChannelMessage(connId=conn.id),
            connection=conn,
            channel=target,
            channel_id=origin_channel_id or ch_id,
            stub_id=stub_id,
        )
        if target is origin_channel:
            handle_unsub_from_channel(unsub_ctx)
        else:
            target.put_message_context(unsub_ctx, handle_unsub_from_channel)

    for ch_id, dist in desired.items():
        target = get_channel(ch_id)
        if target is None:
            continue
        sub_ctx = MessageContext(
            msg_type=MessageType.SUB_TO_CHANNEL,
            msg=control_pb2.SubscribedToChannelMessage(
                connId=conn.id, subOptions=sub_options_for_distance(dist)
            ),
            connection=conn,
            channel=target,
            channel_id=origin_channel_id or ch_id,
        )
        if target is origin_channel:
            handle_sub_to_channel(sub_ctx)
        else:
            target.put_message_context(sub_ctx, handle_sub_to_channel)


def handle_update_spatial_interest(ctx) -> None:
    """Query -> desired sub set -> diff against current -> cross-channel
    sub/unsub (ref: message_spatial.go:41-129). Runs in a spatial channel."""
    from ..core.channel import get_channel
    from ..core.connection import get_connection
    from ..core.message import (
        MessageContext,
        handle_sub_to_channel,
        handle_unsub_from_channel,
    )

    msg = ctx.msg
    if not isinstance(msg, spatial_pb2.UpdateSpatialInterestMessage):
        return
    controller = get_spatial_controller()
    if controller is None:
        logger.error("cannot update spatial interest: no spatial controller")
        return
    client_conn = get_connection(msg.connId)
    if client_conn is None:
        logger.error("cannot update spatial interest: no connection %d", msg.connId)
        return

    # channeld-tpu extension: a followEntityId hands the query to the device
    # decision plane, which re-centers it on the entity and re-diffs the
    # subscriptions every batched tick. A plain query cancels any follow;
    # spots queries fall through to the host path below (absolute points
    # can't follow an entity — the engine itself serves spots via
    # set_spots_query for sidecar consumers).
    # Federation: a client following an entity is ANCHORED on it — if
    # that entity later commits a cross-gateway handover, the client is
    # redirected to the gateway now hosting it (doc/federation.md). The
    # anchor applies on the host path too (the follow itself needs the
    # device plane, but possession doesn't).
    from ..federation.directory import directory as _fed_directory

    if _fed_directory.active:
        from ..federation.plane import plane as _fed_plane

        if msg.followEntityId:
            _fed_plane.set_client_anchor(client_conn, msg.followEntityId)
        else:
            _fed_plane.clear_client_anchor(client_conn.id)

    bad_field = _validate_interest_query(msg.query)
    if bad_field is not None:
        # Hostile or broken query fields (NaN/inf centers, negative
        # radius/angle, oversize spot lists) are rejected BEFORE touching
        # any query table — host or device. Counted (the operator-visible
        # malformed finding) + throttled security log; the connection's
        # existing interest is left untouched.
        _count_malformed(bad_field, msg.connId)
        return

    register = getattr(controller, "register_follow_interest", None)
    unregister = getattr(controller, "unregister_follow_interest", None)
    if callable(register):
        params = _query_to_engine_params(msg.query) if msg.followEntityId else None
        if msg.followEntityId and params is not None:
            kind, extent, direction, angle = params
            register(client_conn, msg.followEntityId, kind, extent, direction, angle)
            return
        if callable(unregister):
            unregister(client_conn.id)

    try:
        spatial_ch_ids = controller.query_channel_ids(msg.query)
    except ValueError as e:
        logger.error("error querying spatial channel ids: %s", e)
        return

    apply_interest_diff(
        client_conn, dict(spatial_ch_ids),
        origin_channel=ctx.channel, origin_channel_id=ctx.channel_id,
        stub_id=ctx.stub_id,
    )

    # Standing-query plane (doc/query_engine.md): the synchronous host
    # apply above keeps the handler's semantics byte-identical; the
    # device row registered here keeps the interest LIVE — geometry
    # epochs, device rebuilds, and damping-distance drift re-apply it
    # with no further client messages.
    plane = getattr(controller, "queryplane", None)
    if plane is not None:
        _register_standing_query(plane, client_conn, msg.query)


_malformed_logged: dict[str, float] = {}  # field -> last log time


def _count_malformed(field: str, conn_id: int) -> None:
    """Operator-visible malformed-query finding: metric always, security
    log throttled per field (a hostile client repeats forever)."""
    import time as _time

    from ..core import metrics
    from ..utils.logger import security_logger

    metrics.query_malformed.labels(field=field).inc()
    now = _time.monotonic()
    if now - _malformed_logged.get(field, -1e9) >= 5.0:
        _malformed_logged[field] = now
        security_logger().warning(
            "malformed UpdateSpatialInterest rejected (%s) from conn %d "
            "(query_malformed_total counts every occurrence)",
            field, conn_id,
        )


def _validate_interest_query(
    query: spatial_pb2.SpatialInterestQuery,
) -> Optional[str]:
    """Reject hostile query fields before they touch any query table:
    the name of the offending field, or None when clean. NaN/inf
    coordinates would poison the device mask math (NaN comparisons are
    all-false — a silently empty interest) or wedge the host sampling
    loops; negative radius/angle invert shape tests; an unbounded spots
    list is an O(N) rasterization the sender controls."""
    import math

    def finite(*vals) -> bool:
        return all(math.isfinite(float(v)) for v in vals)

    if query.HasField("spotsAOI"):
        spots = query.spotsAOI.spots
        if len(spots) > global_settings.queryplane_max_spots:
            return "spots_oversize"
        if not all(finite(s.x, s.y, s.z) for s in spots):
            return "spots_not_finite"
    if query.HasField("boxAOI"):
        box = query.boxAOI
        if not finite(box.center.x, box.center.z, box.extent.x,
                      box.extent.z):
            return "box_not_finite"
        if box.extent.x < 0 or box.extent.z < 0:
            return "box_extent_negative"
    if query.HasField("sphereAOI"):
        sph = query.sphereAOI
        if not finite(sph.center.x, sph.center.z, sph.radius):
            return "sphere_not_finite"
        if sph.radius < 0:
            return "sphere_radius_negative"
    if query.HasField("coneAOI"):
        cone = query.coneAOI
        if not finite(cone.center.x, cone.center.z, cone.direction.x,
                      cone.direction.z, cone.angle, cone.radius):
            return "cone_not_finite"
        if cone.radius < 0:
            return "cone_radius_negative"
        if cone.angle < 0:
            return "cone_angle_negative"
    return None


def _register_standing_query(plane, conn, query) -> None:
    """Map a validated client query onto one standing device row
    (spatial/queryplane.py). An empty query (no AOI field) clears the
    standing registration — the host apply above already unsubscribed."""
    from ..ops.spatial_ops import AOI_BOX, AOI_CONE, AOI_SPHERE

    if query.HasField("spotsAOI"):
        plane.register_client_spots(
            conn,
            [(s.x, s.z) for s in query.spotsAOI.spots],
            list(query.spotsAOI.dists) or None,
        )
    elif query.HasField("sphereAOI"):
        sph = query.sphereAOI
        plane.register_client(
            conn, AOI_SPHERE, (sph.center.x, sph.center.z),
            (sph.radius, 0.0),
        )
    elif query.HasField("boxAOI"):
        box = query.boxAOI
        plane.register_client(
            conn, AOI_BOX, (box.center.x, box.center.z),
            (box.extent.x, box.extent.z),
        )
    elif query.HasField("coneAOI"):
        cone = query.coneAOI
        plane.register_client(
            conn, AOI_CONE, (cone.center.x, cone.center.z),
            (cone.radius, 0.0), (cone.direction.x, cone.direction.z),
            cone.angle,
        )
    else:
        plane.deregister(conn.id)


def _query_to_engine_params(query: spatial_pb2.SpatialInterestQuery):
    """Map a proto query shape onto the device query table's SoA row
    (ref: ops/spatial_ops.py QuerySet); spots have no follow semantics."""
    from ..ops.spatial_ops import AOI_BOX, AOI_CONE, AOI_SPHERE

    if query.HasField("sphereAOI"):
        return AOI_SPHERE, (query.sphereAOI.radius, 0.0), (1.0, 0.0), 0.0
    if query.HasField("boxAOI"):
        return AOI_BOX, (query.boxAOI.extent.x, query.boxAOI.extent.z), (1.0, 0.0), 0.0
    if query.HasField("coneAOI"):
        c = query.coneAOI
        return AOI_CONE, (c.radius, 0.0), (c.direction.x, c.direction.z), c.angle
    return None


def handle_create_spatial_channel(ctx, msg: control_pb2.CreateChannelMessage) -> None:
    """(ref: message_spatial.go:131-189). Called from handle_create_channel."""
    from ..core.channel import get_global_channel
    from ..core.subscription import subscribe_to_channel
    from ..core.subscription_messages import send_subscribed

    if ctx.connection.connection_type != ConnectionType.SERVER:
        logger.error("illegal attempt to create SPATIAL channel from a client")
        return
    controller = get_spatial_controller()
    if controller is None:
        logger.error("illegal attempt to create SPATIAL channel: no controller")
        return
    try:
        channels = controller.create_channels(ctx)
    except Exception as e:
        logger.error("failed to create spatial channels: %s", e)
        return

    resp = ctx.clone_for_send()
    resp.msg_type = MessageType.CREATE_SPATIAL_CHANNEL
    resp.msg = spatial_pb2.CreateSpatialChannelsResultMessage(
        spatialChannelId=[ch.id for ch in channels],
        metadata=msg.metadata,
        ownerConnId=ctx.connection.id,
    )
    ctx.connection.send(resp)
    gch = get_global_channel()
    owner = gch.get_owner() if gch is not None else None
    if owner is not None and owner is not ctx.connection and not owner.is_closing():
        mirror = resp.clone_for_send()
        mirror.stub_id = 0
        owner.send(mirror)

    for ch in channels:
        cs, _ = subscribe_to_channel(ctx.connection, ch, msg.subOptions)
        if cs is not None:
            send_subscribed(ctx.connection, ch, ctx.connection, 0, cs.options)

    logger.info(
        "created %d spatial channels for conn %d", len(channels), ctx.connection.id
    )

    # Push the region table so the server can map positions locally.
    regions_ctx = ctx.clone_for_send()
    regions_ctx.msg_type = MessageType.SPATIAL_REGIONS_UPDATE
    regions_ctx.msg = spatial_pb2.SpatialRegionsUpdateMessage(
        regions=controller.get_regions()
    )
    ctx.connection.send(regions_ctx)


def handle_create_entity_channel(ctx) -> None:
    """(ref: message_spatial.go:191-333)."""
    from ..core import events
    from ..core.channel import (
        create_channel_with_id,
        get_channel,
        get_global_channel,
    )
    from ..core.connection import all_connections
    from ..core.data import unwrap_update_any
    from ..core.message import MessageContext
    from ..core.subscription import subscribe_to_channel
    from ..core.subscription_messages import send_subscribed

    gch = get_global_channel()
    if ctx.channel is not gch and ctx.channel.channel_type != ChannelType.SPATIAL:
        logger.error(
            "illegal attempt to create entity channel outside GLOBAL/SPATIAL channels"
        )
        return
    msg = ctx.msg
    if not isinstance(msg, spatial_pb2.CreateEntityChannelMessage):
        return
    entity_ch_id = msg.entityId
    if entity_ch_id < global_settings.entity_channel_id_start:
        logger.error("invalid entityId %d for entity channel", entity_ch_id)
        return
    existing = get_channel(entity_ch_id)
    if existing is not None and not existing.is_removing():
        logger.warning("entity channel %d already exists", entity_ch_id)
        return

    new_channel = create_channel_with_id(entity_ch_id, ChannelType.ENTITY, ctx.connection)
    new_channel.metadata = msg.metadata

    controller = get_spatial_controller()
    if msg.HasField("data"):
        try:
            data_msg = unwrap_update_any(msg.data)
        except Exception:
            new_channel.logger.exception("failed to unmarshal entity channel data")
            data_msg = None
        if data_msg is not None:
            new_channel.init_data(data_msg, msg.mergeOptions)
            # Entity created by the master server but carrying a position:
            # ownership belongs to the spatial channel's server.
            get_info = getattr(data_msg, "get_spatial_info", None)
            info = get_info() if callable(get_info) else None
            if ctx.channel is gch and controller is not None and info is not None:
                _assign_spatial_owner(ctx, new_channel, info)
            # Device-backed controllers track positions from birth so the
            # batch tick has a previous cell to detect crossings against.
            track = getattr(controller, "track_entity", None)
            if callable(track) and info is not None:
                track(new_channel.id, info)
    else:
        new_channel.init_data(None, msg.mergeOptions)

    resp = ctx.clone_for_send()
    resp.msg = control_pb2.CreateChannelResultMessage(
        channelType=new_channel.channel_type,
        metadata=new_channel.metadata,
        ownerConnId=ctx.connection.id,
        channelId=new_channel.id,
    )
    ctx.connection.send(resp)

    if msg.isWellKnown:
        # Everyone sees well-known entities, regardless of AOI.
        for conn in list(all_connections().values()):
            if conn.connection_type == ConnectionType.SERVER:
                continue
            cs, should_send = subscribe_to_channel(conn, new_channel, None)
            if should_send:
                send_subscribed(conn, new_channel, conn, 0, cs.options)

        def _on_auth(data: events.AuthEventData) -> None:
            if data.connection.connection_type == ConnectionType.SERVER:
                return
            # Give the client time to handle the spawn message first.
            sub_options = control_pb2.ChannelSubscriptionOptions(fanOutDelayMs=1000)
            cs, should_send = subscribe_to_channel(
                data.connection, new_channel, sub_options
            )
            if should_send:
                send_subscribed(data.connection, new_channel, data.connection, 0, cs.options)

        events.auth_complete.listen_for(new_channel, _on_auth)

    cs, _ = subscribe_to_channel(ctx.connection, new_channel, msg.subOptions)
    if cs is not None:
        send_subscribed(ctx.connection, new_channel, ctx.connection, 0, cs.options)


def _assign_spatial_owner(ctx, entity_channel, info) -> None:
    """(ref: message_spatial.go:237-276)."""
    from ..core import events
    from ..core.channel import get_channel

    controller = get_spatial_controller()
    try:
        spatial_ch_id = controller.get_channel_id(
            SpatialInfo(info.x, info.y, info.z)
            if not isinstance(info, SpatialInfo)
            else info
        )
    except ValueError as e:
        logger.error("failed to map entity position to spatial channel: %s", e)
        return
    spatial_ch = get_channel(spatial_ch_id)
    if spatial_ch is None:
        entity_channel.logger.error(
            "owning spatial channel %d does not exist", spatial_ch_id
        )
        return
    owner = spatial_ch.get_owner()
    if owner is None or owner.is_closing():
        entity_channel.logger.warning(
            "owning spatial channel %d has no owner connection", spatial_ch_id
        )
        return
    entity_channel.set_owner(owner)
    events.entity_channel_spatially_owned.broadcast(
        events.SpatialOwnershipData(
            entity_channel=entity_channel, spatial_channel=spatial_ch
        )
    )
    # Route the result to the spatial owner instead of the master server.
    ctx.connection = owner
    ctx.channel_id = spatial_ch_id


def handle_query_spatial_channel(ctx) -> None:
    """(ref: message_spatial.go:335-370)."""
    from ..core.channel import get_global_channel

    if ctx.channel is not get_global_channel():
        logger.error("illegal attempt to query spatial channel outside GLOBAL")
        return
    msg = ctx.msg
    if not isinstance(msg, spatial_pb2.QuerySpatialChannelMessage):
        return
    controller = get_spatial_controller()
    if controller is None:
        logger.error("cannot query spatial channel: no controller")
        return
    channel_ids = []
    for info in msg.spatialInfo:
        try:
            channel_ids.append(
                controller.get_channel_id(SpatialInfo(info.x, info.y, info.z))
            )
        except ValueError:
            channel_ids.append(0)
    resp = ctx.clone_for_send()
    resp.msg = spatial_pb2.QuerySpatialChannelResultMessage(channelId=channel_ids)
    ctx.connection.send(resp)


def handle_debug_get_spatial_regions(ctx) -> None:
    """Dev-mode only (ref: message_debug.go:8-39)."""
    if not global_settings.development:
        logger.error("DebugGetSpatialRegions is only available in development mode")
        return
    controller = get_spatial_controller()
    if controller is None:
        return
    resp = ctx.clone_for_send()
    resp.msg_type = MessageType.SPATIAL_REGIONS_UPDATE
    resp.msg = spatial_pb2.SpatialRegionsUpdateMessage(regions=controller.get_regions())
    ctx.connection.send(resp)


def install_spatial_handlers() -> None:
    """Register the spatial/entity handlers into the message map
    (ref: message.go:52-59)."""
    from ..core.message import MESSAGE_MAP, MessageMapEntry
    from .entity import handle_add_entity_group, handle_remove_entity_group

    for msg_type, template, handler in [
        (
            MessageType.QUERY_SPATIAL_CHANNEL,
            spatial_pb2.QuerySpatialChannelMessage,
            handle_query_spatial_channel,
        ),
        (
            MessageType.UPDATE_SPATIAL_INTEREST,
            spatial_pb2.UpdateSpatialInterestMessage,
            handle_update_spatial_interest,
        ),
        (
            MessageType.CREATE_ENTITY_CHANNEL,
            spatial_pb2.CreateEntityChannelMessage,
            handle_create_entity_channel,
        ),
        (
            MessageType.ENTITY_GROUP_ADD,
            spatial_pb2.AddEntityGroupMessage,
            handle_add_entity_group,
        ),
        (
            MessageType.ENTITY_GROUP_REMOVE,
            spatial_pb2.RemoveEntityGroupMessage,
            handle_remove_entity_group,
        ),
        (
            MessageType.DEBUG_GET_SPATIAL_REGIONS,
            spatial_pb2.DebugGetSpatialRegionsMessage,
            handle_debug_get_spatial_regions,
        ),
    ]:
        MESSAGE_MAP[msg_type] = MessageMapEntry(template, handler)
