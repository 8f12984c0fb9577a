"""Message contexts, the handler registry, and system message handlers.

Capability parity with the reference dispatch layer (ref: pkg/channeld/message.go):
MessageMap msgType -> (template, handler); user-space messages (>= 100)
forwarded opaquely between clients and servers; system handlers for auth,
channel lifecycle, sub/unsub, data update, disconnect.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Optional

from google.protobuf.message import Message

from ..protocol import MESSAGE_TEMPLATES, control_pb2, wire_pb2
from ..utils.logger import get_logger, security_logger
from . import events, metrics
from .acl import ChannelAccessType, check_acl
from .auth import AuthResult, get_auth_provider, run_auth
from .data import unwrap_update_any
from .settings import global_settings
from .subscription import subscribe_to_channel, unsubscribe_from_channel
from .subscription_messages import send_subscribed, send_unsubscribed
from .types import (
    BroadcastType,
    ChannelDataAccess,
    ChannelType,
    ConnectionType,
    MessageType,
)

if TYPE_CHECKING:
    from .channel import Channel

logger = get_logger("message")


class MessageContext:
    """(ref: message.go:12-33).

    A plain __slots__ class, not a dataclass: one context is built per
    dispatched message, and the dataclass-generated ``__init__`` plus a
    class-wide ``__setattr__`` guard measured ~1.9M attribute-set calls
    in a 27s load profile. Only ``msg`` needs the invalidation guard, so
    it alone is a property."""

    __slots__ = ("msg_type", "_msg", "broadcast", "stub_id", "channel_id",
                 "connection", "channel", "arrival_time", "raw_body",
                 "ingest_ns")

    def __init__(self, msg_type: int = 0, msg: Optional[Message] = None,
                 broadcast: int = 0, stub_id: int = 0, channel_id: int = 0,
                 connection: Optional[object] = None,
                 channel: Optional["Channel"] = None,
                 arrival_time: float = 0.0,
                 raw_body: Optional[bytes] = None,
                 ingest_ns: int = 0):
        self.msg_type = msg_type
        self._msg = msg
        self.broadcast = broadcast
        self.stub_id = stub_id
        self.channel_id = channel_id
        self.connection = connection  # receiving connection
        self.channel = channel
        self.arrival_time = arrival_time
        # Host-monotonic stamp of the connection read that carried this
        # message (0 = internal); rides into the update ring so the
        # fan-out can record end-to-end delivery latency (core/slo.py).
        self.ingest_ns = ingest_ns
        # Pre-serialized ``msg`` bytes: senders use these instead of
        # re-serializing, letting a broadcast share one encode across all
        # recipients. Reassigning ``msg`` invalidates them (see setter).
        self.raw_body = raw_body

    @property
    def msg(self) -> Optional[Message]:
        return self._msg

    @msg.setter
    def msg(self, value) -> None:
        # Keep raw_body honest: swapping the message (the forwarding
        # handlers' pattern) must never ship the old bytes.
        self.raw_body = None
        self._msg = value

    def ensure_raw_body(self) -> None:
        """Encode once before a multi-recipient send; lives next to the
        invalidation guard so the contract stays in one place."""
        if self.raw_body is None and self.msg is not None:
            self.raw_body = self.msg.SerializeToString()

    def has_connection(self) -> bool:
        return self.connection is not None and not self.connection.is_closing()

    def clone_for_send(self) -> "MessageContext":
        return MessageContext(
            msg_type=self.msg_type,
            msg=self.msg,
            broadcast=self.broadcast,
            stub_id=self.stub_id,
            channel_id=self.channel_id,
            connection=self.connection,
            channel=self.channel,
            ingest_ns=self.ingest_ns,
        )


MessageHandler = Callable[[MessageContext], None]


@dataclass
class MessageMapEntry:
    template: type
    handler: MessageHandler


MESSAGE_MAP: dict[int, MessageMapEntry] = {}


def register_message_handler(msg_type: int, template: type, handler: MessageHandler) -> None:
    """(ref: message.go:62). User-space services register their own types."""
    MESSAGE_MAP[msg_type] = MessageMapEntry(template, handler)


# ---- user-space forwarding ----------------------------------------------


def handle_client_to_server_user_message(ctx: MessageContext) -> None:
    """Client -> owner server, or broadcast when ownerless and enabled
    (ref: message.go:66-126)."""
    msg = ctx.msg
    if not isinstance(msg, wire_pb2.ServerForwardMessage):
        logger.error("message is not a ServerForwardMessage")
        return
    owner = ctx.channel.get_owner()
    if owner is not None and not owner.is_closing():
        if owner.should_recover():
            # Owner mid-recovery: client updates are dropped (message.go:72-80).
            return
        owner.send(ctx)
    elif ctx.broadcast > 0:
        if ctx.channel.enable_client_broadcast:
            ctx.channel.broadcast(ctx)
        else:
            logger.error(
                "illegal client broadcast attempt on channel %d", ctx.channel.id
            )
    else:
        # Ownerless drop: counted whether the owner might still come back
        # (recovery window open) or is gone for good — a sustained rate
        # after failover should have run is the operator's alarm
        # (doc/failover.md).
        metrics.ownerless_drops.labels(
            channel_type=ctx.channel.channel_type.name
        ).inc()
        if not ctx.channel.recoverable_subs:
            # Once per second per channel: every in-flight client message
            # hits this line the moment an owner drops, and per-message
            # warnings at load-test rates turn the log into the
            # bottleneck (observed: >1M lines in 30s).
            now = time.monotonic()
            if now - getattr(ctx.channel, "_ownerless_warn_at", 0.0) > 1.0:
                ctx.channel._ownerless_warn_at = now
                ctx.channel.logger.warning(
                    "channel has no owner to forward to (suppressing "
                    "repeats for 1s)"
                )


def handle_server_to_client_user_message(ctx: MessageContext) -> None:
    """(ref: message.go:128-241)."""
    msg = ctx.msg
    if not isinstance(msg, wire_pb2.ServerForwardMessage):
        logger.error("message is not a ServerForwardMessage")
        return
    bc = ctx.broadcast
    if bc == BroadcastType.NO_BROADCAST:
        if not ctx.channel.send_to_owner(ctx):
            logger.error("cannot forward: channel %d has no owner", ctx.channel.id)
    elif bc == BroadcastType.SINGLE_CONNECTION:
        from .connection import get_connection

        if msg.clientConnId == 0:
            conn = ctx.channel.get_owner()
        else:
            conn = get_connection(msg.clientConnId)
        if conn is not None and not conn.is_closing():
            conn.send(ctx)
        else:
            logger.info("drop forward: target connection %d gone", msg.clientConnId)
    elif BroadcastType.ALL <= bc < BroadcastType.ADJACENT_CHANNELS:
        ctx.channel.broadcast(ctx)
    elif BroadcastType(bc).check(BroadcastType.ADJACENT_CHANNELS):
        _broadcast_adjacent(ctx, msg)


def _broadcast_adjacent(ctx: MessageContext, msg) -> None:
    from ..spatial.controller import get_spatial_controller
    from .channel import get_channel

    if ctx.channel.channel_type != ChannelType.SPATIAL:
        logger.warning("ADJACENT_CHANNELS broadcast on non-spatial channel")
        return
    controller = get_spatial_controller()
    if controller is None:
        logger.error("no spatial controller")
        return
    channel_ids = list(controller.get_adjacent_channels(ctx.channel.id))
    bc = BroadcastType(ctx.broadcast)
    if not bc.check(BroadcastType.ALL_BUT_OWNER):
        channel_ids.append(ctx.channel.id)
    # De-duplicate connections subscribed to several adjacent cells.
    conns: set = set()
    for cid in channel_ids:
        ch = get_channel(cid)
        if ch is None:
            continue
        conns |= ch.get_all_connections()
    # One encode for the whole adjacent fleet (see Channel.broadcast).
    ctx.ensure_raw_body()
    for conn in conns:
        if bc.check(BroadcastType.ALL_BUT_SENDER) and conn is ctx.connection:
            continue
        if bc.check(BroadcastType.ALL_BUT_CLIENT) and conn.connection_type == ConnectionType.CLIENT:
            continue
        if bc.check(BroadcastType.ALL_BUT_SERVER) and conn.connection_type == ConnectionType.SERVER:
            continue
        if conn.id == msg.clientConnId:
            continue
        conn.send(ctx)


# ---- system handlers -----------------------------------------------------


def handle_auth(ctx: MessageContext) -> None:
    """(ref: message.go:243-286)."""
    from .channel import get_global_channel
    from .ddos import is_pit_banned

    if ctx.channel is not get_global_channel():
        logger.error("illegal attempt to authenticate outside the GLOBAL channel")
        ctx.connection.close()
        return
    msg = ctx.msg
    if not isinstance(msg, control_pb2.AuthMessage):
        ctx.connection.close()
        return

    if is_pit_banned(msg.playerIdentifierToken):
        security_logger().info(
            "refused authentication of banned PIT %s", msg.playerIdentifierToken
        )
        ctx.connection.close()
        return

    # Overload admission control (doc/overload.md): at L3 new clients
    # get a structured retry-after instead of service — the reactor
    # floor belongs to the sessions already in. Servers are control
    # plane and always admitted.
    if ctx.connection.connection_type == ConnectionType.CLIENT:
        from .overload import governor

        decision = governor.admit_connection()
        if not decision.admitted:
            # Resuming sessions are exempt: a PIT with a live recovery
            # handle was already admitted once, and serving the resume
            # is far cheaper than burning its recoverable state.
            from .connection_recovery import get_recover_handle

            handle = get_recover_handle(msg.playerIdentifierToken)
            if handle is None or handle.is_timed_out():
                governor.count_shed("admission_connection")
                _send_server_busy(ctx, decision)
                ctx.connection.flush()  # the refusal must hit the wire...
                ctx.connection.close()  # ...before teardown drops it
                return

    provider = get_auth_provider()
    if provider is None and not global_settings.development:
        # run_server() refuses to boot in this state; if a hand-wired setup
        # reaches here anyway, close the connection instead of raising —
        # the per-message isolator would swallow the exception and leave
        # the connection dangling unauthenticated.
        security_logger().error(
            "no auth provider configured outside development mode; "
            "closing connection %d", ctx.connection.id,
        )
        ctx.connection.close()
        return

    if (
        ctx.connection.connection_type == ConnectionType.SERVER
        and global_settings.server_bypass_auth
    ) or provider is None:
        on_auth_complete(ctx, AuthResult.SUCCESSFUL, msg.playerIdentifierToken)
        return

    async def _do_auth():
        try:
            result = await run_auth(
                provider, ctx.connection.id, msg.playerIdentifierToken, msg.loginToken
            )
        except Exception:
            ctx.connection.logger.exception("auth provider failed")
            ctx.connection.close()
            return
        on_auth_complete(ctx, result, msg.playerIdentifierToken)

    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    if loop is not None:
        loop.create_task(_do_auth())
    else:
        # No running loop (synchronous tests): run inline with the same
        # error policy as the async path; async providers get a scratch loop.
        try:
            result = provider.do_auth(
                ctx.connection.id, msg.playerIdentifierToken, msg.loginToken
            )
            if asyncio.iscoroutine(result):
                result = asyncio.new_event_loop().run_until_complete(result)
        except Exception:
            ctx.connection.logger.exception("auth provider failed")
            ctx.connection.close()
            return
        on_auth_complete(ctx, result, msg.playerIdentifierToken)


def on_auth_complete(ctx: MessageContext, result, pit: str) -> None:
    """(ref: message.go:288-315)."""
    from .channel import get_global_channel
    from .ddos import on_auth_result

    if ctx.connection.is_closing():
        return
    if result == AuthResult.SUCCESSFUL:
        ctx.connection.on_authenticated(pit)
    on_auth_result(ctx.connection, result, pit)

    resp = ctx.clone_for_send()
    resp.msg = control_pb2.AuthResultMessage(
        result=result,
        connId=ctx.connection.id,
        compressionType=global_settings.compression_type,
        shouldRecover=ctx.connection.should_recover(),
    )
    ctx.connection.send(resp)

    gch = get_global_channel()
    if gch is not None and gch.has_owner():
        mirror = resp.clone_for_send()
        mirror.stub_id = 0
        gch.send_to_owner(mirror)

    events.auth_complete.broadcast(
        events.AuthEventData(connection=ctx.connection, player_identifier_token=pit)
    )


def _send_server_busy(ctx: MessageContext, decision) -> None:
    """Reply to an admission-refused request with the structured
    retry-after result (ServerBusyMessage, msgType 24)."""
    busy = ctx.clone_for_send()
    busy.msg_type = MessageType.SERVER_BUSY
    busy.msg = control_pb2.ServerBusyMessage(
        reason=decision.reason,
        retryAfterMs=decision.retry_after_ms,
        overloadLevel=_overload_level(),
    )
    ctx.connection.send(busy)


def _overload_level() -> int:
    from .overload import governor

    return int(governor.level)


def handle_server_busy(ctx: MessageContext) -> None:
    """ServerBusyMessage is gateway -> peer only; receiving one here
    means a confused (or hostile) peer echoed it back."""
    logger.warning(
        "unexpected ServerBusyMessage from conn %s (gateway-to-peer only)",
        getattr(ctx.connection, "id", None),
    )


def handle_client_redirect(ctx: MessageContext) -> None:
    """ClientRedirectMessage is gateway -> client only (federation plane,
    doc/federation.md); receiving one here means a confused (or hostile)
    peer echoed it back."""
    logger.warning(
        "unexpected ClientRedirectMessage from conn %s "
        "(gateway-to-client only)",
        getattr(ctx.connection, "id", None),
    )


def handle_create_channel(ctx: MessageContext) -> None:
    """(ref: message.go:318-398)."""
    from .channel import create_channel, get_global_channel

    gch = get_global_channel()
    if ctx.channel is not gch:
        logger.error("illegal attempt to create channel outside the GLOBAL channel")
        return
    msg = ctx.msg
    if not isinstance(msg, control_pb2.CreateChannelMessage):
        return

    if msg.channelType == ChannelType.UNKNOWN:
        logger.error("illegal attempt to create the UNKNOWN channel")
        return
    if msg.channelType == ChannelType.GLOBAL:
        # Creating GLOBAL = claiming ownership of it.
        new_channel = gch
        if not gch.has_owner():
            gch.set_owner(ctx.connection)
            events.global_channel_possessed.broadcast(gch)
            ctx.connection.logger.info("owned the GLOBAL channel")
        else:
            logger.error("illegal attempt to create the GLOBAL channel")
            return
    elif msg.channelType == ChannelType.SPATIAL:
        from ..spatial.messages import handle_create_spatial_channel

        handle_create_spatial_channel(ctx, msg)
        return
    else:
        try:
            new_channel = create_channel(msg.channelType, ctx.connection)
        except Exception as e:
            logger.error("failed to create channel: %s", e)
            return

    new_channel.metadata = msg.metadata
    if msg.HasField("data"):
        try:
            data_msg = unwrap_update_any(msg.data)
        except Exception:
            new_channel.logger.exception("failed to unmarshal channel data")
            return
        new_channel.init_data(data_msg, msg.mergeOptions)
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
    if gch.get_owner() is not ctx.connection and gch.has_owner():
        mirror = resp.clone_for_send()
        mirror.stub_id = 0
        gch.send_to_owner(mirror)

    cs, _ = subscribe_to_channel(ctx.connection, new_channel, msg.subOptions)
    if cs is not None:
        send_subscribed(ctx.connection, new_channel, ctx.connection, 0, cs.options)


def handle_remove_channel(ctx: MessageContext) -> None:
    """(ref: message.go:400-453)."""
    from .channel import get_channel, remove_channel

    msg = ctx.msg
    if not isinstance(msg, control_pb2.RemoveChannelMessage):
        return
    target = get_channel(msg.channelId)
    if target is None:
        logger.error("invalid channelId %d for removal", msg.channelId)
        return
    has_access, reason = check_acl(target, ctx.connection, ChannelAccessType.REMOVE)
    if ctx.has_connection() and not has_access:
        ctx.connection.logger.error(
            "no access to remove channel %d: %s", target.id, reason
        )
        return
    for sub_conn in list(target.subscribed_connections.keys()):
        resp = ctx.clone_for_send()
        resp.stub_id = 0
        sub_conn.send(resp)
    remove_channel(target)


def handle_list_channel(ctx: MessageContext) -> None:
    """(ref: message.go:455-486)."""
    from .channel import all_channels, get_global_channel

    if ctx.channel is not get_global_channel():
        logger.error("illegal attempt to list channels outside the GLOBAL channel")
        return
    msg = ctx.msg
    if not isinstance(msg, control_pb2.ListChannelMessage):
        return
    result = control_pb2.ListChannelResultMessage()
    for ch in all_channels().values():
        if msg.typeFilter != ChannelType.UNKNOWN and msg.typeFilter != ch.channel_type:
            continue
        if msg.metadataFilters and not any(
            kw in ch.metadata for kw in msg.metadataFilters
        ):
            continue
        result.channels.add(
            channelId=ch.id, channelType=ch.channel_type, metadata=ch.metadata
        )
    resp = ctx.clone_for_send()
    resp.msg = result
    ctx.connection.send(resp)


def handle_sub_to_channel(ctx: MessageContext) -> None:
    """(ref: message.go:488-545)."""
    from .connection import get_connection

    msg = ctx.msg
    if not isinstance(msg, control_pb2.SubscribedToChannelMessage):
        return
    if ctx.connection.connection_type == ConnectionType.CLIENT:
        conn_to_sub = ctx.connection
    else:
        # Only servers may subscribe another connection.
        conn_to_sub = get_connection(msg.connId)
    if conn_to_sub is None:
        logger.error("invalid connId %d for sub", msg.connId)
        return
    # Overload admission control: at L3, NEW client self-subscriptions
    # are refused with a structured retry-after (re-subscriptions merge
    # options as usual — they are already being served, and server-
    # driven subs are control plane).
    if (
        ctx.connection.connection_type == ConnectionType.CLIENT
        and conn_to_sub is ctx.connection
        and ctx.channel.subscribed_connections.get(conn_to_sub) is None
    ):
        from .overload import governor

        decision = governor.admit_subscription()
        if not decision.admitted:
            governor.count_shed("admission_subscription")
            _send_server_busy(ctx, decision)
            return
    has_access, reason = check_acl(ctx.channel, ctx.connection, ChannelAccessType.SUB)
    if conn_to_sub.id != ctx.connection.id and not has_access:
        ctx.connection.logger.warning(
            "no access to sub conn %d to channel %d: %s", msg.connId, ctx.channel.id, reason
        )
        return
    cs, should_send = subscribe_to_channel(
        conn_to_sub, ctx.channel, msg.subOptions if msg.HasField("subOptions") else None
    )
    if not should_send:
        return
    send_subscribed(ctx.connection, ctx.channel, conn_to_sub, ctx.stub_id, cs.options)
    if conn_to_sub is not ctx.connection:
        send_subscribed(conn_to_sub, ctx.channel, conn_to_sub, 0, cs.options)
    owner = ctx.channel.get_owner()
    if owner is not None and owner is not ctx.connection and not owner.is_closing():
        send_subscribed(owner, ctx.channel, conn_to_sub, 0, cs.options)


def handle_unsub_from_channel(ctx: MessageContext) -> None:
    """(ref: message.go:547-606)."""
    from .connection import get_connection

    msg = ctx.msg
    if not isinstance(msg, control_pb2.UnsubscribedFromChannelMessage):
        return
    conn_to_unsub = get_connection(msg.connId)
    if conn_to_unsub is None:
        logger.error("invalid connId %d for unsub", msg.connId)
        return
    has_access, reason = check_acl(ctx.channel, ctx.connection, ChannelAccessType.UNSUB)
    if conn_to_unsub.id != ctx.connection.id and not has_access:
        ctx.connection.logger.error(
            "no access to unsub conn %d from channel %d: %s",
            msg.connId, ctx.channel.id, reason,
        )
        return
    try:
        unsubscribe_from_channel(conn_to_unsub, ctx.channel)
    except KeyError:
        ctx.connection.logger.warning(
            "failed to unsub conn %d from channel %d", msg.connId, ctx.channel.id
        )
        return
    send_unsubscribed(ctx.connection, ctx.channel, conn_to_unsub, ctx.stub_id)
    if conn_to_unsub is not ctx.connection:
        send_unsubscribed(conn_to_unsub, ctx.channel, conn_to_unsub, 0)
    owner = ctx.channel.get_owner()
    if owner is not None and not owner.is_closing():
        if owner is not ctx.connection and owner is not conn_to_unsub:
            send_unsubscribed(owner, ctx.channel, conn_to_unsub, 0)
        elif owner is conn_to_unsub:
            # Owner unsubscribed itself.
            ctx.channel.set_owner(None)


def handle_channel_data_update(ctx: MessageContext) -> None:
    """(ref: message.go:608-658)."""
    ch = ctx.channel
    owner = ch.get_owner()
    if owner is not ctx.connection:
        cs = ch.subscribed_connections.get(ctx.connection)
        if cs is None or cs.options.dataAccess != ChannelDataAccess.WRITE_ACCESS:
            if (
                ctx.connection.connection_type == ConnectionType.SERVER
                and owner is not None
                and not owner.is_closing()
            ):
                # Server without write access acts on behalf of the owner.
                ctx.connection = owner
            else:
                ctx.connection.logger.warning(
                    "update denied on channel %d: no write access", ch.id
                )
                return
    if ch.data is None:
        ch.logger.info("channel data not initialized; send CreateChannel first")
        return
    msg = ctx.msg
    if not isinstance(msg, control_pb2.ChannelDataUpdateMessage):
        return
    try:
        update_msg = unwrap_update_any(msg.data)
    except Exception:
        ctx.connection.logger.exception("failed to unmarshal channel update data")
        return
    if ch.spatial_notifier is not None:
        if ctx.connection.connection_type == ConnectionType.CLIENT:
            ch.set_data_update_conn_id(ctx.connection.id)
        else:
            ch.set_data_update_conn_id(msg.contextConnId)
    ch.data.on_update(
        update_msg, ctx.arrival_time, ctx.connection.id, ch.spatial_notifier,
        now_ns=ch.get_time(), ingest_ns=ctx.ingest_ns,
    )


def handle_disconnect(ctx: MessageContext) -> None:
    """(ref: message.go:660-686)."""
    from .channel import get_global_channel
    from .connection import get_connection

    if ctx.channel is not get_global_channel():
        logger.error("illegal attempt to disconnect outside the GLOBAL channel")
        return
    msg = ctx.msg
    if not isinstance(msg, control_pb2.DisconnectMessage):
        return
    target = get_connection(msg.connId)
    if target is None:
        logger.warning("could not find connection %d to disconnect", msg.connId)
        return
    target.disconnect()
    target.close()


def init_message_map() -> None:
    """Install the system handlers (ref: message.go:41-60). Spatial and
    entity handlers are installed by channeld_tpu.spatial."""
    MESSAGE_MAP.clear()
    for msg_type, handler in [
        (MessageType.AUTH, handle_auth),
        (MessageType.CREATE_CHANNEL, handle_create_channel),
        (MessageType.REMOVE_CHANNEL, handle_remove_channel),
        (MessageType.LIST_CHANNEL, handle_list_channel),
        (MessageType.SUB_TO_CHANNEL, handle_sub_to_channel),
        (MessageType.UNSUB_FROM_CHANNEL, handle_unsub_from_channel),
        (MessageType.CHANNEL_DATA_UPDATE, handle_channel_data_update),
        (MessageType.DISCONNECT, handle_disconnect),
        (MessageType.SERVER_BUSY, handle_server_busy),
        (MessageType.CLIENT_REDIRECT, handle_client_redirect),
        # CREATE_SPATIAL_CHANNEL shares the CreateChannelMessage body and
        # handler (ref: message.go:52-53).
        (MessageType.CREATE_SPATIAL_CHANNEL, handle_create_channel),
    ]:
        MESSAGE_MAP[msg_type] = MessageMapEntry(MESSAGE_TEMPLATES[msg_type], handler)
    try:
        from ..spatial.messages import install_spatial_handlers
    except ImportError:
        return
    install_spatial_handlers()
