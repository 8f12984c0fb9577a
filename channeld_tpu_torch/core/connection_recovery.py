"""Server-connection recovery (ref: pkg/channeld/connection_recovery.go).

When a recoverable server connection drops unexpectedly, a PIT-keyed
handle preserves its previous connection id, and each channel stashes the
old subscription (and owner flag). When a connection re-authenticates
with the same PIT, it reclaims the previous id, channels re-subscribe it
(skipping the first fan-out), stream ``ChannelDataRecoveryMessage`` with
full state + extension payload, and after the recovery window a single
``RECOVERY_END`` closes the process.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

from ..protocol import control_pb2
from ..utils.anyutil import pack_any
from ..utils.logger import get_logger
from .settings import global_settings
from .types import BroadcastType, ChannelType, GLOBAL_CHANNEL_ID, MessageType

if TYPE_CHECKING:
    from .channel import Channel
    from .connection import Connection

logger = get_logger("recovery")

# Window for all channels to stream their recovery data before RECOVERY_END
# (ref: connection_recovery.go:15-16).
CHANNEL_DATA_RECOVERY_TIMEOUT = 1.0


# Lifetime of a PRE-STAGED handle (client redirect, federation/plane.py)
# when server_conn_recover_timeout_ms is 0 ("never"): a redirected
# client that never shows up must not pin its reserved conn id and
# per-channel stash entries forever.
STAGED_HANDLE_TTL_MS = 30_000


@dataclass
class ConnectionRecoverHandle:
    prev_conn_id: int
    disconn_time: float
    new_conn: Optional["Connection"] = None
    start_recovery_time: float = 0.0
    # True for a handle created ahead of any connection (a client
    # redirect's pre-staged session, doc/federation.md): its conn id is
    # reserved (not a dead socket's), and its expiry is a quiet cleanup
    # — never a ServerLostEvent.
    staged: bool = False

    def is_timed_out(self) -> bool:
        if self.new_conn is not None and not self.new_conn.is_closing():
            # Claimed: recovery is in progress (RECOVERY_END ends it
            # within the recovery window). Expiring now would purge the
            # per-channel stashes out from under the live resume — a
            # reconnect landing just inside the window must finish.
            return False
        timeout_ms = global_settings.server_conn_recover_timeout_ms
        if self.staged and timeout_ms <= 0:
            timeout_ms = STAGED_HANDLE_TTL_MS
        return timeout_ms > 0 and (time.monotonic() - self.disconn_time) > timeout_ms / 1000.0


@dataclass
class RecoverableSubscription:
    conn_handle: ConnectionRecoverHandle
    is_owner: bool
    old_sub_time: float
    old_sub_options: control_pb2.ChannelSubscriptionOptions = field(
        default_factory=control_pb2.ChannelSubscriptionOptions
    )


# PIT -> handle (ref: connectionRecoverHandles map).
_recover_handles: dict[str, ConnectionRecoverHandle] = {}

# Hard cap on outstanding handles. With server_conn_recover_timeout_ms=0
# handles never time out, so a fleet of crashed-and-replaced servers
# (each with a fresh PIT) would grow the table forever — chaos soaks
# with repeated transport resets surfaced exactly this. At the cap the
# oldest-disconnected handle is evicted: its server has had the longest
# window to return, and an evicted PIT simply re-joins without recovery.
MAX_RECOVER_HANDLES = 4096


def get_recover_handle(pit: str) -> Optional[ConnectionRecoverHandle]:
    return _recover_handles.get(pit)


def make_recoverable(conn: "Connection") -> None:
    """(ref: connection_recovery.go:34-41)."""
    if (
        conn.pit not in _recover_handles
        and len(_recover_handles) >= MAX_RECOVER_HANDLES
    ):
        from . import metrics

        # Never evict an in-progress recovery (new_conn set): the reaper
        # only scans this table, so an evicted in-progress handle would
        # never get RECOVERY_END and its connection would stay in
        # recovery forever. Idle handles (server not back yet) are safe
        # to drop — the server simply re-joins without recovery. With no
        # idle handle to evict (every slot mid-recovery — a mass-restart
        # burst), the safe degradation is to make THIS close
        # non-recoverable rather than wedge a recovering peer.
        idle = [p for p, h in _recover_handles.items() if h.new_conn is None]
        if not idle:
            logger.warning(
                "recovery handle table full (%d) with every handle "
                "mid-recovery; %s will re-join without recovery",
                MAX_RECOVER_HANDLES, conn.pit,
            )
            return
        oldest = min(idle, key=lambda p: _recover_handles[p].disconn_time)
        # An evicted server can never recover — same terminal fate as a
        # window expiry, so it takes the same single ServerLost path
        # (stash purge + one event; failover re-hosts its cells).
        expire_recover_handle(oldest, _recover_handles[oldest],
                              reason="evicted")
        metrics.recover_handles_evicted.inc()
        logger.warning(
            "recovery handle table full (%d); evicted oldest idle pit %s",
            MAX_RECOVER_HANDLES, oldest,
        )
    handle = ConnectionRecoverHandle(
        prev_conn_id=conn.id, disconn_time=time.monotonic()
    )
    _recover_handles[conn.pit] = handle
    conn.recover_handle = handle


def expire_recover_handle(
    pit: str, handle: ConnectionRecoverHandle, reason: str = "timeout"
) -> bool:
    """THE server-dead-for-good path. Every way a recovery can end
    without the server returning — window expiry noticed by the reaper
    loop, expiry noticed by a channel tick, handle eviction at the table
    cap — funnels here, so failover, metrics and tests all key off ONE
    ``ServerLostEvent`` per loss. Idempotent: only the caller that still
    finds the handle installed processes it.

    Collects (and purges) the dead server's per-channel recovery stash —
    without the purge, a crash-looping fleet would leak a
    RecoverableSubscription into every channel each server subscribed
    to. Channels configured to die with their owner still do; everything
    else is left for the failover plane (spatial cells re-host, other
    types stay ownerless with their drops counted).

    A STAGED handle (pre-created for a client redirect that never
    arrived, doc/federation.md) expires quietly instead: purge its
    stash, release its reserved conn id, no ServerLostEvent — no
    server died."""
    if _recover_handles.get(pit) is not handle:
        return False
    del _recover_handles[pit]
    if handle.staged:
        from .channel import all_channels as _staged_channels
        from .connection import release_connection_id

        for ch in list(_staged_channels().values()):
            ch.recoverable_subs.pop(pit, None)
        release_connection_id(handle.prev_conn_id)
        logger.info(
            "staged recovery handle for %s expired unclaimed (%s); "
            "reserved conn id %d released", pit, reason,
            handle.prev_conn_id,
        )
        return True
    from . import events, metrics
    from .channel import _remove_channel_after_owner_removed, all_channels

    owned: list[int] = []
    subscribed: list[int] = []
    for ch in list(all_channels().values()):
        rsub = ch.recoverable_subs.pop(pit, None)
        if rsub is None:
            continue
        if getattr(rsub, "is_owner", False):
            owned.append(ch.id)
            if global_settings.get_channel_settings(
                ch.channel_type
            ).remove_channel_after_owner_removed:
                _remove_channel_after_owner_removed(ch)
        else:
            subscribed.append(ch.id)
    metrics.server_lost.inc()
    logger.warning(
        "server %s (conn %d) lost for good (%s): %d owned / %d "
        "subscribed channels stashed",
        pit, handle.prev_conn_id, reason, len(owned), len(subscribed),
    )
    events.server_lost.broadcast(events.ServerLostData(
        pit=pit,
        prev_conn_id=handle.prev_conn_id,
        owned_channel_ids=owned,
        subscribed_channel_ids=subscribed,
        reason=reason,
    ))
    return True


def stage_recovery_handle(
    pit: str, channel_ids: list[int], sub_options=None
) -> ConnectionRecoverHandle:
    """Pre-create the recovery state a redirected client will claim on
    arrival (doc/federation.md): a handle keyed by the client's PIT
    holding a RESERVED connection id, plus a recoverable subscription on
    each of ``channel_ids`` — so when the client connects here and auths
    with that PIT, the ordinary recovery machinery (recover_from_handle
    + tick_recoverable_subscriptions) restores its session: previous-id
    reclaim, re-subscription with skipFirstFanOut, full state via
    ChannelDataRecoveryMessage, RECOVERY_END. No fresh login, no
    SUB_TO_CHANNEL round-trips.

    Re-staging an outstanding PIT (a second redirect racing the first,
    or a redirect while the client already holds a recovery handle here)
    merges: the existing handle and its conn id are kept, the new
    channels' stashes are added, and the staging clock restarts."""
    from .channel import get_channel
    from .connection import release_connection_id, reserve_connection_id

    handle = _recover_handles.get(pit)
    if handle is not None and handle.new_conn is None:
        # Outstanding handle (staged earlier, or a real disconnect whose
        # window is still open): reuse it — its prev_conn_id is the id
        # this client should reclaim regardless of which path made it.
        handle.disconn_time = time.monotonic()
    else:
        if (
            pit not in _recover_handles
            and len(_recover_handles) >= MAX_RECOVER_HANDLES
        ):
            # Same cap policy as make_recoverable, same safe degradation:
            # with no room, the redirect proceeds unstaged (the client
            # re-joins the destination without recovery).
            raise RuntimeError("recovery handle table full")
        handle = ConnectionRecoverHandle(
            prev_conn_id=reserve_connection_id(),
            disconn_time=time.monotonic(),
            staged=True,
        )
        old = _recover_handles.get(pit)
        if old is not None and old.staged:
            release_connection_id(old.prev_conn_id)
        _recover_handles[pit] = handle

    from .wal import wal as _wal

    if _wal.enabled:
        # Staged handles are durable (doc/persistence.md): a redirected
        # client must still resume here after a crash-restart.
        _wal.log_staged_handle(pit, channel_ids)
    opts = control_pb2.ChannelSubscriptionOptions()
    if sub_options is not None:
        opts.MergeFrom(sub_options)
    now = time.monotonic()
    for cid in channel_ids:
        ch = get_channel(cid)
        if ch is None or ch.is_removing():
            continue
        ch.recoverable_subs[pit] = RecoverableSubscription(
            conn_handle=handle,
            is_owner=False,
            old_sub_time=now,
            old_sub_options=opts,
        )
    return handle


def staged_handle_snapshot() -> list[tuple[str, list[int]]]:
    """(pit, channel ids) for every outstanding STAGED handle — the
    gateway snapshot's extras (doc/persistence.md): a staged redirect
    must survive a crash-restart or the redirected client re-auths
    against a gateway that promised it recovery. Live-session handles
    (a real disconnect mid-window) ride too: their channel set is
    whatever channels hold their recoverable subs."""
    from .channel import all_channels

    channels_of: dict[str, list[int]] = {}
    for cid, ch in all_channels().items():
        if ch.is_removing():
            continue
        for pit, rsub in ch.recoverable_subs.items():
            channels_of.setdefault(pit, []).append(cid)
    out: list[tuple[str, list[int]]] = []
    for pit, handle in _recover_handles.items():
        if handle.new_conn is not None:
            continue  # mid-recovery; the live connection owns it now
        out.append((pit, sorted(channels_of.get(pit, []))))
    return sorted(out)


def recover_from_handle(conn: "Connection", handle: ConnectionRecoverHandle) -> None:
    """Reclaim the previous connection id (ref: connection_recovery.go:47-63)."""
    from . import connection as connection_mod

    prev = connection_mod._all_connections.pop(handle.prev_conn_id, None)
    if prev is not None and prev is not conn and not prev.is_closing():
        # Previous id is still actively used — recovery fails.
        connection_mod._all_connections[handle.prev_conn_id] = prev
        conn.logger.error("failed to recover: previous connection id is in use")
        return
    connection_mod._all_connections.pop(conn.id, None)
    conn.id = handle.prev_conn_id
    connection_mod._all_connections[conn.id] = conn
    # A staged handle's id was only a reservation until this moment.
    connection_mod.release_connection_id(handle.prev_conn_id)
    conn.recover_handle = handle
    handle.new_conn = conn
    handle.start_recovery_time = time.monotonic()
    from . import metrics

    metrics.connection_recovered.inc()


def tick_connection_recovery_once() -> None:
    """Reap timed-out handles; end completed recoveries
    (ref: connection_recovery.go:65-92)."""
    from .message import MessageContext

    for pit, handle in list(_recover_handles.items()):
        if handle.is_timed_out():
            expire_recover_handle(pit, handle)
            continue
        if handle.new_conn is None:
            continue
        if time.monotonic() - handle.start_recovery_time > CHANNEL_DATA_RECOVERY_TIMEOUT:
            handle.new_conn.send(
                MessageContext(
                    msg_type=MessageType.RECOVERY_END,
                    msg=control_pb2.EndRecoveryMessage(),
                    channel_id=GLOBAL_CHANNEL_ID,
                )
            )
            handle.new_conn.recover_handle = None
            del _recover_handles[pit]


async def connection_recovery_loop() -> None:
    while True:
        tick_connection_recovery_once()
        await asyncio.sleep(1.0)


def tick_recoverable_subscriptions(ch: "Channel") -> None:
    """Per-channel recovery tick (ref: connection_recovery.go:94-171)."""
    from .message import MessageContext
    from .subscription import subscribe_to_channel

    for pit, rsub in list(ch.recoverable_subs.items()):
        handle = rsub.conn_handle
        if handle.is_timed_out():
            # Per-PIT expiry through the single ServerLost path (which
            # also pops this channel's stash). The old in-place clear
            # wiped OTHER servers' stashes on this channel and never
            # told anyone the server was gone.
            expire_recover_handle(pit, handle)
            continue

        if handle.new_conn is None:
            continue

        new_conn = handle.new_conn
        if rsub.is_owner:
            if ch.has_owner():
                ch.logger.warning("failed to restore channel owner: already owned")
            else:
                ch.set_owner(new_conn)
                if ch.channel_type == ChannelType.GLOBAL:
                    from . import events

                    events.global_channel_possessed.broadcast(ch)

        # The recovered subscriber already has (stale) state; recovery data
        # replaces the first full fan-out.
        rsub.old_sub_options.skipFirstFanOut = True
        subscribe_to_channel(new_conn, ch, rsub.old_sub_options)

        data_msg = ch.get_data_message()
        if data_msg is None:
            del ch.recoverable_subs[pit]
            continue
        recovery_msg = control_pb2.ChannelDataRecoveryMessage(
            channelId=ch.id,
            channelType=ch.channel_type,
            metadata=ch.metadata,
            subTime=int(rsub.old_sub_time * 1000),
            subOptions=rsub.old_sub_options,
            channelData=pack_any(data_msg),
        )
        if ch.has_owner():
            recovery_msg.ownerConnId = ch.get_owner().id
        if ch.data is not None and ch.data.extension is not None:
            ext_msg = ch.data.extension.get_recovery_data_message()
            if ext_msg is not None:
                recovery_msg.recoveryData.CopyFrom(pack_any(ext_msg))
        new_conn.send(
            MessageContext(
                msg_type=MessageType.RECOVERY_CHANNEL_DATA,
                msg=recovery_msg,
                channel_id=ch.id,
            )
        )
        del ch.recoverable_subs[pit]

        if global_settings.get_channel_settings(
            ch.channel_type
        ).send_owner_lost_and_recovered:
            _schedule_owner_recovered_broadcast(ch)


def _schedule_owner_recovered_broadcast(ch: "Channel") -> None:
    """Broadcast CHANNEL_OWNER_RECOVERED after the recovery window."""
    from .message import MessageContext

    def _broadcast():
        ch.broadcast(
            MessageContext(
                msg_type=MessageType.CHANNEL_OWNER_RECOVERED,
                msg=control_pb2.ChannelOwnerRecoveredMessage(),
                broadcast=BroadcastType.ALL_BUT_OWNER,
                channel_id=ch.id,
            )
        )

    try:
        loop = asyncio.get_running_loop()
        loop.call_later(CHANNEL_DATA_RECOVERY_TIMEOUT, _broadcast)
    except RuntimeError:
        _broadcast()  # no loop (tests): deliver immediately


def reset_recovery() -> None:
    """Test hook."""
    _recover_handles.clear()
