"""Channel subscriptions and fan-out queue membership.

Capability parity with the reference (ref: pkg/channeld/subscription.go):
per-subscription options merged over channel-type defaults, re-subscription
merges options (reporting whether data access changed), fan-out queue entry
with delayed first fan-out, and the spatial-subscription mirror on the
connection used by ``has_interest_in``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from ..protocol import control_pb2
from .data import FanOutConnection, NS_PER_MS
from .overload import sub_priority
from .settings import global_settings
from .types import ChannelDataAccess, ChannelType, ConnectionType


def _priority_for(conn, options, st) -> int:
    """Overload shed priority: SERVER connections are authority/control
    plane and always priority 0 (never shed) regardless of options;
    clients derive theirs from the subscription options."""
    if getattr(conn, "connection_type", None) == ConnectionType.SERVER:
        return 0
    return sub_priority(options, st.default_fanout_interval_ms)

if TYPE_CHECKING:
    from .channel import Channel


@dataclass
class ChannelSubscription:
    options: control_pb2.ChannelSubscriptionOptions
    sub_time: int  # ns, channel time
    fanout_conn: FanOutConnection
    # Overload shed priority from the options (0 WRITE-access authority,
    # 1 READ at default cadence, 2 slower observers); the governor's L2+
    # update shed keys off this (core/overload.py).
    priority: int = 1


def default_sub_options(channel_type: int) -> control_pb2.ChannelSubscriptionOptions:
    st = global_settings.channel_settings_view(ChannelType(channel_type))
    return control_pb2.ChannelSubscriptionOptions(
        dataAccess=ChannelDataAccess.READ_ACCESS,
        dataFieldMasks=[],
        fanOutIntervalMs=st.default_fanout_interval_ms,
        fanOutDelayMs=st.default_fanout_delay_ms,
        skipSelfUpdateFanOut=True,
        skipFirstFanOut=False,
    )


def subscribe_to_channel(
    conn, ch: "Channel", options: Optional[control_pb2.ChannelSubscriptionOptions]
) -> tuple[Optional[ChannelSubscription], bool]:
    """Returns (subscription, should_send_result).

    Re-subscription merges options and reports True only when data access
    changed (ref: subscription.go:34-102).
    """
    if conn.is_closing():
        return None, False

    st_view = global_settings.channel_settings_view(ch.channel_type)
    cs = ch.subscribed_connections.get(conn)
    if cs is not None:
        data_access_changed = False
        if options is not None:
            before = cs.options.dataAccess
            before_interval = cs.options.fanOutIntervalMs
            cs.options.MergeFrom(options)
            data_access_changed = before != cs.options.dataAccess
            cs.priority = _priority_for(conn, cs.options, st_view)
            if cs.options.fanOutIntervalMs != before_interval:
                slot = cs.fanout_conn.device_sub_slot
                if slot is not None:
                    ctl = _device_fanout_controller()
                    if ctl is not None:
                        ctl.device_sub_set_interval(
                            slot, cs.options.fanOutIntervalMs
                        )
                # A now-slower subscriber widens the ring retention window,
                # or early-window updates would be evicted before its next
                # fan-out (same bookkeeping as the fresh-subscribe path).
                if (ch.data is not None and
                        ch.data.max_fanout_interval_ms < cs.options.fanOutIntervalMs):
                    ch.data.max_fanout_interval_ms = cs.options.fanOutIntervalMs
        return cs, data_access_changed

    merged = default_sub_options(ch.channel_type)
    if options is not None:
        merged.MergeFrom(options)

    now = ch.get_time()
    foc = FanOutConnection(
        conn=conn,
        # skipFirstFanOut pretends the full-state send already happened.
        had_first_fanout=merged.skipFirstFanOut,
        # Delay the first fan-out so spawn messages can arrive first.
        last_fanout_time=now + merged.fanOutDelayMs * NS_PER_MS,
    )
    cs = ChannelSubscription(
        options=merged, sub_time=now, fanout_conn=foc,
        priority=_priority_for(conn, merged, st_view),
    )
    ch.fan_out_queue.insert(0, foc)

    if ch.data is not None and ch.data.max_fanout_interval_ms < merged.fanOutIntervalMs:
        ch.data.max_fanout_interval_ms = merged.fanOutIntervalMs

    ch.subscribed_connections[conn] = cs
    # A parked channel must start fanning out to its new subscriber now,
    # not at the next heartbeat.
    wake = getattr(ch, "wake", None)
    if callable(wake):
        wake()

    if ch.channel_type == ChannelType.SPATIAL:
        conn.spatial_subscriptions[ch.id] = cs.options
        # Device fan-out plane: register the sub in the engine's batched
        # due table so tick_data takes the decision from the device tick
        # (host time-check fallback when no TPU controller / table full).
        ctl = _device_fanout_controller()
        slot = None
        if ctl is not None:
            slot = ctl.device_sub_add(
                merged.fanOutIntervalMs, merged.fanOutDelayMs, ch.id
            )
        if slot is not None:
            foc.device_sub_slot = slot
            ch.device_sub_slots[slot] = foc
        else:
            ch.device_fallback_focs.append(foc)

    return cs, True


def _device_fanout_controller():
    """The active TPU spatial controller, or None (duck-typed: anything
    with the device_sub_* API)."""
    from ..spatial.controller import get_spatial_controller

    ctl = get_spatial_controller()
    if ctl is not None and hasattr(ctl, "device_sub_add"):
        return ctl
    return None


def release_device_fanout(ch: "Channel", foc: FanOutConnection) -> None:
    """Free a fan-out connection's engine sub slot (or host-fallback list
    entry). Every subscription-teardown path must come through here —
    explicit unsubscribe, the channel's closed-connection prune, and
    tick_data's dead-conn sweep — or engine slots leak one per disconnect
    until the table is exhausted."""
    slot = foc.device_sub_slot
    if slot is not None:
        foc.device_sub_slot = None
        ch.device_sub_slots.pop(slot, None)
        ctl = _device_fanout_controller()
        if ctl is not None:
            ctl.device_sub_remove(slot)
    else:
        try:
            ch.device_fallback_focs.remove(foc)
        except ValueError:
            pass
    # The fan-out queue too: device mode never iterates it, so a dead foc
    # left behind would sit there for the channel's lifetime.
    try:
        ch.fan_out_queue.remove(foc)
    except ValueError:
        pass


def unsubscribe_from_channel(
    conn, ch: "Channel"
) -> control_pb2.ChannelSubscriptionOptions:
    """(ref: subscription.go:104-125). Raises KeyError if not subscribed."""
    cs = ch.subscribed_connections.get(conn)
    if cs is None:
        raise KeyError(f"connection {conn.id} is not subscribed to channel {ch.id}")
    try:
        ch.fan_out_queue.remove(cs.fanout_conn)
    except ValueError:
        pass
    del ch.subscribed_connections[conn]
    if ch.channel_type == ChannelType.SPATIAL:
        conn.spatial_subscriptions.pop(ch.id, None)
        release_device_fanout(ch, cs.fanout_conn)
    return cs.options
