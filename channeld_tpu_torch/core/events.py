"""Global framework events (ref: pkg/channeld/event.go:10-31).

Payloads are small dataclasses carrying ids rather than live objects
where possible, to keep cross-module coupling low.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .event import Event


@dataclass
class AuthEventData:
    connection: Any  # core.connection.Connection
    player_identifier_token: str


@dataclass
class FsmDisallowedData:
    connection: Any
    msg_type: int


@dataclass
class SpatialOwnershipData:
    entity_channel: Any  # the entity channel spatially owned
    spatial_channel: Any


@dataclass
class ServerLostData:
    """A recoverable server connection is gone FOR GOOD: its recovery
    window expired (or its handle was evicted) without the server
    returning. Fired exactly once per loss, from the single expiry path
    (core/connection_recovery.py expire_recover_handle) — failover,
    metrics and tests all key off this one event (doc/failover.md)."""

    pit: str
    prev_conn_id: int
    # Channel ids the dead server OWNED (any type; the failover plane
    # re-hosts the spatial ones and re-points entity channels).
    owned_channel_ids: list
    # Channel ids it was merely subscribed to (already pruned).
    subscribed_channel_ids: list
    reason: str = "timeout"  # "timeout" | "evicted"


# Fired when the GLOBAL channel gains/loses an owner connection.
global_channel_possessed: Event[Any] = Event("GlobalChannelPossessed")
global_channel_unpossessed: Event[Any] = Event("GlobalChannelUnpossessed")

channel_created: Event[Any] = Event("ChannelCreated")
channel_removing: Event[Any] = Event("ChannelRemoving")
channel_removed: Event[int] = Event("ChannelRemoved")  # payload: channel id

auth_complete: Event[AuthEventData] = Event("AuthComplete")
fsm_disallowed: Event[FsmDisallowedData] = Event("FsmDisallowed")

entity_channel_spatially_owned: Event[SpatialOwnershipData] = Event(
    "EntityChannelSpatiallyOwned"
)

# Fired once when a recoverable server's recovery window expires without
# the server coming back — the dead-for-good signal the failover plane,
# metrics and tests all share (doc/failover.md).
server_lost: Event[ServerLostData] = Event("ServerLost")


def reset_all() -> None:
    """Test hook: drop all listeners so tests stay independent."""
    for ev in (
        global_channel_possessed,
        global_channel_unpossessed,
        channel_created,
        channel_removing,
        channel_removed,
        auth_complete,
        fsm_disallowed,
        entity_channel_spatially_owned,
        server_lost,
    ):
        ev._handlers.clear()
        ev._waiters.clear()
