from .types import (
    BroadcastType,
    ChannelAccessLevel,
    ChannelDataAccess,
    ChannelType,
    CompressionType,
    ConnectionState,
    ConnectionType,
    EntityGroupType,
    GLOBAL_CHANNEL_ID,
    MessageType,
)
from .settings import ACLSettings, ChannelSettings, GlobalSettings, global_settings
from .event import Event
from .fsm import FsmState, MessageFsm

__all__ = [
    "BroadcastType",
    "ChannelAccessLevel",
    "ChannelDataAccess",
    "ChannelType",
    "CompressionType",
    "ConnectionState",
    "ConnectionType",
    "EntityGroupType",
    "GLOBAL_CHANNEL_ID",
    "MessageType",
    "ACLSettings",
    "ChannelSettings",
    "GlobalSettings",
    "global_settings",
    "Event",
    "FsmState",
    "MessageFsm",
]
