"""Core enums and id-space constants.

Values match the wire protocol (ref: pkg/channeldpb/channeld.proto:43-169)
so host code can use them without importing generated protobuf modules.
"""

from __future__ import annotations

from enum import IntEnum, IntFlag


class ConnectionType(IntEnum):
    NO_CONNECTION = 0
    SERVER = 1
    CLIENT = 2


class ChannelType(IntEnum):
    UNKNOWN = 0
    GLOBAL = 1
    PRIVATE = 2
    SUBWORLD = 3
    SPATIAL = 4
    ENTITY = 5
    TEST = 100
    TEST1 = 101
    TEST2 = 102
    TEST3 = 103
    TEST4 = 104


class BroadcastType(IntFlag):
    NO_BROADCAST = 0
    SINGLE_CONNECTION = 1
    ALL = 2
    ALL_BUT_SENDER = 4
    ALL_BUT_OWNER = 8
    ALL_BUT_CLIENT = 16
    ALL_BUT_SERVER = 32
    ADJACENT_CHANNELS = 64

    def check(self, flag: "BroadcastType") -> bool:
        """Bit test helper (ref: pkg/channeldpb/extension.go:5-7)."""
        return bool(self & flag)


class MessageType(IntEnum):
    INVALID = 0
    AUTH = 1
    CREATE_CHANNEL = 3
    REMOVE_CHANNEL = 4
    LIST_CHANNEL = 5
    SUB_TO_CHANNEL = 6
    UNSUB_FROM_CHANNEL = 7
    CHANNEL_DATA_UPDATE = 8
    DISCONNECT = 9
    CREATE_SPATIAL_CHANNEL = 10
    QUERY_SPATIAL_CHANNEL = 11
    CHANNEL_DATA_HANDOVER = 12
    SPATIAL_REGIONS_UPDATE = 13
    UPDATE_SPATIAL_INTEREST = 14
    CREATE_ENTITY_CHANNEL = 15
    ENTITY_GROUP_ADD = 16
    ENTITY_GROUP_REMOVE = 17
    SPATIAL_CHANNELS_READY = 18
    RECOVERY_CHANNEL_DATA = 20
    RECOVERY_END = 21
    CHANNEL_OWNER_LOST = 22
    CHANNEL_OWNER_RECOVERED = 23
    SERVER_BUSY = 24
    CELL_REHOSTED = 25
    CELL_MIGRATED = 26
    CLIENT_REDIRECT = 27
    # Adaptive partitioning (spatial/partition.py, 28;
    # doc/partitioning.md).
    CELL_GEOMETRY_UPDATE = 28
    # Federation trunk plane (gateway<->gateway links only, 30-37;
    # doc/federation.md).
    TRUNK_HELLO = 30
    TRUNK_HEARTBEAT = 31
    TRUNK_HANDOVER_PREPARE = 32
    TRUNK_HANDOVER_ACK = 33
    TRUNK_ABORT_NOTICE = 34
    TRUNK_STAGE_REDIRECT = 35
    TRUNK_STAGE_ACK = 36
    TRUNK_DIRECTORY_UPDATE = 37
    # Global control plane (federation/control.py, 38-45;
    # doc/global_control.md).
    TRUNK_LOAD_REPORT = 38
    TRUNK_SHARD_EPOCH = 39
    TRUNK_SHARD_MIGRATE = 40
    TRUNK_MIGRATE_STATUS = 41
    TRUNK_GATEWAY_DEAD = 42
    TRUNK_ADOPT_DONE = 43
    TRUNK_ADOPT_QUERY = 44
    TRUNK_ADOPT_CLAIMS = 45
    # Durable persistence plane (core/wal.py, 46; doc/persistence.md).
    TRUNK_RESURRECT_HELLO = 46
    DEBUG_GET_SPATIAL_REGIONS = 99
    USER_SPACE_START = 100


class CompressionType(IntEnum):
    NO_COMPRESSION = 0
    SNAPPY = 1


class ChannelDataAccess(IntEnum):
    NO_ACCESS = 0
    READ_ACCESS = 1
    WRITE_ACCESS = 2


class EntityGroupType(IntEnum):
    HANDOVER = 0
    LOCK = 1


class ChannelAccessLevel(IntEnum):
    """Per-operation channel ACL (ref: pkg/channeld/channel_acl.go:6-24)."""

    NONE = 0
    OWNER_ONLY = 1
    OWNER_AND_GLOBAL_OWNER = 2
    ANY = 3


class ConnectionState(IntEnum):
    """(ref: pkg/channeld/connection.go connection state constants)."""

    UNAUTHENTICATED = 0
    AUTHENTICATED = 1
    CLOSING = 2


# Channel id spaces (ref: pkg/channeld/settings.go:94-95, channel.go:218-253):
# GLOBAL = 0; non-spatial ids 1..0xFFFF; spatial from 0x10000; entity from 0x80000.
GLOBAL_CHANNEL_ID = 0
