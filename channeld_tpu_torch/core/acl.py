"""Per-channel-type access control for sub/unsub/remove operations.

Capability parity with the reference ACL (ref: pkg/channeld/channel_acl.go):
four levels — NONE, OWNER_ONLY, OWNER_AND_GLOBAL_OWNER, ANY — configured
per channel type and operation in the channel-settings JSON.
"""

from __future__ import annotations

from enum import IntEnum
from typing import TYPE_CHECKING, Optional

from .settings import global_settings
from .types import ChannelAccessLevel, ChannelType

if TYPE_CHECKING:
    from .channel import Channel


class ChannelAccessType(IntEnum):
    SUB = 0
    UNSUB = 1
    REMOVE = 2


def check_acl(channel: "Channel", conn, access_type: ChannelAccessType) -> tuple[bool, Optional[str]]:
    """Returns (has_access, reason_if_denied).

    ``conn is None`` means an internal operation, which is always allowed
    (ref: channel_acl.go:30-35 and handleRemoveChannel's nil-conn path).
    """
    if conn is None:
        return True, None

    acl = global_settings.get_channel_settings(ChannelType(channel.channel_type)).acl
    level = {
        ChannelAccessType.SUB: acl.sub,
        ChannelAccessType.UNSUB: acl.unsub,
        ChannelAccessType.REMOVE: acl.remove,
    }[access_type]

    if level == ChannelAccessLevel.NONE:
        return False, "access level is None"
    if level == ChannelAccessLevel.ANY:
        return True, None

    from .channel import get_global_channel

    owner = channel.get_owner()
    if owner is not None and owner is conn:
        return True, None
    if level == ChannelAccessLevel.OWNER_AND_GLOBAL_OWNER:
        gch = get_global_channel()
        if gch is not None and gch.get_owner() is conn:
            return True, None
        return False, "connection is not the channel owner nor the global owner"
    return False, "connection is not the channel owner"
