"""Chat channel-data behavior: custom list merge with time-span truncation
(ref: examples/chat-rooms/chatpb/merge.go:14-49).

When the merged message list exceeds listSizeLimit with truncateTop, the
head is trimmed — but messages younger than TIME_SPAN_LIMIT survive even
beyond the limit, so a burst of fresh chat is never cut mid-conversation.
"""

from __future__ import annotations

import time

from ..core.data import IncompatibleUpdateError

from . import chat_pb2

ChatMessage = chat_pb2.ChatMessage
ChatChannelData = chat_pb2.ChatChannelData

# Messages newer than this always survive a top-truncation (seconds).
# Module-level so deployments can match the reference examples (chat-rooms
# main.go sets 60s at boot; merge.go's own default is 10s).
TIME_SPAN_LIMIT = 10.0


def set_time_span_limit(seconds: float) -> None:
    global TIME_SPAN_LIMIT
    TIME_SPAN_LIMIT = seconds


def _chat_merge(self, src, options, spatial_notifier) -> None:
    # The same merge serves the chtpu-native family and the
    # reference-package-compatible one (compat/chatpb.proto). A
    # cross-family update (same field numbers, different descriptor pool)
    # is converted via serialize/parse BEFORE any mutation — mutating
    # first and failing on extend would wipe existing history when
    # shouldReplaceList is set.
    if type(src) is not type(self):
        if not hasattr(src, "chatMessages"):
            raise IncompatibleUpdateError("src is not a chat channel data message")
        converted = type(self)()
        converted.ParseFromString(src.SerializeToString())
        src = converted
    if options is not None and options.shouldReplaceList:
        del self.chatMessages[:]
    self.chatMessages.extend(src.chatMessages)

    if options is None:
        return
    limit = options.listSizeLimit
    n = len(self.chatMessages)
    if limit > 0 and n > limit:
        if options.truncateTop:
            start = n - limit
            if TIME_SPAN_LIMIT > 0:
                available_ms = (time.time() - TIME_SPAN_LIMIT) * 1000
                while start > 0 and self.chatMessages[start - 1].sendTime >= available_ms:
                    start -= 1
            del self.chatMessages[:start]
        else:
            del self.chatMessages[limit:]


def attach_chat_merge(cls) -> None:
    """Attach the reference chat merge to a ChatChannelData-shaped class."""
    cls.merge = _chat_merge


attach_chat_merge(ChatChannelData)


def register_chat_types() -> None:
    from ..core.data import register_channel_data_type
    from ..core.types import ChannelType

    register_channel_data_type(ChannelType.GLOBAL, ChatChannelData())
    register_channel_data_type(ChannelType.SUBWORLD, ChatChannelData())
    register_channel_data_type(ChannelType.PRIVATE, ChatChannelData())


# -imports hook (see core.channel.init_channels)
register_channel_data_types = register_chat_types
