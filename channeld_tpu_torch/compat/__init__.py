"""Reference-wire-compatible protobuf packages (same package names and
field numbers as the reference's example data families) so sessions and
clients recorded against the reference resolve their Any type URLs here.
"""

from . import chatpb_pb2  # noqa: F401  (registers chatpb.* in the symbol db)
from . import unitypb_pb2  # noqa: F401  (channeldpb.Vector3f/4f, TransformState
#   — the reference's unity_common.proto types, so Unity-SDK Any payloads
#   resolve; ref: pkg/channeldpb/unity_common.proto)

from ..models.chat import attach_chat_merge


def register_compat_chat() -> None:
    """Register chatpb.ChatChannelData as the GLOBAL channel data type,
    with the reference's custom list merge, and initialize the GLOBAL
    channel's data the way the reference chat example does at boot
    (ref: examples/chat-rooms/main.go:74-82 — welcome message, list
    limit 100, truncate-top)."""
    import time as _time

    from ..core.channel import get_global_channel
    from ..core.data import (
        reflect_channel_data_message,
        register_channel_data_type,
    )
    from ..core.types import ChannelType
    from ..models.chat import set_time_span_limit
    from ..protocol import control_pb2

    template = chatpb_pb2.ChatChannelData()
    attach_chat_merge(type(template))
    register_channel_data_type(ChannelType.GLOBAL, template)

    # Explicit config wins: only initialize the GLOBAL data if the type
    # that actually ended up registered is ours (an operator-configured
    # DataMsgFullName makes register_channel_data_type warn-skip above,
    # and their channel must not boot holding chatpb data).
    registered = reflect_channel_data_message(ChannelType.GLOBAL)
    if registered is None or (
        registered.DESCRIPTOR.full_name != "chatpb.ChatChannelData"
    ):
        return
    # Match the reference example's boot tuning (main.go:74-84):
    # welcome message, list limit 100 + truncate-top, 60s survival span.
    set_time_span_limit(60.0)
    gch = get_global_channel()
    if gch is not None and (gch.data is None or gch.data.msg is None):
        initial = chatpb_pb2.ChatChannelData()
        initial.chatMessages.add(
            sender="System", sendTime=int(_time.time()), content="Welcome!"
        )
        gch.init_data(
            initial,
            control_pb2.ChannelDataMergeOptions(
                listSizeLimit=100, truncateTop=True
            ),
        )


# -imports hook (see core.channel.init_channels): `-imports
# channeld_tpu.compat` makes a gateway speak the reference examples' wire
# types out of the box.
register_channel_data_types = register_compat_chat
