"""SUB/UNSUB result notifications (ref: pkg/channeld/subscription.go:150-187)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..protocol import control_pb2
from .types import MessageType

if TYPE_CHECKING:
    from .channel import Channel


def send_subscribed(
    recipient, ch: "Channel", conn_to_sub, stub_id: int, sub_options
) -> None:
    from .message import MessageContext

    recipient.send(
        MessageContext(
            msg_type=MessageType.SUB_TO_CHANNEL,
            msg=control_pb2.SubscribedToChannelResultMessage(
                connId=conn_to_sub.id,
                subOptions=sub_options,
                connType=conn_to_sub.connection_type,
                channelType=ch.channel_type,
            ),
            channel_id=ch.id,
            stub_id=stub_id,
        )
    )


def send_unsubscribed(
    recipient, ch: "Channel", conn_to_unsub: Optional[object], stub_id: int
) -> None:
    from .message import MessageContext

    if conn_to_unsub is None:
        conn_to_unsub = recipient
    recipient.send(
        MessageContext(
            msg_type=MessageType.UNSUB_FROM_CHANNEL,
            msg=control_pb2.UnsubscribedFromChannelResultMessage(
                connId=conn_to_unsub.id,
                connType=conn_to_unsub.connection_type,
                channelType=ch.channel_type,
            ),
            channel_id=ch.id,
            stub_id=stub_id,
        )
    )
