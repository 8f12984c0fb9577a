"""Wire protocol: schema (generated protobuf), framing, message registry.

Reference counterpart: pkg/channeldpb. Regenerate the ``*_pb2`` modules
with ``scripts/gen_protos.sh`` after editing the ``.proto`` files.
"""

from . import control_pb2, replay_pb2, spatial_pb2, wire_pb2
from .framing import (
    FrameDecoder,
    FramingError,
    HEADER_SIZE,
    MAX_PACKET_SIZE,
    encode_frame,
    encode_packet,
)

# MessageType -> protobuf template class for system messages
# (ref: pkg/channeld/message.go:41-62 MessageMap).
MESSAGE_TEMPLATES = {
    1: control_pb2.AuthMessage,
    3: control_pb2.CreateChannelMessage,
    4: control_pb2.RemoveChannelMessage,
    5: control_pb2.ListChannelMessage,
    6: control_pb2.SubscribedToChannelMessage,
    7: control_pb2.UnsubscribedFromChannelMessage,
    8: control_pb2.ChannelDataUpdateMessage,
    9: control_pb2.DisconnectMessage,
    10: control_pb2.CreateChannelMessage,  # CREATE_SPATIAL_CHANNEL shares the body
    11: spatial_pb2.QuerySpatialChannelMessage,
    12: spatial_pb2.ChannelDataHandoverMessage,
    13: spatial_pb2.SpatialRegionsUpdateMessage,
    14: spatial_pb2.UpdateSpatialInterestMessage,
    15: spatial_pb2.CreateEntityChannelMessage,
    16: spatial_pb2.AddEntityGroupMessage,
    17: spatial_pb2.RemoveEntityGroupMessage,
    18: spatial_pb2.SpatialChannelsReadyMessage,
    20: control_pb2.ChannelDataRecoveryMessage,
    21: control_pb2.EndRecoveryMessage,
    22: control_pb2.ChannelOwnerLostMessage,
    23: control_pb2.ChannelOwnerRecoveredMessage,
    24: control_pb2.ServerBusyMessage,
    25: spatial_pb2.CellRehostedMessage,
    26: spatial_pb2.CellMigratedMessage,
    27: control_pb2.ClientRedirectMessage,
    99: spatial_pb2.DebugGetSpatialRegionsMessage,
}

__all__ = [
    "wire_pb2",
    "control_pb2",
    "spatial_pb2",
    "FrameDecoder",
    "FramingError",
    "HEADER_SIZE",
    "MAX_PACKET_SIZE",
    "encode_frame",
    "encode_packet",
    "MESSAGE_TEMPLATES",
]
