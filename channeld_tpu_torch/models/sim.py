"""Behavior extensions for the sim channel-data family.

The reference implements these as methods on generated Go types
(ref: pkg/unrealpb/extension.go:10-94, examples/channeld-ue-tps/tpspb/data.go):
custom merges, the handover trigger inside EntityChannelData.Merge, the
SpatialChannelEntityUpdater (AddEntity/RemoveEntity), and HandoverDataMerger
(MergeTo). Python protobuf classes accept attribute assignment, so the
hooks attach directly to the generated classes.
"""

from __future__ import annotations

from typing import Optional

from ..spatial.controller import SpatialInfo
from ..core.data import IncompatibleUpdateError
from ..utils.logger import get_logger
from . import sim_pb2

logger = get_logger("models.sim")

SimSpatialChannelData = sim_pb2.SimSpatialChannelData
SimEntityChannelData = sim_pb2.SimEntityChannelData
SimGlobalChannelData = sim_pb2.SimGlobalChannelData
EntityState = sim_pb2.EntityState


# ---- SimSpatialChannelData: entity table maintenance ----------------------


def _spatial_add_entity(self, entity_id: int, entity_data) -> None:
    """(ref: unrealpb/extension.go SpatialChannelData.AddEntity)."""
    if isinstance(entity_data, SimEntityChannelData):
        self.entities[entity_id].CopyFrom(entity_data.state)
    elif isinstance(entity_data, EntityState):
        self.entities[entity_id].CopyFrom(entity_data)
    else:
        raise IncompatibleUpdateError(
            f"cannot add entity from {type(entity_data).__name__}")
    self.entities[entity_id].entityId = entity_id


def _spatial_remove_entity(self, entity_id: int) -> None:
    if entity_id in self.entities:
        del self.entities[entity_id]


def _spatial_merge(self, src, options, spatial_notifier) -> None:
    """Entity-table merge: update/insert by id, honoring removed flags
    (ref: unrealpb/extension.go SpatialChannelData.Merge)."""
    if not isinstance(src, SimSpatialChannelData):
        raise IncompatibleUpdateError("src is not a SimSpatialChannelData")
    for entity_id, state in src.entities.items():
        if state.removed:
            self.entities.pop(entity_id, None)
        else:
            self.entities[entity_id].MergeFrom(state)


SimSpatialChannelData.add_entity = _spatial_add_entity
SimSpatialChannelData.remove_entity = _spatial_remove_entity
SimSpatialChannelData.merge = _spatial_merge


# ---- SimEntityChannelData: handover trigger + data merger -----------------


def _position_info(data: "SimEntityChannelData") -> Optional[SpatialInfo]:
    if not data.HasField("state") or not data.state.HasField("transform"):
        return None
    p = data.state.transform.position
    return SpatialInfo(p.x, p.y, p.z)


def _entity_get_spatial_info(self) -> Optional[SpatialInfo]:
    """(ref: spatial.go EntityChannelDataWithSpatialInfo)."""
    return _position_info(self)


def _entity_merge(self, src, options, spatial_notifier) -> None:
    """Merge an update and fire the handover notification when the entity
    MOVED (ref: tpspb/data.go:227-320 + pkg/unreal/handover.go:8-47):
    Vec3 axes carry presence, so a partial position update (only the
    changed axes replicated) merges over the old coordinates instead of
    zeroing them, and the notification fires only on an actual delta."""
    if not isinstance(src, SimEntityChannelData):
        raise IncompatibleUpdateError("src is not a SimEntityChannelData")
    old_info = _position_info(self)
    self.MergeFrom(src)
    # Post-merge position = partial update resolved against old values
    # (absent axes fell back), exactly CheckEntityHandover's fallback.
    new_info = _position_info(self)
    if spatial_notifier is None or old_info is None or new_info is None:
        return
    entity_id = self.state.entityId
    if entity_id == 0:
        return
    provider = lambda src_ch, dst_ch: entity_id
    if (old_info.x, old_info.y, old_info.z) == (new_info.x, new_info.y, new_info.z):
        # No movement -> no handover check (handover.go:31). The device
        # controller still needs to SEE stationary entities (its tracking
        # and follow-interest centering come from updates), so offer the
        # observation without the handover path.
        observe = getattr(spatial_notifier, "observe_entity", None)
        if observe is not None:
            observe(entity_id, new_info, provider)
        return
    spatial_notifier.notify(
        old_info,
        new_info,
        provider,
    )


def _entity_merge_to(self, spatial_data, full_data: bool) -> None:
    """(ref: tpspb/data.go MergeTo). Identifier-only unless ``full_data``."""
    if not isinstance(spatial_data, SimSpatialChannelData):
        raise IncompatibleUpdateError("target is not a SimSpatialChannelData")
    entity_id = self.state.entityId
    if full_data:
        spatial_data.entities[entity_id].CopyFrom(self.state)
    else:
        spatial_data.entities[entity_id].entityId = entity_id


SimEntityChannelData.get_spatial_info = _entity_get_spatial_info
SimEntityChannelData.merge = _entity_merge
SimEntityChannelData.merge_to = _entity_merge_to


# ---- SimHandoverData: the HandoverDataWithPayload seam --------------------


def _handover_clear_payload(self) -> None:
    """Strip the bulk payload for connections without interest
    (ref: spatial.go:594-597 HandoverDataWithPayload +
    unrealpb/extension.go HandoverData.ClearPayload — identity context
    stays, channel data goes)."""
    self.ClearField("channelData")


sim_pb2.SimHandoverData.clear_payload = _handover_clear_payload


def register_sim_types() -> None:
    """Install the sim family as the channel-data types (the reference does
    this via DataMsgFullName in the channel settings or explicit calls in
    example mains)."""
    from ..core.data import register_channel_data_type
    from ..core.types import ChannelType

    register_channel_data_type(ChannelType.SPATIAL, SimSpatialChannelData())
    register_channel_data_type(ChannelType.ENTITY, SimEntityChannelData())
    register_channel_data_type(ChannelType.GLOBAL, SimGlobalChannelData())
    register_channel_data_type(ChannelType.SUBWORLD, SimGlobalChannelData())


# -imports hook (see core.channel.init_channels)
register_channel_data_types = register_sim_types
