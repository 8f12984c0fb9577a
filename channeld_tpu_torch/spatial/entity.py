"""Entity channels: handover/lock groups (ref: pkg/channeld/entity.go).

Groups are *shared instances* cascaded across member entity channels: when
entity A adds B to its handover group, B's controller adopts the same group
object, so later members join everyone's group at once. A LOCK group beats
HANDOVER — if any member of the handover group is locked, no handover
happens at all.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..utils.logger import get_logger
from ..core.types import EntityGroupType

if TYPE_CHECKING:
    from ..core.channel import Channel

logger = get_logger("entity")


class EntityGroup:
    def __init__(self):
        self.entity_ids: set[int] = set()

    def add_group(self, other: Optional["EntityGroup"]) -> None:
        if other is not None:
            self.entity_ids |= other.entity_ids


class FlatEntityGroupController:
    """Single-layer handover/lock grouping (ref: entity.go:58-224)."""

    def __init__(self):
        self.entity_id = 0
        self.handover_group: Optional[EntityGroup] = None
        self.lock_group: Optional[EntityGroup] = None

    def initialize(self, ch: "Channel") -> None:
        self.entity_id = ch.id

    def uninitialize(self, ch: "Channel") -> None:
        from ..core.types import ChannelType

        if ch.channel_type != ChannelType.ENTITY:
            return
        # Drop this entity from groups it may share with other channels.
        for t in (EntityGroupType.HANDOVER, EntityGroupType.LOCK):
            try:
                self.remove_from_group(t, [self.entity_id])
            except ValueError:
                pass

    def cascade_group(self, t: EntityGroupType, group: EntityGroup) -> None:
        """Adopt a shared group instance (ref: entity.go:83-104)."""
        if self.lock_group is not None and self.lock_group.entity_ids:
            return  # locked entities don't cascade
        if t == EntityGroupType.HANDOVER:
            group.add_group(self.handover_group)
            self.handover_group = group
        elif t == EntityGroupType.LOCK:
            # LOCK outranks HANDOVER: absorb both.
            group.add_group(self.handover_group)
            group.add_group(self.lock_group)
            self.lock_group = group

    def add_to_group(self, t: EntityGroupType, entities_to_add: list[int]) -> None:
        from ..core.channel import get_channel

        if t == EntityGroupType.HANDOVER:
            if self.handover_group is None:
                self.handover_group = EntityGroup()
            group = self.handover_group
        else:
            if self.lock_group is None:
                self.lock_group = EntityGroup()
            group = self.lock_group

        for entity_id in entities_to_add:
            group.entity_ids.add(entity_id)
            ch = get_channel(entity_id)
            if ch is None:
                continue
            if ch.entity_controller is None:
                ch.logger.error("channel has no entity controller")
                continue
            # Every member shares this exact group instance.
            ch.entity_controller.cascade_group(t, group)

    def remove_from_group(self, t: EntityGroupType, entities_to_remove: list[int]) -> None:
        from ..core.channel import get_channel

        group = self.handover_group if t == EntityGroupType.HANDOVER else self.lock_group
        if group is None:
            raise ValueError(f"group {t} is nil, entityId: {self.entity_id}")
        for entity_id in entities_to_remove:
            group.entity_ids.discard(entity_id)
            # The removed entity gets a fresh empty group of its own.
            entity_ch = get_channel(entity_id)
            if entity_ch is not None and entity_ch.entity_controller is not None:
                fresh = EntityGroup()
                if t == EntityGroupType.HANDOVER:
                    entity_ch.entity_controller.handover_group = fresh
                else:
                    entity_ch.entity_controller.lock_group = fresh

    def get_handover_entities(self) -> list[int]:
        """Entities that migrate together; [] if any member is locked
        (ref: entity.go:197-224)."""
        if self.handover_group is None:
            return [self.entity_id]
        locked = self.lock_group.entity_ids if self.lock_group is not None else set()
        result = []
        for entity_id in self.handover_group.entity_ids:
            if entity_id in locked:
                return []
            result.append(entity_id)
        return result


def get_handover_entities(ch: "Channel", notifying_entity_id: int) -> Optional[dict]:
    """entityId -> channel data message for every co-migrating entity
    (ref: entity.go:226-244)."""
    from ..core.channel import get_channel

    if ch.entity_controller is None:
        ch.logger.error("channel has no entity controller")
        return None
    entities: dict[int, object] = {}
    for entity_id in ch.entity_controller.get_handover_entities():
        entity_channel = get_channel(entity_id)
        entities[entity_id] = (
            entity_channel.get_data_message() if entity_channel is not None else None
        )
    return entities


def handle_add_entity_group(ctx) -> None:
    """Owner-only (ref: entity.go:246-269)."""
    from ..protocol import spatial_pb2

    if ctx.connection is not ctx.channel.get_owner():
        logger.error("AddEntityGroupMessage only handled for the channel owner")
        return
    msg = ctx.msg
    if not isinstance(msg, spatial_pb2.AddEntityGroupMessage):
        return
    if ctx.channel.entity_controller is None:
        ctx.channel.logger.error("channel has no entity controller")
        return
    ctx.channel.entity_controller.add_to_group(
        EntityGroupType(msg.type), list(msg.EntitiesToAdd)
    )


def handle_remove_entity_group(ctx) -> None:
    """Owner-only (ref: entity.go:271-294)."""
    from ..protocol import spatial_pb2

    if ctx.connection is not ctx.channel.get_owner():
        logger.error("RemoveEntityGroupMessage only handled for the channel owner")
        return
    msg = ctx.msg
    if not isinstance(msg, spatial_pb2.RemoveEntityGroupMessage):
        return
    if ctx.channel.entity_controller is None:
        ctx.channel.logger.error("channel has no entity controller")
        return
    try:
        ctx.channel.entity_controller.remove_from_group(
            EntityGroupType(msg.type), list(msg.EntitiesToRemove)
        )
    except ValueError as e:
        ctx.channel.logger.error("failed to remove entities from group: %s", e)
