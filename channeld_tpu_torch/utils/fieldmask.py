"""FieldMask-style filtering of protobuf messages.

The reference uses fmutils.Filter to trim channel-data updates to each
subscriber's dataFieldMasks before fan-out (ref: pkg/channeld/data.go:293-318).
Semantics: an empty mask list means "send everything"; otherwise only the
named paths survive. Paths may be nested ("a.b.c"); for map fields a path
segment may name a map key ("players.alice").
"""

from __future__ import annotations

from google.protobuf.message import Message


def _build_tree(paths: list[str]) -> dict:
    tree: dict = {}
    for path in paths:
        node = tree
        for seg in path.split("."):
            node = node.setdefault(seg, {})
    return tree


def filter_fields(msg: Message, masks: list[str]) -> None:
    """Prune ``msg`` in place so only masked paths remain."""
    if not masks:
        return
    _filter_node(msg, _build_tree(masks))


def _filter_node(msg: Message, tree: dict) -> None:
    for fd in msg.DESCRIPTOR.fields:
        sub = tree.get(fd.name)
        if sub is None:
            msg.ClearField(fd.name)
        elif sub:
            # Descend only into singular sub-messages and maps; for maps the
            # next segments are keys to keep.
            if fd.type == fd.TYPE_MESSAGE:
                if fd.message_type.GetOptions().map_entry:
                    field_map = getattr(msg, fd.name)
                    keep = set(sub.keys())
                    for key in list(field_map.keys()):
                        if str(key) not in keep:
                            del field_map[key]
                elif not fd.is_repeated:
                    if msg.HasField(fd.name):
                        _filter_node(getattr(msg, fd.name), sub)
                # Repeated message fields: a mask naming the field keeps it
                # whole; deeper per-element masks aren't supported (same as
                # FieldMask semantics for repeated fields).
