"""The port's unrealpb compat family (channeld_tpu_torch/compat): the
counterparts of tests/test_unrealpb_compat.py's tests on the port's
runtime. Wire-pinned field numbers (each message's bytes also equal to
the same message built with the JAX package's module), the hand-written
extension behaviors, and the UE SPAWN/DESTROY handler semantics
(ref: pkg/unrealpb/unreal_common.proto:55-433, extension.go:10-94,
pkg/unreal/message.go:20-196)."""

import struct

import pytest

from channeld_tpu_torch.compat import unrealpb_pb2 as unrealpb
from channeld_tpu_torch.core.channel import create_entity_channel, get_channel
from channeld_tpu_torch.core.message import MESSAGE_MAP, MessageContext
from channeld_tpu_torch.core.subscription import subscribe_to_channel
from channeld_tpu_torch.core.types import ConnectionType, MessageType
from channeld_tpu_torch.protocol import control_pb2, wire_pb2
from channeld_tpu_torch.spatial.controller import set_spatial_controller
from channeld_tpu_torch.spatial.grid import StaticGrid2DSpatialController

from channeld_tpu.compat import unrealpb_pb2 as jax_unrealpb
from test_torch_gateway import PORT, Stub, fresh_runtime, port_globals

START = 0x10000
E = 0x80000
MSG_SPAWN, MSG_DESTROY = 103, 104  # unrealpb.MessageType SPAWN, DESTROY
# The pb2 classes are the JAX package's too (one descriptor pool), and
# each package's compat/unreal.py sets its methods on them when it is
# first imported: the port's are held in place for each test only.
EXTENSION_METHODS = ((unrealpb.SpatialChannelData, "merge", "_spatial_merge"),
                     (unrealpb.SpatialChannelData, "add_entity", "_spatial_add_entity"),
                     (unrealpb.SpatialChannelData, "remove_entity", "_spatial_remove_entity"),
                     (unrealpb.HandoverData, "clear_payload", "_handover_clear_payload"))


@pytest.fixture(autouse=True)
def runtime(tmp_path):
    saved = [(cls, name, cls.__dict__.get(name)) for cls, name, _ in EXTENSION_METHODS]
    from channeld_tpu_torch.compat import unreal

    for cls, name, fn in EXTENSION_METHODS:
        setattr(cls, name, getattr(unreal, fn))
    try:
        with port_globals(tmp_path):
            gch = fresh_runtime(PORT)
            unreal.register_unreal_types()
            yield gch
    finally:
        for cls, name, fn in saved:
            if fn is None:
                delattr(cls, name)
            else:
                setattr(cls, name, fn)


def StubConnection(conn_id, conn_type=ConnectionType.CLIENT):
    return Stub(PORT, conn_id, conn_type.name)


def same_wire(port_msg, build) -> bytes:
    """The port message's bytes, held equal to the same message built
    with the JAX package's module."""
    jax_msg = build(jax_unrealpb)
    assert port_msg.SerializeToString() == jax_msg.SerializeToString()
    return port_msg.SerializeToString()


# ---- wire-format pinning (field numbers ARE the interop contract) ---------


def tag(field: int, wire: int) -> bytes:
    return bytes([(field << 3) | wire])


def varint(v: int) -> bytes:
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        out += bytes([b | (0x80 if v else 0)])
        if not v:
            return out


def ld(field: int, payload: bytes) -> bytes:
    return tag(field, 2) + varint(len(payload)) + payload


def f32(field: int, v: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", v)


def test_spawn_message_wire_bytes_match_reference_numbering():
    """SpawnObjectMessage: obj=1, channelId=2, localRole=3, location=5;
    UnrealObjectRef.netGUID=1 (ref: unreal_common.proto:92-99, :61-73)."""
    m = unrealpb.SpawnObjectMessage()
    m.obj.netGUID = 77
    m.channelId = 3
    m.localRole = 2
    m.location.x = 1.5
    m.location.y = 2.5
    m.location.z = 10.0
    expected = (
        ld(1, tag(1, 0) + varint(77))        # obj{netGUID=77}
        + tag(2, 0) + varint(3)              # channelId
        + tag(3, 0) + varint(2)              # localRole
        + ld(5, f32(1, 1.5) + f32(2, 2.5) + f32(3, 10.0))  # location
    )
    assert m.SerializeToString() == expected

    def jax_spawn(pb):
        j = pb.SpawnObjectMessage(channelId=3, localRole=2)
        j.obj.netGUID = 77
        j.location.x, j.location.y, j.location.z = 1.5, 2.5, 10.0
        return j

    assert same_wire(m, jax_spawn) == expected


def test_spatial_and_handover_wire_bytes():
    """SpatialChannelData.entities=1 (map<uint32, SpatialEntityState>),
    SpatialEntityState{objRef=1, removed=2, entityData=3}; HandoverData
    {context=1, channelData=2}; DestroyObjectMessage{netId=1, reason=2}
    (ref: unreal_common.proto:101-147)."""
    s = unrealpb.SpatialChannelData()
    s.entities[77].objRef.netGUID = 77
    s.entities[77].removed = True
    entry = ld(1, tag(1, 0) + varint(77)) + tag(2, 0) + varint(1)
    expected = ld(1, tag(1, 0) + varint(77) + ld(2, entry))
    assert s.SerializeToString() == expected

    def jax_spatial(pb):
        j = pb.SpatialChannelData()
        j.entities[77].objRef.netGUID = 77
        j.entities[77].removed = True
        return j

    assert same_wire(s, jax_spatial) == expected

    h = unrealpb.HandoverData()
    h.context.add().obj.netGUID = 5
    h.context[0].clientConnId = 9
    ctx_bytes = ld(1, tag(1, 0) + varint(5)) + tag(2, 0) + varint(9)
    assert h.SerializeToString() == ld(1, ctx_bytes)

    def jax_handover(pb):
        j = pb.HandoverData()
        j.context.add().obj.netGUID = 5
        j.context[0].clientConnId = 9
        return j

    same_wire(h, jax_handover)

    d = unrealpb.DestroyObjectMessage(netId=300, reason=2)
    assert d.SerializeToString() == (
        tag(1, 0) + varint(300) + tag(2, 0) + varint(2)
    )
    same_wire(d, lambda pb: pb.DestroyObjectMessage(netId=300, reason=2))


def test_character_state_and_class_path_option():
    """Replication states keep their numbers (CharacterState.rootMotion=2,
    movementMode=5) and the unreal_class_path message option (50001)
    resolves (ref: unreal_common.proto:154-158, :286-297)."""
    c = unrealpb.CharacterState(movementMode=4, bIsCrouched=True)
    assert c.SerializeToString() == (
        tag(5, 0) + varint(4) + tag(6, 0) + varint(1)
    )
    same_wire(c, lambda pb: pb.CharacterState(movementMode=4, bIsCrouched=True))
    opts = unrealpb.CharacterState.DESCRIPTOR.GetOptions()
    assert opts.Extensions[unrealpb.unreal_class_path] == \
        "/Script/Engine.Character"


def test_fvector_to_spatial_info_swaps_y_z():
    """UE Z-up -> gateway Y-up (ref: extension.go:11-24)."""
    from channeld_tpu_torch.compat.unreal import to_spatial_info

    v = unrealpb.FVector(x=1.0, y=2.0, z=3.0)
    info = to_spatial_info(v)
    assert (info.x, info.y, info.z) == (1.0, 3.0, 2.0)
    # Absent axes read as 0 (proto3 optional presence).
    info = to_spatial_info(unrealpb.FVector(x=5.0))
    assert (info.x, info.y, info.z) == (5.0, 0.0, 0.0)


# ---- extension behaviors --------------------------------------------------


def test_spatial_channel_data_merge_semantics():
    """removed -> entry dropped AND entity channel removed; existing
    entries never merged over; new entries added
    (ref: extension.go:37-63)."""
    eid = E + 4
    entity_ch = create_entity_channel(eid, None)
    assert get_channel(eid) is entity_ch

    dst = unrealpb.SpatialChannelData()
    dst.entities[eid].objRef.netGUID = eid
    dst.entities[eid].objRef.classPath = "/Game/Old"
    src = unrealpb.SpatialChannelData()
    src.entities[eid].objRef.classPath = "/Game/New"
    src.entities[E + 5].objRef.netGUID = E + 5
    dst.merge(src, None, None)
    # Existing entry untouched (add-if-absent), new entry added.
    assert dst.entities[eid].objRef.classPath == "/Game/Old"
    assert (E + 5) in dst.entities

    removal = unrealpb.SpatialChannelData()
    removal.entities[eid].removed = True
    dst.merge(removal, None, None)
    assert eid not in dst.entities
    assert get_channel(eid) is None or get_channel(eid).is_removing()


def test_handover_clear_payload():
    h = unrealpb.HandoverData()
    h.context.add().obj.netGUID = 7
    h.channelData.type_url = "type.googleapis.com/unrealpb.SpatialChannelData"
    h.clear_payload()
    assert not h.HasField("channelData")
    assert len(h.context) == 1  # identity context survives


# ---- SPAWN / DESTROY handlers over a spatial world ------------------------


def make_spatial_world():
    ctl = StaticGrid2DSpatialController()
    ctl.load_config(dict(WorldOffsetX=0, WorldOffsetZ=0, GridWidth=100,
                         GridHeight=100, GridCols=2, GridRows=1, ServerCols=2,
                         ServerRows=1, ServerInterestBorderSize=1))
    set_spatial_controller(ctl)
    servers = []
    for i in range(2):
        server = StubConnection(10 + i, ConnectionType.SERVER)
        ctx = MessageContext(
            msg_type=MessageType.CREATE_CHANNEL,
            msg=control_pb2.CreateChannelMessage(),
            connection=server,
        )
        for ch in ctl.create_channels(ctx):
            subscribe_to_channel(server, ch, None)
        servers.append(server)
    for ch_id in (START, START + 1):
        get_channel(ch_id).init_data(unrealpb.SpatialChannelData(), None)
    return ctl, servers


def spawn_forward(net_guid, *, x=None, y=None, channel_id=0):
    """UE coordinates: y is the ground plane's second axis (Z-up world)."""
    spawn = unrealpb.SpawnObjectMessage(channelId=channel_id)
    spawn.obj.netGUID = net_guid
    if x is not None:
        spawn.location.x = x
        spawn.location.y = y  # maps to gateway z after the swap
        spawn.location.z = 50.0  # UE height; ignored by the 2D grid
    return wire_pb2.ServerForwardMessage(payload=spawn.SerializeToString())


def test_ue_spawn_reroutes_and_lands_in_spatial_channel_data():
    ctl, (server_a, server_b) = make_spatial_world()
    net_guid = E + 31
    # Spawned at UE (x=150, y=50): gateway cell 1, though addressed to 0.
    ctx = MessageContext(
        msg_type=MSG_SPAWN,
        msg=spawn_forward(net_guid, x=150.0, y=50.0, channel_id=START),
        connection=server_a,
        channel=get_channel(START),
        channel_id=START,
    )
    MESSAGE_MAP[MSG_SPAWN].handler(ctx)
    dst = get_channel(START + 1)
    dst.tick_once(0)  # run the queued execute + forward
    data = dst.get_data_message()
    assert net_guid in data.entities
    assert data.entities[net_guid].objRef.netGUID == net_guid
    # The src channel data must NOT hold it.
    assert net_guid not in get_channel(START).get_data_message().entities


def test_ue_spawn_sets_entity_channel_obj_ref():
    ctl, (server_a, _) = make_spatial_world()
    net_guid = E + 40

    class EntityData:
        pass

    entity_ch = create_entity_channel(net_guid, server_a)
    # Entity channel data carrying an objRef field (the
    # EntityChannelDataWithObjRef duck type): use SpatialEntityState,
    # which has exactly that shape.
    entity_ch.init_data(unrealpb.SpatialEntityState(), None)
    ctx = MessageContext(
        msg_type=MSG_SPAWN,
        msg=spawn_forward(net_guid, x=50.0, y=50.0, channel_id=START),
        connection=server_a,
        channel=get_channel(START),
        channel_id=START,
    )
    MESSAGE_MAP[MSG_SPAWN].handler(ctx)
    get_channel(START).tick_once(0)
    entity_ch.tick_once(0)
    assert entity_ch.get_data_message().objRef.netGUID == net_guid


def test_ue_destroy_rejects_zero_net_id():
    """A defaulted netId must never resolve to (and remove) GLOBAL."""
    from channeld_tpu_torch.core.channel import get_global_channel

    ctl, (server_a, _) = make_spatial_world()
    ctx = MessageContext(
        msg_type=MSG_DESTROY,
        msg=wire_pb2.ServerForwardMessage(
            payload=unrealpb.DestroyObjectMessage(reason=1).SerializeToString()
        ),
        connection=server_a,
        channel=get_channel(START),
        channel_id=START,
    )
    MESSAGE_MAP[MSG_DESTROY].handler(ctx)
    assert not get_global_channel().is_removing()


def test_spatially_owned_entity_lands_in_spatial_data():
    """Entity channel becomes spatially owned -> its objRef is inserted
    into the spatial channel's entity table (message.go:205-215)."""
    from channeld_tpu_torch.core import events

    ctl, (server_a, _) = make_spatial_world()
    net_guid = E + 61
    entity_ch = create_entity_channel(net_guid, server_a)
    state = unrealpb.SpatialEntityState()
    state.objRef.netGUID = net_guid
    state.objRef.classPath = "/Game/BP_Owned"
    entity_ch.init_data(state, None)
    spatial_ch = get_channel(START)
    events.entity_channel_spatially_owned.broadcast(
        events.SpatialOwnershipData(
            entity_channel=entity_ch, spatial_channel=spatial_ch
        )
    )
    spatial_ch.tick_once(0)
    data = spatial_ch.get_data_message()
    assert net_guid in data.entities
    assert data.entities[net_guid].objRef.classPath == "/Game/BP_Owned"


def test_global_world_spawn_recovery_refs():
    """Non-spatial worlds: spawns/destroys maintain the recovery
    extension's objRefs (recovery.go:10-40 + ChannelRecoveryData)."""
    from channeld_tpu_torch.compat.unreal import UnrealRecoverableExtension
    from channeld_tpu_torch.core.channel import get_global_channel

    gch = get_global_channel()
    gch.init_data(unrealpb.SpatialChannelData(), None)  # any data msg
    server = StubConnection(21, ConnectionType.SERVER)
    for guid in (E + 70, E + 71):
        ctx = MessageContext(
            msg_type=MSG_SPAWN,
            msg=spawn_forward(guid),
            connection=server,
            channel=gch,
            channel_id=0,
        )
        MESSAGE_MAP[MSG_SPAWN].handler(ctx)
    ext = gch.data.extension
    assert isinstance(ext, UnrealRecoverableExtension)
    assert set(ext.obj_refs) == {E + 70, E + 71}
    recovery = ext.get_recovery_data_message()
    assert recovery.objRefs[E + 70].netGUID == E + 70

    ctx = MessageContext(
        msg_type=MSG_DESTROY,
        msg=wire_pb2.ServerForwardMessage(
            payload=unrealpb.DestroyObjectMessage(
                netId=E + 70, reason=0
            ).SerializeToString()
        ),
        connection=server,
        channel=gch,
        channel_id=0,
    )
    MESSAGE_MAP[MSG_DESTROY].handler(ctx)
    assert set(ext.obj_refs) == {E + 71}


def test_ue_destroy_removes_entity_and_channel():
    ctl, (server_a, _) = make_spatial_world()
    net_guid = E + 52
    ch = get_channel(START)
    ch.get_data_message().entities[net_guid].objRef.netGUID = net_guid
    entity_ch = create_entity_channel(net_guid, server_a)

    destroy = unrealpb.DestroyObjectMessage(netId=net_guid, reason=1)
    ctx = MessageContext(
        msg_type=MSG_DESTROY,
        msg=wire_pb2.ServerForwardMessage(payload=destroy.SerializeToString()),
        connection=server_a,
        channel=ch,
        channel_id=START,
    )
    MESSAGE_MAP[MSG_DESTROY].handler(ctx)
    assert net_guid not in ch.get_data_message().entities
    assert get_channel(net_guid) is None or get_channel(net_guid).is_removing()


def test_unitypb_types_resolve_from_any():
    """The Unity family (channeldpb.Vector3f/4f, TransformState — ref:
    pkg/channeldpb/unity_common.proto) registers in the symbol db so a
    Unity SDK's Any payloads resolve by type URL on this gateway."""
    from channeld_tpu_torch.compat import unitypb_pb2
    from channeld_tpu_torch.utils.anyutil import pack_any, unpack_any

    t = unitypb_pb2.TransformState()
    t.position.x = 1.5
    t.position.z = -3.25
    t.rotation.w = 1.0
    t.scale.y = 2.0
    packed = pack_any(t)
    assert packed.type_url.endswith("channeldpb.TransformState")
    out = unpack_any(packed)
    assert type(out).DESCRIPTOR.full_name == "channeldpb.TransformState"
    assert out.position.x == 1.5 and out.position.z == -3.25
    assert out.rotation.w == 1.0 and out.scale.y == 2.0
    # removed-marker field number matches the reference (field 1).
    t2 = unitypb_pb2.TransformState(removed=True)
    assert t2.SerializeToString() == b"\x08\x01"
