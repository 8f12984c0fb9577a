"""The port's engine adapter (channeld_tpu_torch/models/engine_adapter.py).

The counterparts of tests/test_engine_adapter.py's tests, on the port's
runtime: spawn routing, destroy, the recovery extension, the handover
test with its axis fallback and UE swap, and the two device-controller
seams, held against ``GPUSpatialController`` on ``device="cpu"``. Then
one engine-adapter world (objects spawned by SPAWN, moved by entity
channel updates, destroyed by DESTROY and spawned again) through the
JAX gateway and the port's, tick for tick, on test_torch_gateway.py's
harness: every handover, spatial entity table, adapter recovery table
and outbound stream equal.
"""

from __future__ import annotations

import pytest

from channeld_tpu_torch.core.channel import create_entity_channel, get_channel
from channeld_tpu_torch.core.message import MESSAGE_MAP, MessageContext
from channeld_tpu_torch.core.settings import global_settings
from channeld_tpu_torch.core.subscription import subscribe_to_channel
from channeld_tpu_torch.core.types import ChannelType, ConnectionType, MessageType
from channeld_tpu_torch.models import sim_pb2
from channeld_tpu_torch.models.engine_adapter import (
    MSG_DESTROY,
    MSG_SPAWN,
    RecoverableChannelDataExtension,
    check_entity_handover,
    init_message_handlers,
)
from channeld_tpu_torch.models.sim import register_sim_types
from channeld_tpu_torch.protocol import control_pb2, wire_pb2
from channeld_tpu_torch.spatial.controller import SpatialInfo, set_spatial_controller
from channeld_tpu_torch.spatial.gpu_controller import GPUSpatialController
from channeld_tpu_torch.spatial.grid import StaticGrid2DSpatialController

from test_torch_gateway import (
    JAX,
    PORT,
    FixedClock,
    Stub,
    World,
    first_difference,
    fresh_runtime,
    mod,
    port_globals,
)

START = 0x10000
E = 0x80000
SMALL_GRID = dict(WorldOffsetX=0, WorldOffsetZ=0, GridWidth=100, GridHeight=100, GridCols=2,
                  GridRows=1, ServerCols=2, ServerRows=1, ServerInterestBorderSize=1)


@pytest.fixture(autouse=True)
def runtime(tmp_path):
    with port_globals(tmp_path):
        gch = fresh_runtime(PORT)
        register_sim_types()
        init_message_handlers()
        yield gch


def stub(conn_id, kind="CLIENT"):
    return Stub(PORT, conn_id, kind)


def spawn_forward(net_id, x=None, z=None, channel_id=0, conn_id=0):
    spawn = sim_pb2.SpawnObjectMessage(channelId=channel_id)
    spawn.obj.netId = net_id
    spawn.obj.owningConnId = conn_id
    if x is not None:
        spawn.location.x = x
        spawn.location.z = z
    return wire_pb2.ServerForwardMessage(payload=spawn.SerializeToString())


def make_spatial_world():
    ctl = StaticGrid2DSpatialController()
    ctl.load_config(dict(SMALL_GRID))
    set_spatial_controller(ctl)
    servers = []
    for i in range(2):
        server = stub(10 + i, "SERVER")
        ctx = MessageContext(msg_type=MessageType.CREATE_CHANNEL,
                             msg=control_pb2.CreateChannelMessage(), connection=server)
        for ch in ctl.create_channels(ctx):
            subscribe_to_channel(server, ch, None)
        servers.append(server)
    return ctl, servers


def device_controller():
    global_settings.tpu_entity_capacity = 64
    global_settings.tpu_query_capacity = 8
    global_settings.spatial_device = "cpu"
    ctl = GPUSpatialController()
    ctl.load_config(dict(SMALL_GRID))
    assert ctl.engine.device.type == "cpu"
    return ctl


def test_spawn_rewrites_spatial_channel_and_inserts_entity():
    ctl, (server_a, server_b) = make_spatial_world()
    net_id = E + 31
    # Spawn at x=150 (cell 1) but addressed to cell 0: must be re-routed.
    ctx = MessageContext(msg_type=MSG_SPAWN,
                         msg=spawn_forward(net_id, x=150.0, z=50.0, channel_id=START),
                         connection=server_a, channel=get_channel(START), channel_id=START)
    MESSAGE_MAP[MSG_SPAWN].handler(ctx)
    dst = get_channel(START + 1)
    dst.tick_once(0)  # run the queued execute + forward
    assert net_id in dst.get_data_message().entities
    assert net_id not in get_channel(START).get_data_message().entities
    assert len([c for c in server_b.sent if c.msg_type == MSG_SPAWN]) == 1


def test_spawn_without_location_records_for_recovery():
    from channeld_tpu_torch.core.channel import create_channel

    owner = stub(1, "SERVER")
    ch = create_channel(ChannelType.SUBWORLD, owner)
    ch.init_data(None, None)
    assert isinstance(ch.data.extension, RecoverableChannelDataExtension)
    net_id = E + 32
    ctx = MessageContext(msg_type=MSG_SPAWN, msg=spawn_forward(net_id, conn_id=7),
                         connection=owner, channel=ch, channel_id=ch.id)
    MESSAGE_MAP[MSG_SPAWN].handler(ctx)
    assert net_id in ch.data.extension.spawned_objs
    recovery_data = ch.data.extension.get_recovery_data_message()
    assert recovery_data.spawnedObjects[net_id].owningConnId == 7


def test_destroy_removes_entity_and_channel():
    ctl, (server_a, server_b) = make_spatial_world()
    net_id = E + 33
    create_entity_channel(net_id, server_a)
    src = get_channel(START)
    src.get_data_message().entities[net_id].entityId = net_id
    ctx = MessageContext(
        msg_type=MSG_DESTROY,
        msg=wire_pb2.ServerForwardMessage(
            payload=sim_pb2.DestroyObjectMessage(netId=net_id).SerializeToString()),
        connection=server_a, channel=src, channel_id=START)
    MESSAGE_MAP[MSG_DESTROY].handler(ctx)
    assert net_id not in src.get_data_message().entities
    assert get_channel(net_id) is None


def test_check_entity_handover():
    a = sim_pb2.Vec3(x=1, y=2, z=3)
    b = sim_pb2.Vec3(x=1, y=2, z=3)
    moved, old, new = check_entity_handover(1, a, b)
    assert not moved
    b2 = sim_pb2.Vec3(x=5, y=2, z=3)
    moved, old, new = check_entity_handover(1, b2, a)
    assert moved and new.x == 5 and old.x == 1
    moved, old, new = check_entity_handover(1, b2, a, swap_yz=True)  # UE Z-up -> Y-up
    assert new.y == 3 and new.z == 2


def test_well_known_entity_visible_to_all_clients():
    """isWellKnown entity channels subscribe every current client and
    every later-authenticating client (1 s fan-out delay), never another
    server."""
    from channeld_tpu_torch.core import events
    from channeld_tpu_torch.core.channel import get_global_channel
    from channeld_tpu_torch.core.connection import add_connection
    from channeld_tpu_torch.protocol import spatial_pb2
    from channeld_tpu_torch.spatial.messages import handle_create_entity_channel

    from helpers import FakeTransport

    server = stub(1, "SERVER")
    early_client = add_connection(FakeTransport(), ConnectionType.CLIENT)
    ctx = MessageContext(
        msg_type=MessageType.CREATE_ENTITY_CHANNEL,
        msg=spatial_pb2.CreateEntityChannelMessage(entityId=E + 777, isWellKnown=True),
        connection=server, channel=get_global_channel(), channel_id=0)
    handle_create_entity_channel(ctx)
    ch = get_channel(E + 777)
    assert ch is not None
    assert early_client in ch.subscribed_connections
    late_client = add_connection(FakeTransport(), ConnectionType.CLIENT)
    events.auth_complete.broadcast(
        events.AuthEventData(connection=late_client, player_identifier_token="late"))
    assert late_client in ch.subscribed_connections
    assert ch.subscribed_connections[late_client].options.fanOutDelayMs == 1000
    other_server = stub(9, "SERVER")
    events.auth_complete.broadcast(
        events.AuthEventData(connection=other_server, player_identifier_token="srv"))
    assert other_server not in ch.subscribed_connections


def test_partial_position_update_merges_without_zeroing():
    notifications = []

    class Notifier:
        def notify(self, old_info, new_info, provider):
            notifications.append((old_info, new_info, provider(-1, -1)))

    data = sim_pb2.SimEntityChannelData()
    data.state.entityId = E + 1
    data.state.transform.position.x = 150.0
    data.state.transform.position.y = 5.0
    data.state.transform.position.z = 50.0
    upd = sim_pb2.SimEntityChannelData()
    upd.state.entityId = E + 1
    upd.state.transform.position.x = 30.0  # only x replicated
    data.merge(upd, None, Notifier())
    p = data.state.transform.position
    assert (p.x, p.y, p.z) == (30.0, 5.0, 50.0)
    assert len(notifications) == 1
    old_info, new_info, eid = notifications[0]
    assert (old_info.x, old_info.y, old_info.z) == (150.0, 5.0, 50.0)
    assert (new_info.x, new_info.y, new_info.z) == (30.0, 5.0, 50.0)
    assert eid == E + 1


def test_unmoved_update_fires_no_handover_check():
    notifications = []

    class Notifier:
        def notify(self, *a):
            notifications.append(a)

    data = sim_pb2.SimEntityChannelData()
    data.state.entityId = E + 2
    data.state.transform.position.x = 10.0
    upd = sim_pb2.SimEntityChannelData()
    upd.state.entityId = E + 2
    upd.state.transform.position.x = 10.0  # same spot
    upd.state.payload = b"anim-state"  # non-positional change
    data.merge(upd, None, Notifier())
    assert notifications == []
    assert data.state.payload == b"anim-state"


def test_check_entity_handover_axis_presence_fallback():
    old = sim_pb2.Vec3(x=1.0, y=2.0, z=3.0)
    new = sim_pb2.Vec3()
    new.x = 9.0  # only x replicated
    moved, _, new_info = check_entity_handover(E + 3, new, old)
    assert moved and (new_info.x, new_info.y, new_info.z) == (9.0, 2.0, 3.0)
    moved, _, _ = check_entity_handover(E + 3, sim_pb2.Vec3(), old)
    assert not moved
    moved, _, new_i = check_entity_handover(E + 3, sim_pb2.Vec3(x=1.0, y=7.0, z=3.0), old,
                                            swap_yz=True)
    assert moved and (new_i.x, new_i.y, new_i.z) == (1.0, 3.0, 7.0)


def test_spatially_owned_entity_enters_spatial_data():
    from channeld_tpu_torch.core import events

    ctl, servers = make_spatial_world()
    entity_ch = create_entity_channel(E + 4, servers[0])
    data = sim_pb2.SimEntityChannelData()
    data.state.entityId = E + 4
    data.state.transform.position.x = 150.0
    entity_ch.init_data(data, None)
    spatial_ch = get_channel(START + 1)
    spatial_ch.init_data(sim_pb2.SimSpatialChannelData(), None)
    events.entity_channel_spatially_owned.broadcast(
        events.SpatialOwnershipData(entity_channel=entity_ch, spatial_channel=spatial_ch))
    spatial_ch.tick_once(0)
    assert E + 4 in spatial_ch.get_data_message().entities


def test_handover_data_payload_trimming():
    ho = sim_pb2.SimHandoverData()
    ho.channelData.entities[E + 5].entityId = E + 5
    hctx = ho.context.add()
    hctx.obj.netId = E + 5
    hctx.clientConnId = 42
    hctx.clientState = b"inventory"
    ho.clear_payload()
    assert not ho.HasField("channelData")
    assert ho.context[0].clientConnId == 42
    assert ho.context[0].clientState == b"inventory"


def test_gpu_handover_uses_true_old_position():
    """The device-detected crossing hands the real previous position to
    the orchestration, not a synthetic cell centre."""
    ctl = device_controller()
    set_spatial_controller(ctl)
    seen = []
    orig_notify = StaticGrid2DSpatialController.notify_crossings

    def spy(self, crossings):
        seen.extend((old, new) for old, new, _p in crossings)

    StaticGrid2DSpatialController.notify_crossings = spy
    try:
        eid = E + 6
        ctl.track_entity(eid, SpatialInfo(40.0, 0.0, 60.0))
        ctl.tick()
        ctl.notify(SpatialInfo(40.0, 0.0, 60.0), SpatialInfo(170.0, 0.0, 30.0),
                   lambda s, d: eid)
        ctl.tick()
        assert len(seen) == 1
        old_info, new_info = seen[0]
        assert (old_info.x, old_info.z) == (40.0, 60.0)  # true, not (50, 50)
        assert (new_info.x, new_info.z) == (170.0, 30.0)
    finally:
        StaticGrid2DSpatialController.notify_crossings = orig_notify


def test_stationary_entity_still_observed_by_device_controller():
    ctl = device_controller()
    data = sim_pb2.SimEntityChannelData()
    data.state.entityId = E + 7
    data.state.transform.position.x = 150.0
    data.state.transform.position.z = 50.0
    upd = sim_pb2.SimEntityChannelData()
    upd.state.entityId = E + 7
    upd.state.transform.position.x = 150.0  # unchanged position
    upd.state.transform.position.z = 50.0
    data.merge(upd, None, ctl)
    assert ctl.engine.entity_count() == 1
    info = ctl._last_positions[E + 7]
    assert (info.x, info.z) == (150.0, 50.0)
    assert E + 7 in ctl._providers


def test_first_stationary_observation_seeds_handover_baseline():
    ctl = device_controller()
    eid = E + 8
    ctl.observe_entity(eid, SpatialInfo(40.0, 0.0, 60.0))  # cell 0, no tick yet
    ctl.notify(SpatialInfo(40.0, 0.0, 60.0), SpatialInfo(170.0, 0.0, 30.0),
               lambda s, d: eid)  # crossing before the first engine tick
    result = ctl.engine.tick()
    assert ctl.engine.handover_list(result) == [(eid, 0, 1)]


# ---- an engine-adapter world through both gateways ---------------------------


class AdapterWorld(World):
    """World's servers, followers and subscriptions on
    config/spatial_tpu_4x4.json, with the objects coming and going
    through the engine adapter. The master creates each object's entity
    channel in GLOBAL (ownership passes to the cell's server) and spawns
    it by SPAWN (103) with its location, which routes to the cell's
    spatial channel. Objects move by entity channel updates; a storm
    gathers an eighth of them in one cell (tick 3) and scatters them
    (tick 5); at tick 6 a tenth are destroyed by DESTROY (104) on their
    spatial channels and spawned again at tick 7. Every eighth object is
    a non-spatial one, spawned on GLOBAL without a location: the
    adapter's recovery table holds it."""

    def _build(self, entities: int) -> None:
        from random import Random

        pkg, ctl = self.pkg, self.ctl
        P = lambda name: mod(pkg, name)  # noqa: E731
        self.P, self.types, self.sub = P, P("core.types"), P("core.subscription")
        channel_mod, control_pb2 = P("core.channel"), P("protocol.control_pb2")
        P("models.engine_adapter").init_message_handlers()
        conns = P("core.connection")._all_connections
        self.stubs: list = []

        def stub_of(conn_id, kind):
            c = Stub(pkg, conn_id, kind)
            conns[conn_id] = c
            self.stubs.append(c)
            return c

        self.master = master = stub_of(1, "SERVER")
        gch = self.gch = channel_mod.get_global_channel()
        gch.set_owner(master)
        gch.init_data(None, None)  # the adapter's recovery extension
        self.sub.subscribe_to_channel(master, gch, None)
        for i in range(4):
            server = stub_of(2 + i, "SERVER")
            ctx = P("core.message").MessageContext(
                msg_type=self.types.MessageType.CREATE_CHANNEL,
                msg=control_pb2.CreateChannelMessage(), connection=server)
            for ch in ctl.create_channels(ctx):
                self.sub.subscribe_to_channel(server, ch, None)
        self.spatial = sorted(cid for cid, ch in channel_mod.all_channels().items()
                              if ch.channel_type == self.types.ChannelType.SPATIAL)
        rng = self.rng = Random(20261017)
        x0, z0 = ctl.world_offset_x + 1.0, ctl.world_offset_z + 1.0
        x1 = ctl.world_offset_x + ctl.grid_width * ctl.grid_cols - 1.0
        z1 = ctl.world_offset_z + ctl.grid_height * ctl.grid_rows - 1.0
        self.bounds = (x0, z0, x1, z1)
        self.estart = P("core.settings").global_settings.entity_channel_id_start
        self.positions: dict[int, tuple[float, float]] = {}
        self.props: list[int] = []
        for i in range(entities):
            eid = self.estart + 1 + i
            if i % 8 == 7:
                self.spawn_prop(eid)
            else:
                self.spawn(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))
        self.entity_ids = list(self.positions)
        ops = P("ops.spatial_ops")
        for i in range(6):  # followers: spheres and cones
            client = stub_of(100 + i, "CLIENT")
            eid = self.entity_ids[rng.randrange(len(self.entity_ids))]
            if i % 2:
                ctl.register_follow_interest(client, eid, ops.AOI_CONE, extent=(70.0, 0.0),
                                             direction=(1.0, 0.5), angle=0.7)
            else:
                ctl.register_follow_interest(client, eid, ops.AOI_SPHERE, extent=(40.0, 0.0))
        for i in range(6):  # plain subscriptions at 33-200 ms
            client = stub_of(200 + i, "CLIENT")
            for cid in rng.sample(self.spatial, 3):
                opts = control_pb2.ChannelSubscriptionOptions(
                    fanOutIntervalMs=rng.choice((33, 50, 100, 200)), fanOutDelayMs=0)
                self.sub.subscribe_to_channel(client, channel_mod.get_channel(cid), opts)

    def forward(self, msg_type: int, channel, payload: bytes) -> None:
        P = self.P
        ctx = P("core.message").MessageContext(
            msg_type=msg_type, msg=P("protocol.wire_pb2").ServerForwardMessage(payload=payload),
            connection=self.master if channel is self.gch else channel.get_owner(),
            channel=channel, channel_id=channel.id)
        P("core.message").MESSAGE_MAP[msg_type].handler(ctx)

    def spawn(self, eid: int, x: float, z: float) -> None:
        P = self.P
        sim_pb2, spatial_pb2 = P("models.sim_pb2"), P("protocol.spatial_pb2")
        d = sim_pb2.SimEntityChannelData()
        d.state.entityId = eid
        d.state.transform.position.x = x
        d.state.transform.position.z = z
        ctx = P("core.message").MessageContext(
            msg_type=self.types.MessageType.CREATE_ENTITY_CHANNEL,
            msg=spatial_pb2.CreateEntityChannelMessage(
                entityId=eid, data=P("utils.anyutil").pack_any(d)),
            connection=self.master, channel=self.gch, channel_id=0)
        P("spatial.messages").handle_create_entity_channel(ctx)
        spawn = sim_pb2.SpawnObjectMessage(channelId=0)
        spawn.obj.netId = eid
        spawn.obj.owningConnId = P("core.channel").get_channel(eid).get_owner().id
        spawn.location.x, spawn.location.z = x, z
        self.forward(103, self.gch, spawn.SerializeToString())
        self.positions[eid] = (x, z)

    def spawn_prop(self, eid: int) -> None:
        spawn = self.P("models.sim_pb2").SpawnObjectMessage(channelId=0)
        spawn.obj.netId = eid
        spawn.obj.owningConnId = self.master.id
        self.forward(103, self.gch, spawn.SerializeToString())
        self.props.append(eid)

    def destroy(self, eid: int, channel) -> None:
        payload = self.P("models.sim_pb2").DestroyObjectMessage(netId=eid).SerializeToString()
        self.forward(104, channel, payload)

    def cell_of(self, eid: int):
        for cid in self.spatial:
            ch = self.P("core.channel").get_channel(cid)
            if eid in ch.get_data_message().entities:
                return ch
        return None

    def drive(self, t: int) -> None:
        x0, z0, x1, z1 = self.bounds
        rng = self.rng
        moving = list(self.entity_ids)
        if t == 3:
            self.crowd = rng.sample(moving, len(moving) // 8)
            for eid in self.crowd:
                self.move(eid, rng.uniform(-45.0, -5.0), rng.uniform(5.0, 45.0))
        elif t == 5:
            for eid in self.crowd:
                self.move(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))
        elif t == 6:
            self.gone = rng.sample(moving, len(moving) // 10)
            for eid in self.gone:
                self.destroy(eid, self.cell_of(eid))
                self.entity_ids.remove(eid)
                del self.positions[eid]
            self.destroy(self.props[0], self.gch)
        elif t == 7:
            for eid in self.gone:
                self.spawn(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))
                self.entity_ids.append(eid)
        crowd = set(self.crowd) if 3 <= t <= 5 else set()
        for eid in self.entity_ids:
            if eid in crowd or (t == 7 and eid in self.gone):
                continue
            x, z = self.positions[eid]
            self.move(eid, min(max(x + rng.uniform(-15, 15), x0), x1),
                      min(max(z + rng.uniform(-15, 15), z0), z1))

    def tick(self, t: int) -> dict:
        obs = super().tick(t)
        ext = self.gch.data.extension
        obs["recovery"] = sorted((k, v.SerializeToString(deterministic=True))
                                 for k, v in ext.spawned_objs.items())
        return obs


def test_engine_adapter_world_through_both_gateways(monkeypatch):
    """160 objects (20 of them non-spatial), 10 ticks, through the JAX
    gateway's TPUSpatialController and the port's GPUSpatialController
    on the CPU: every tick's handovers, spatial entity tables, changed
    query rows, due subscriptions, adapter recovery table and outbound
    stream equal exactly."""
    clock = FixedClock(monkeypatch)
    legs = {}
    for pkg in (JAX, PORT):
        world = AdapterWorld(pkg, clock, 160, sim=False)
        legs[pkg] = [world.tick(t) for t in range(10)]
        assert len(world.gch.data.extension.spawned_objs) == 19
    for t, (a, b) in enumerate(zip(legs[JAX], legs[PORT])):
        assert a == b, f"tick {t}: {first_difference(a, b)}"
    assert sum(len(rows) for o in legs[PORT] for rows in o["handovers"]) > 0
