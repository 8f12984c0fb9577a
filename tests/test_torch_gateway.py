"""The port's gateway against the JAX gateway, tick for tick.

The same seeded world, scripted through the in-process API with stub
connections and a fixed clock, runs once through ``channeld_tpu``'s
``TPUSpatialController`` (JAX on the CPU) and once through
``channeld_tpu_torch``'s ``GPUSpatialController`` on ``device="cpu"``.
The host layers of the two packages are the same code (the port's are
copies, held byte-identical by ``tests/test_torch_copies.py``), so every
difference is the device planes': each tick's handovers, spatial entity
tables, outbound messages, changed query rows and epochs, due
subscriptions and guard ledgers must be equal exactly. The sim case's
agent columns are held within the per-tick bound of
``tests/test_torch_sim.py`` (ULPS ulps of their scale per sim pass).

Also here: the port's gateway restores a WAL and snapshot journaled by
the JAX gateway (same channels, entity tables, placement ledger, and a
bit-identical sim census).

The helpers (``Stub``, ``fresh_runtime``, ``port_globals``) are the
port's counterparts of ``tests/helpers.py`` and of conftest's
``_fresh_globals``, which touch only the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import os
import time
from random import Random

import numpy as np
import pytest

from test_torch_sim import tol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, JAX = "channeld_tpu_torch", "channeld_tpu"
CONFIG_4X4 = os.path.join(REPO, "config", "spatial_tpu_4x4.json")
TICK_S = 0.033


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ---- the port's test runtime ---------------------------------------------


class Stub:
    """A connection stub of one package: the surface channels touch
    (``tests/helpers.StubConnection``'s), with that package's enums."""

    def __init__(self, pkg: str, conn_id: int, conn_type: str = "CLIENT"):
        types = mod(pkg, "core.types")
        self.pkg = pkg
        self.id = conn_id
        self.connection_type = types.ConnectionType[conn_type]
        self.state = types.ConnectionState.AUTHENTICATED
        self._closing = types.ConnectionState.CLOSING
        self.pit = f"pit{conn_id}"
        self.recover_handle = None
        self.spatial_subscriptions: dict[int, object] = {}
        self.fsm_disallowed_counter = 0
        self.sent: list = []
        self.logger = mod(pkg, "utils.logger").get_logger(f"stub.{conn_id}")

    def is_closing(self) -> bool:
        return self.state >= self._closing

    def close(self, unexpected: bool = False) -> None:
        self.state = self._closing

    def send(self, ctx) -> None:
        self.sent.append(ctx)

    def should_recover(self) -> bool:
        return self.recover_handle is not None

    def on_authenticated(self, pit: str) -> None:
        self.pit = pit

    def has_interest_in(self, ch_id: int) -> bool:
        return ch_id in self.spatial_subscriptions

    def has_authority_over(self, ch) -> bool:
        gch = mod(self.pkg, "core.channel").get_global_channel()
        if gch is not None and gch.get_owner() is self:
            return True
        return ch.get_owner() is self

    def remote_addr(self):
        return ("127.0.0.1", 10000 + self.id)

    def remote_ip(self):
        return "127.0.0.1"

    def disconnect(self):
        pass


def fresh_runtime(pkg: str = PORT):
    """Reset one package's registries and create its GLOBAL channel
    (``tests/helpers.fresh_runtime`` for either package)."""
    channel_mod = mod(pkg, "core.channel")
    mod(pkg, "core.channel").reset_channels()
    mod(pkg, "core.connection").reset_connections()
    mod(pkg, "core.data").reset_registries()
    mod(pkg, "core.ddos").reset_ddos()
    mod(pkg, "core.connection_recovery").reset_recovery()
    mod(pkg, "spatial.controller").reset_spatial_controller()
    mod(pkg, "core.overload").reset_overload()
    mod(pkg, "core.message").init_message_map()
    channel_mod.init_channels()
    return channel_mod.get_global_channel()


@contextlib.contextmanager
def port_globals(tmp_path):
    """The port's counterpart of conftest's ``_fresh_globals``: the
    flight recorder dumps under ``tmp_path``, thread-affinity checks are
    armed, and every process-wide singleton is reset afterwards; a
    recorded affinity violation fails the test."""
    from channeld_tpu_torch.chaos import disarm
    from channeld_tpu_torch.core import device_guard, events, opshttp, overload
    from channeld_tpu_torch.core import settings, slo, tracing, wal
    from channeld_tpu_torch.core.affinity import affinity
    from channeld_tpu_torch.federation import obs
    from channeld_tpu_torch.sim import plane as sim_plane
    from channeld_tpu_torch.spatial import balancer, partition

    tracing.recorder.configure(dump_path=str(tmp_path))
    affinity.arm(strict=False)
    try:
        yield
    finally:
        violations = list(affinity.violations)
        affinity.disarm()
        disarm()
        events.reset_all()
        settings.reset_global_settings()
        overload.reset_overload()
        balancer.reset_balancer()
        partition.reset_partition()
        device_guard.reset_device_guard()
        tracing.reset_tracing()
        wal.reset_wal()
        slo.reset_slo()
        obs.reset_fleet_obs()
        opshttp.reset_ops()
        sim_plane.reset_sim()
        mod(PORT, "spatial.controller").reset_spatial_controller()
    assert not violations, f"runtime thread-affinity violations: {violations}"


@pytest.fixture(autouse=True)
def _port_runtime(tmp_path):
    with port_globals(tmp_path):
        yield


class FixedClock:
    """``time.monotonic``/``monotonic_ns`` for a run: starts at one
    instant and moves only when the script advances it, so both
    gateways see the same channel times, engine clock and tick costs."""

    def __init__(self, monkeypatch, start_s: float = 1000.0):
        self.ns = int(start_s * 1e9)
        monkeypatch.setattr(time, "monotonic", lambda: self.ns / 1e9)
        monkeypatch.setattr(time, "monotonic_ns", lambda: self.ns)

    def reset(self, start_s: float = 1000.0) -> None:
        self.ns = int(start_s * 1e9)

    def advance(self, seconds: float) -> None:
        self.ns += int(round(seconds * 1e9))


# ---- the scripted world ----------------------------------------------------


def due_slots(pkg: str, eng, result) -> list[int]:
    """The tick's due subscription slots, in slot order, from what the
    package's guard already fetched."""
    if pkg == JAX:
        due = np.unpackbits(np.asarray(result["due_packed"]))
    else:
        due = eng.consume(result)[3]
    return np.nonzero(due)[0].tolist()


def wire(ctx) -> tuple:
    body = ctx.raw_body
    if body is None:
        body = ctx.msg.SerializeToString(deterministic=True) if ctx.msg is not None else b""
    return ctx.msg_type, ctx.channel_id, bytes(body)


class World:
    """config/spatial_tpu_4x4.json's geometry with 2x2 servers and a
    master, entities on a seeded random walk across cell edges (one burst
    overflows the handover rows), followers with sphere and cone
    queries, server sensors and subscriptions at 33-200 ms, on one
    package's gateway."""

    def __init__(self, pkg: str, clock: FixedClock, entities: int, sim: bool):
        self.pkg, self.clock = pkg, clock
        clock.reset()
        fresh_runtime(pkg)
        s = mod(pkg, "core.settings").global_settings
        s.tpu_entity_capacity = 1024
        s.tpu_query_capacity = 64
        # Ample for a JAX compile inside a step; the same on both legs.
        s.device_step_deadline_s = 60.0
        if pkg == PORT:
            s.spatial_device = "cpu"
        if sim:
            s.sim_enabled = True
            s.sim_agents = 64
            s.sim_census_every_ticks = 5
        mod(pkg, "models.sim").register_sim_types()
        sc = mod(pkg, "spatial.controller")
        sc.init_spatial_controller(CONFIG_4X4)
        self.ctl = ctl = sc.get_spatial_controller()
        self.eng = ctl.engine
        # A small handover row budget, so the burst overflows it and the
        # overflow re-detects on the next tick.
        self.eng.max_handovers = 24
        self.handovers: list = []
        handover_list = self.eng.handover_list

        def recorded(result):
            rows = handover_list(result)
            self.handovers.append(rows)
            return rows

        self.eng.handover_list = recorded
        self._build(entities)

    def _build(self, entities: int) -> None:
        pkg, ctl = self.pkg, self.ctl
        P = lambda name: mod(pkg, name)  # noqa: E731
        types, sub = P("core.types"), P("core.subscription")
        control_pb2, sim_pb2 = P("protocol.control_pb2"), P("models.sim_pb2")
        conns = P("core.connection")._all_connections
        channel_mod = P("core.channel")
        self.stubs: list[Stub] = []

        def stub(conn_id, kind):
            c = Stub(pkg, conn_id, kind)
            conns[conn_id] = c
            self.stubs.append(c)
            return c

        master = stub(1, "SERVER")
        gch = channel_mod.get_global_channel()
        gch.set_owner(master)
        sub.subscribe_to_channel(master, gch, None)
        for i in range(4):
            server = stub(2 + i, "SERVER")
            ctx = P("core.message").MessageContext(
                msg_type=types.MessageType.CREATE_CHANNEL,
                msg=control_pb2.CreateChannelMessage(), connection=server)
            for ch in ctl.create_channels(ctx):
                sub.subscribe_to_channel(server, ch, None)
        self.spatial = sorted(
            cid for cid, ch in channel_mod.all_channels().items()
            if ch.channel_type == types.ChannelType.SPATIAL)

        rng = self.rng = Random(20261017)
        x0, z0 = ctl.world_offset_x + 1.0, ctl.world_offset_z + 1.0
        x1 = ctl.world_offset_x + ctl.grid_width * ctl.grid_cols - 1.0
        z1 = ctl.world_offset_z + ctl.grid_height * ctl.grid_rows - 1.0
        self.bounds = (x0, z0, x1, z1)
        estart = P("core.settings").global_settings.entity_channel_id_start
        SpatialInfo = P("spatial.controller").SpatialInfo
        self.positions: dict[int, tuple[float, float]] = {}
        for i in range(entities):  # as scripts/chaos_soak.py's EntitySim
            eid = estart + 1 + i
            x, z = rng.uniform(x0, x1), rng.uniform(z0, z1)
            info = SpatialInfo(x, 0, z)
            cell_ch = channel_mod.get_channel(ctl.get_channel_id(info))
            owner = cell_ch.get_owner()
            ch = channel_mod.create_entity_channel(eid, owner)
            d = sim_pb2.SimEntityChannelData()
            d.state.entityId = eid
            d.state.transform.position.x = x
            d.state.transform.position.z = z
            ch.init_data(d, None)
            ch.spatial_notifier = ctl
            sub.subscribe_to_channel(owner, ch, None)
            cell_ch.execute(lambda c, e=eid, dd=d: c.get_data_message().add_entity(e, dd))
            ctl.track_entity(eid, info)
            self.positions[eid] = (x, z)
        self.entity_ids = list(self.positions)

        ops = P("ops.spatial_ops")
        for i in range(6):  # followers: spheres and cones
            client = stub(100 + i, "CLIENT")
            eid = self.entity_ids[rng.randrange(len(self.entity_ids))]
            if i % 2:
                ctl.register_follow_interest(client, eid, ops.AOI_CONE, extent=(70.0, 0.0),
                                             direction=(1.0, 0.5), angle=0.7)
            else:
                ctl.register_follow_interest(client, eid, ops.AOI_SPHERE, extent=(40.0, 0.0))
        for i in range(4):  # server sensors
            ctl.register_sensor(f"sensor{i}", kind=(ops.AOI_BOX, ops.AOI_SPHERE)[i % 2],
                                center=(rng.uniform(x0, x1), rng.uniform(z0, z1)),
                                extent=(rng.uniform(10, 60), rng.uniform(10, 60)))
        for i in range(6):  # plain subscriptions at 33-200 ms
            client = stub(200 + i, "CLIENT")
            for cid in rng.sample(self.spatial, 3):
                opts = control_pb2.ChannelSubscriptionOptions(
                    fanOutIntervalMs=rng.choice((33, 50, 100, 200)), fanOutDelayMs=0)
                sub.subscribe_to_channel(client, channel_mod.get_channel(cid), opts)

    def move(self, eid: int, x: float, z: float) -> None:
        P = lambda name: mod(self.pkg, name)  # noqa: E731
        ch = P("core.channel").get_channel(eid)
        upd = P("models.sim_pb2").SimEntityChannelData()
        upd.state.entityId = eid
        upd.state.transform.position.x = x
        upd.state.transform.position.z = z
        ctl = self.ctl

        def apply(c, u=upd):
            owner = c.get_owner()
            c.data.on_update(u, c.get_time(), owner.id if owner is not None else 0, ctl)

        ch.execute(apply)
        self.positions[eid] = (x, z)

    def drive(self, t: int) -> None:
        """Moves for tick ``t``: a random walk across cell edges, and at
        tick 10 a burst of 120 entities into one cell (past the 24-row
        handover budget), dispersed at tick 12."""
        x0, z0, x1, z1 = self.bounds
        rng = self.rng
        if t == 10:
            self.crowd = rng.sample(self.entity_ids, 120)
            for eid in self.crowd:
                self.move(eid, rng.uniform(-45.0, -5.0), rng.uniform(5.0, 45.0))
            return
        if t == 12:
            for eid in self.crowd:
                self.move(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))
            return
        for eid in rng.sample(self.entity_ids, len(self.entity_ids) // 3):
            x, z = self.positions[eid]
            self.move(eid, min(max(x + rng.uniform(-15, 15), x0), x1),
                      min(max(z + rng.uniform(-15, 15), z0), z1))

    def tick(self, t: int) -> dict:
        """One gateway tick in a fixed order (entity channels, GLOBAL,
        spatial channels) and what it produced."""
        P = lambda name: mod(self.pkg, name)  # noqa: E731
        channel_mod, types = P("core.channel"), P("core.types")
        self.clock.advance(TICK_S)
        self.drive(t)
        chans = channel_mod.all_channels()
        now = time.monotonic_ns()
        for cid in sorted(chans):
            if chans[cid].channel_type == types.ChannelType.ENTITY:
                chans[cid].tick_once(now)
        before = len(self.handovers)
        channel_mod.get_global_channel().tick_once(now)
        ctl, eng = self.ctl, self.eng
        result = eng.last_result
        obs = dict(handovers=self.handovers[before:])
        if result is not None:
            count, rows = eng.query_changed_rows(result)
            obs["query"] = (count, rows[: min(count, len(rows))].tolist(),
                            result.get("query_epoch"))
            obs["due"] = due_slots(self.pkg, eng, result)
        obs["pending"] = {ch: list(p.items()) for ch, p in ctl._due_pending.items()}
        for cid in self.spatial:
            chans[cid].tick_once(now)
        obs["tables"] = {cid: chans[cid].get_data_message().SerializeToString(deterministic=True)
                         for cid in self.spatial}
        obs["sent"] = {c.id: [wire(x) for x in c.sent] for c in self.stubs}
        for c in self.stubs:
            c.sent.clear()
        guard = P("core.device_guard").guard
        obs["guard"] = (guard.state.name, dict(guard.recovery_counts),
                        dict(guard.failure_counts), guard.held_ticks)
        return obs

    def sim_columns(self) -> list[np.ndarray]:
        eng = self.eng
        slots = eng.agent_slots()
        cols = (eng._d_positions, eng._d_vel, eng._d_sim_state, eng._d_sim_target)
        return [np.asarray(c)[slots].copy() for c in cols]


def first_difference(a: dict, b: dict) -> str:
    for key in a:
        if a[key] != b.get(key):
            if isinstance(a[key], dict):
                sub = [k for k in a[key] if a[key][k] != b[key].get(k)]
                return f"{key} {sub[:3]}: {a[key][sub[0]]!r:.300} != {b[key].get(sub[0])!r:.300}"
            return f"{key}: {a[key]!r:.300} != {b[key]!r:.300}"
    return ""


def run_both(monkeypatch, ticks: int, entities: int, sim: bool):
    clock = FixedClock(monkeypatch)
    legs = {}
    for pkg in (JAX, PORT):
        world = World(pkg, clock, entities, sim)
        legs[pkg] = [(world.tick(t), world.sim_columns() if sim else None)
                     for t in range(ticks)]
        legs[pkg + ".world"] = world
    return legs


def test_port_gateway_equals_jax_gateway_tick_for_tick(monkeypatch):
    legs = run_both(monkeypatch, ticks=30, entities=300, sim=False)
    crossings = overflowed = 0
    for t, ((want, _), (got, _)) in enumerate(zip(legs[JAX], legs[PORT])):
        assert got == want, f"tick {t}: {first_difference(want, got)}"
        crossings += sum(len(h) for h in got["handovers"])
    world = legs[PORT + ".world"]
    # The scenario exercised what it claims: crossings every tick, the
    # burst past the row budget, interest traffic and due fan-out.
    counts = [len(obs["handovers"][0]) if obs["handovers"] else 0 for obs, _ in legs[PORT]]
    overflowed = sum(c == world.eng.max_handovers for c in counts)
    assert crossings > 200 and overflowed >= 2, (crossings, counts)
    assert sum(len(o["due"]) for o, _ in legs[PORT]) > 30
    assert sum(o["query"][0] for o, _ in legs[PORT]) > 20
    followers = [c for c in world.stubs if 100 <= c.id < 200]
    assert all(c.spatial_subscriptions for c in followers)


def test_port_gateway_sim_plane_equals_jax_gateway(monkeypatch):
    """64 agents stepped for 10 ticks with a census every 5: the agent
    columns within ULPS ulps of their scale per sim pass, every other
    observation exact."""
    legs = run_both(monkeypatch, ticks=10, entities=40, sim=True)
    world = legs[PORT + ".world"]
    x0, z0, x1, z1 = world.bounds
    extent = max(abs(x0), abs(z0), abs(x1), abs(z1))
    speed = mod(PORT, "core.settings").global_settings.sim_max_speed
    for t, ((want, wcols), (got, gcols)) in enumerate(zip(legs[JAX], legs[PORT])):
        passes = t + 1
        assert np.array_equal(gcols[2], wcols[2]), f"tick {t}: FSM states differ"
        for i, scale in ((0, extent), (1, speed), (3, extent)):
            np.testing.assert_allclose(gcols[i], wcols[i], rtol=0, atol=passes * tol(scale),
                                       err_msg=f"tick {t} column {i}")
        assert got == want, f"tick {t}: {first_difference(want, got)}"
    assert world.ctl.simplane.ledgers.get("census_transfers") == 2


# ---- state carried across: the JAX gateway's WAL and snapshot --------------


def census_hash(eng) -> str:
    """scripts/sim_soak.py's census digest: rows sorted by agent id, all
    kinematic columns of the host shadow, and the RNG cursor."""
    slots = eng.agent_slots()
    ids = np.asarray(eng.agent_ids(slots), np.uint32)
    order = np.argsort(ids, kind="stable")
    h = hashlib.sha256(ids[order].tobytes())
    for col, dtype in ((eng._positions, np.float32), (eng._vel, np.float32),
                       (eng._sim_state, np.int32), (eng._sim_target, np.float32)):
        h.update(np.asarray(col[slots], dtype)[order].tobytes())
    h.update(int(eng.sim_tick).to_bytes(8, "little"))
    return h.hexdigest()


def gateway_state(pkg: str) -> dict:
    channel_mod, ctl = mod(pkg, "core.channel"), mod(pkg, "spatial.controller")
    chans = channel_mod.all_channels()
    controller = ctl.get_spatial_controller()
    return dict(
        channels=sorted((cid, int(ch.channel_type)) for cid, ch in chans.items()),
        tables={cid: ch.get_data_message().SerializeToString(deterministic=True)
                for cid, ch in chans.items() if ch.data is not None and ch.data.msg is not None},
        ledger=dict(sorted(controller._data_cell.items())),
        census=census_hash(controller.engine),
        agents=controller.engine.agent_count(),
    )


def replay(pkg: str, snap: str, wal_path: str) -> dict:
    fresh_runtime(pkg)
    mod(pkg, "sim.plane").reset_sim()
    mod(pkg, "models.sim").register_sim_types()
    report = mod(pkg, "core.wal").boot_replay(snap, wal_path)
    assert not report["torn"] and report["wal_records"] > 0, report
    s = mod(pkg, "core.settings").global_settings
    s.tpu_entity_capacity, s.tpu_query_capacity = 1024, 64
    s.sim_enabled, s.sim_agents, s.sim_census_every_ticks = True, 3, 5
    if pkg == PORT:
        s.spatial_device = "cpu"
    mod(pkg, "spatial.controller").init_spatial_controller(CONFIG_4X4)
    state = gateway_state(pkg)
    mod(pkg, "core.wal").reset_wal()
    return state


def test_port_gateway_restores_the_jax_gateways_wal_and_snapshot(monkeypatch, tmp_path):
    """The JAX gateway journals (sim plane on, a snapshot mid-run, a
    census every 5 ticks) and is abandoned; the port's gateway and the
    JAX gateway each replay the snapshot and the WAL tail. Both restore
    the same channels, entity tables and placement ledger, and the
    port's census is bit-identical to the last one journaled."""
    snap, wal_path = str(tmp_path / "gw.snap"), str(tmp_path / "gw.wal")
    clock = FixedClock(monkeypatch)
    jwal = mod(JAX, "core.wal").wal
    mod(JAX, "core.settings").global_settings.wal_fsync_ms = 1.0
    jwal.start(wal_path)
    world = World(JAX, clock, entities=40, sim=True)
    for t in range(6):
        world.tick(t)
    snapshot = mod(JAX, "core.snapshot")
    snapshot.write_snapshot(snapshot.take_snapshot(), snap)
    for t in range(6, 10):
        world.tick(t)
    journaled = census_hash(world.eng)  # tick 9 was a census tick
    assert world.ctl.simplane.ledgers["censuses_journaled"] == 2
    assert jwal.flush()
    mod(JAX, "core.wal").reset_wal()

    from_jax = replay(JAX, snap, wal_path)
    from_port = replay(PORT, snap, wal_path)
    assert from_port["census"] == journaled
    assert from_port["agents"] == 64
    for key in ("channels", "tables", "ledger", "census"):
        assert from_port[key] == from_jax[key], key
