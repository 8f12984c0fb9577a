"""The port's edited gateway modules, on ``device="cpu"``.

Counterparts of the JAX cases that build ``TPUSpatialController``
(``tests/test_device_guard.py``, ``test_device_fanout.py``,
``test_queryplane.py``, ``test_sim.py``), run on the port's
``GPUSpatialController``: the device guard (transient retry, fatal
rebuild and clean verify, the watchdog against a chaos hang with the
generation fence holding off the zombie, the sentinel, the rebuild-lock
contention path, and its torch classification: an allocator OOM is
transient, a sticky CUDA error fatal and terminal), the device due
mask, the standing-query plane's one changed-rows transfer per tick,
the sim plane with its census read and WAL replay, ``-profile gpu``,
and the mesh options the port refuses. The kernels' CUDA side is held
by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import signal
import threading
import time

import numpy as np
import pytest
import torch

from channeld_tpu_torch.chaos import arm, disarm
from channeld_tpu_torch.core import device_guard as dg
from channeld_tpu_torch.core import metrics
from channeld_tpu_torch.core.channel import create_entity_channel, get_channel
from channeld_tpu_torch.core.connection import _all_connections
from channeld_tpu_torch.core.device_guard import (
    DeviceState,
    DeviceStepError,
    classify_failure,
    guard,
)
from channeld_tpu_torch.core.message import MessageContext
from channeld_tpu_torch.core.overload import OverloadLevel, governor
from channeld_tpu_torch.core.settings import global_settings
from channeld_tpu_torch.core.subscription import subscribe_to_channel
from channeld_tpu_torch.core.types import MessageType
from channeld_tpu_torch.core.wal import boot_replay, wal
from channeld_tpu_torch.models import sim_pb2
from channeld_tpu_torch.models.sim import register_sim_types
from channeld_tpu_torch.ops.spatial_ops import AOI_SPHERE
from channeld_tpu_torch.protocol import control_pb2
from channeld_tpu_torch.sim.plane import AGENT_ID_OFFSET
from channeld_tpu_torch.spatial.controller import SpatialInfo, set_spatial_controller
from channeld_tpu_torch.spatial.gpu_controller import GPUSpatialController

from test_torch_gateway import PORT, Stub, fresh_runtime, port_globals

START = 0x10000
ENTITY_START = 0x80000
AGENT_BASE = ENTITY_START + AGENT_ID_OFFSET


@pytest.fixture(autouse=True)
def runtime(tmp_path):
    with port_globals(tmp_path):
        fresh_runtime(PORT)
        register_sim_types()
        global_settings.development = True
        global_settings.device_retry_backoff_ms = 1
        global_settings.spatial_device = "cpu"
        yield
        disarm()
        governor.level = OverloadLevel.L0


def stub(conn_id, kind="CLIENT"):
    conn = Stub(PORT, conn_id, kind)
    _all_connections[conn_id] = conn
    return conn


def make_world(cols=2, servers=2, entity_capacity=64, query_capacity=8, **extra_cfg):
    """A ``cols``x1 world of 100 m cells with ``servers`` spatial servers."""
    global_settings.tpu_entity_capacity = entity_capacity
    global_settings.tpu_query_capacity = query_capacity
    ctl = GPUSpatialController()
    ctl.load_config(dict(WorldOffsetX=0, WorldOffsetZ=0, GridWidth=100, GridHeight=100,
                         GridCols=cols, GridRows=1, ServerCols=servers, ServerRows=1,
                         ServerInterestBorderSize=1, **extra_cfg))
    set_spatial_controller(ctl)
    server_conns, channels = [], []
    for i in range(servers):
        server = stub(1 + i, "SERVER")
        ctx = MessageContext(msg_type=MessageType.CREATE_CHANNEL,
                             msg=control_pb2.CreateChannelMessage(), connection=server)
        for ch in ctl.create_channels(ctx):
            subscribe_to_channel(server, ch, None)
            channels.append(ch)
        server_conns.append(server)
    return ctl, server_conns, channels


def entity_data(eid, x, z):
    d = sim_pb2.SimEntityChannelData()
    d.state.entityId = eid
    d.state.transform.position.x = x
    d.state.transform.position.z = z
    return d


def add_entity(ctl, server, eid, x, z):
    entity_ch = create_entity_channel(eid, server)
    entity_ch.init_data(entity_data(eid, x, z), None)
    entity_ch.spatial_notifier = ctl
    cell_ch = get_channel(ctl.get_channel_id(SpatialInfo(x, 0, z)))
    cell_ch.get_data_message().add_entity(eid, entity_ch.get_data_message())
    ctl.track_entity(eid, SpatialInfo(x, 0, z))
    return entity_ch


def run_ticks(ctl, channels, n=1):
    for _ in range(n):
        ctl.tick()
        for ch in channels:
            ch.tick_once(0)


# ---- the device guard: classification -------------------------------------


def test_classify_failure():
    assert classify_failure(DeviceStepError("boom", transient=True)) == "transient"
    assert classify_failure(DeviceStepError("boom")) == "fatal"
    assert classify_failure(RuntimeError("RESOURCE_EXHAUSTED: out of memory")) == "transient"
    assert classify_failure(torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                                   "allocate 2.00 GiB")) == "transient"
    for sticky in ("CUDA error: an illegal memory access was encountered",
                   "CUDA error: unspecified launch failure",
                   "CUDA error: device-side assert triggered"):
        assert classify_failure(RuntimeError(sticky)) == "fatal"
        assert dg.is_sticky_cuda_error(RuntimeError(sticky))
    assert not dg.is_sticky_cuda_error(RuntimeError("INTERNAL: compilation failure"))
    assert classify_failure(ValueError("anything else")) == "fatal"


def test_transient_oom_retries_without_rebuild(monkeypatch):
    """An allocator OOM from the step degrades (held tick, ladder pinned
    at L2); the backoff retry succeeds and counts a 'transient'
    recovery, with no rebuild."""
    ctl, (sa, _), _ = make_world()
    add_entity(ctl, sa, ENTITY_START + 1, 50, 50)
    ctl.tick()
    real_tick = ctl.engine.tick
    fails = iter([True])

    def tick(*a, **k):
        if next(fails, False):
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real_tick(*a, **k)

    monkeypatch.setattr(ctl.engine, "tick", tick)
    rebuilds = []
    real_rebuild = ctl.engine.rebuild_device_state
    monkeypatch.setattr(ctl.engine, "rebuild_device_state",
                        lambda *a, **k: rebuilds.append(1) or real_rebuild(*a, **k))
    ctl.tick()
    assert guard.state == DeviceState.DEGRADED
    assert governor.level == 2
    assert guard.failure_counts == {"step_error": 1}
    time.sleep(0.005)
    ctl.tick()
    assert guard.state == DeviceState.ACTIVE
    assert guard.recovery_counts == {"transient": 1}
    assert not rebuilds


def test_retries_exhausted_rebuild_verifies_clean():
    """Sustained step errors burn the retry budget; the engine is then
    rebuilt in-process from the host shadow, verified clean, and serves
    again."""
    ctl, (sa, _), _ = make_world()
    add_entity(ctl, sa, ENTITY_START + 1, 50, 50)
    ctl.tick()
    verified = []
    real_verify = ctl.engine.verify_device_state
    ctl.engine.verify_device_state = lambda seeds: verified.append(real_verify(seeds)) or verified[-1]
    arm({"seed": 2, "faults": [
        {"point": "device.step_error", "every_n": 1, "max_fires": 10}]})
    for _ in range(10):
        if guard.recovery_counts:
            break
        time.sleep(0.005)
        ctl.tick()
    disarm()
    assert guard.recovery_counts == {"step_error": 1}
    assert guard.failure_counts["step_error"] == 1 + global_settings.device_retry_max
    assert verified == [[]]
    assert guard.state == DeviceState.ACTIVE
    ctl.tick()


def test_sticky_cuda_error_is_fatal_and_terminal(monkeypatch):
    """A sticky CUDA error poisons the context: the step is fatal, the
    rebuild fails on the same error, and the guard stays FAILED for good
    (no retry loop) with device service held."""
    ctl, (sa, _), _ = make_world()
    add_entity(ctl, sa, ENTITY_START + 1, 50, 50)
    ctl.tick()
    sticky = RuntimeError("CUDA error: an illegal memory access was encountered")

    def poisoned(*a, **k):
        raise sticky

    monkeypatch.setattr(ctl.engine, "tick", poisoned)
    monkeypatch.setattr(ctl.engine, "rebuild_device_state", poisoned)
    ctl.tick()
    assert guard.state == DeviceState.FAILED
    assert guard.failure_counts == {"step_error": 1, "rebuild_fail": 1}
    held = guard.held_ticks
    for _ in range(5):
        time.sleep(0.01)
        ctl.tick()
    assert guard.state == DeviceState.FAILED
    assert guard.failure_counts == {"step_error": 1, "rebuild_fail": 1}
    assert guard.held_ticks == held + 5
    assert not guard.recovery_counts


# ---- the device guard: watchdog, sentinel, rebuild lock --------------------


def test_hang_watchdog_fences_off_the_zombie():
    """A step stalled past the deadline (the ``device.step_hang`` chaos
    stall) is abandoned off-thread; the engine rebuilds, serves from a
    fresh worker, and the zombie, when it wakes, raises on the stale
    generation instead of committing over the rebuilt engine."""
    ctl, (sa, _), _ = make_world()
    add_entity(ctl, sa, ENTITY_START + 1, 50, 50)
    ctl.tick()
    global_settings.device_step_deadline_s = 0.08
    arm({"seed": 3, "faults": [
        {"point": "device.step_hang", "every_n": 1, "max_fires": 1, "stall_ms": 400}]})
    zombies = []
    real_log = dg._log_zombie
    dg._log_zombie = lambda fut: zombies.append(fut.exception()) or real_log(fut)
    try:
        t0 = time.monotonic()
        ctl.tick()
        assert time.monotonic() - t0 < 0.3
        assert guard.recovery_counts == {"hang": 1}
        assert guard.state == DeviceState.ACTIVE
        disarm()
        gen = ctl.engine.generation
        deadline = time.monotonic() + 2.0
        while not zombies and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        dg._log_zombie = real_log
    assert zombies and "stale device tick" in str(zombies[0])
    assert ctl.engine.generation == gen
    ctl.tick()
    assert guard.state == DeviceState.ACTIVE


def test_nan_corruption_caught_by_sentinel_and_healed():
    """``device.nan`` rots the device state; the sentinel catches the
    impossible source cell in the ordinary fetched rows, and the rebuild
    restores every entity's position and keeps detecting crossings."""
    ctl, (sa, _), _ = make_world()
    eids = [ENTITY_START + 1 + i for i in range(8)]
    for i, eid in enumerate(eids):
        add_entity(ctl, sa, eid, 10 + i * 5, 50)
    ctl.tick()
    arm({"seed": 4, "faults": [{"point": "device.nan", "every_n": 1, "max_fires": 1}]})
    ctl.tick()
    disarm()
    assert guard.recovery_counts == {"corruption": 1}
    assert guard.failure_counts["corruption"] == 1
    for i, eid in enumerate(eids):
        slot = ctl.engine.slot_of_entity(eid)
        assert np.array_equal(ctl.engine._d_positions[slot].numpy(),
                              np.array([10 + i * 5, 0, 50], np.float32))
    get_channel(eids[0]).data.on_update(entity_data(eids[0], 150, 50), 0, sa.id, ctl)
    ctl.tick()
    get_channel(START).tick_once(0)
    get_channel(START + 1).tick_once(0)
    assert eids[0] in get_channel(START + 1).get_data_message().entities
    assert eids[0] not in get_channel(START).get_data_message().entities


def test_sentinel_checks():
    ctl, _, _ = make_world()
    eng = ctl.engine
    result = {"handover_count": 1, "handovers": np.array([[0, 0, 1]], np.int32),
              "due": np.zeros(eng.sub_capacity, np.uint8)}
    assert guard._sentinel(eng, result) is None
    assert "count" in guard._sentinel(eng, dict(result, handover_count=-3))
    bad = dict(result, handovers=np.array([[0, 1 << 24, 1]], np.int32))
    assert "impossible cell" in guard._sentinel(eng, bad)
    bad = dict(result, handovers=np.array([[-1, 1 << 24, 1]], np.int32))
    assert guard._sentinel(eng, bad) is None  # discard-lane row: ignored
    assert "bitmap" in guard._sentinel(eng, dict(result, due=np.zeros(3, np.uint8)))
    q_blob = np.array([1, 0, 99, 0], np.int32)  # one row citing cell 99
    assert "impossible cell" in guard._sentinel(eng, dict(result, query_blob=q_blob))


def test_hung_rebuild_waits_for_the_rebuild_lock():
    """A rebuild wedged past 4x the deadline is abandoned into FAILED;
    the zombie rebuild still holds the engine's rebuild lock, so the
    next attempt waits on it (the contention path), and once the zombie
    drains the retry rebuilds and verifies."""
    ctl, (sa, _), _ = make_world()
    add_entity(ctl, sa, ENTITY_START + 1, 50, 50)
    ctl.tick()
    global_settings.device_step_deadline_s = 0.05
    orig = dg.DeviceGuard._rebuild_body
    entered = threading.Event()

    def wedged(engine, seeds, gen):
        with engine._rebuild_lock:  # the zombie holds the lock while wedged
            entered.set()
            time.sleep(0.6)
        return orig(engine, seeds, gen)

    dg.DeviceGuard._rebuild_body = staticmethod(wedged)
    try:
        arm({"seed": 10, "faults": [{"point": "device.nan", "every_n": 1, "max_fires": 1}]})
        ctl.tick()
        assert guard.state == DeviceState.REBUILDING
        give_up = time.monotonic() + 2.0
        while guard.state != DeviceState.FAILED and time.monotonic() < give_up:
            ctl.tick()
            time.sleep(0.02)
        assert guard.state == DeviceState.FAILED
        assert entered.is_set()
    finally:
        disarm()
        dg.DeviceGuard._rebuild_body = staticmethod(orig)
    assert ctl.engine._rebuild_lock.locked()  # the zombie still holds it
    for _ in range(60):
        if guard.state == DeviceState.ACTIVE:
            break
        time.sleep(0.02)
        ctl.tick()
    assert guard.state == DeviceState.ACTIVE
    assert guard.recovery_counts == {"corruption": 1}
    assert not ctl.engine._rebuild_lock.locked()


# ---- device fan-out ----------------------------------------------------------


def data_updates(conn):
    return [c for c in conn.sent if c.msg_type == MessageType.CHANNEL_DATA_UPDATE]


def test_spatial_fanout_consumes_device_due_mask():
    ctl, _, _ = make_world()
    ch = get_channel(START)
    ch.init_data(sim_pb2.SimSpatialChannelData(), None)
    client = stub(9)
    cs, _ = subscribe_to_channel(client, ch, control_pb2.ChannelSubscriptionOptions(
        fanOutIntervalMs=1, fanOutDelayMs=0))
    foc = cs.fanout_conn
    assert foc.device_sub_slot is not None
    time.sleep(0.005)
    ctl.tick()
    seq1, pending1 = ctl.device_due(ch.id)
    assert foc.device_sub_slot in pending1
    ch.tick_once(ch.get_time())
    assert len(data_updates(client)) == 1
    upd = sim_pb2.SimSpatialChannelData()
    upd.entities[7].SetInParent()
    ch.data.on_update(upd, ch.get_time(), 1, None)
    time.sleep(0.005)
    ch.tick_once(ch.get_time())
    assert len(data_updates(client)) == 1, "fan-out must wait for the device"
    for _ in range(50):
        time.sleep(0.005)
        ctl.tick()
        ch.tick_once(ch.get_time())
        if len(data_updates(client)) == 2:
            break
    assert len(data_updates(client)) == 2


def test_pending_due_survives_missed_channel_ticks():
    ctl, _, _ = make_world()
    ch = get_channel(START)
    ch.init_data(sim_pb2.SimSpatialChannelData(), None)
    client = stub(9)
    cs, _ = subscribe_to_channel(client, ch, control_pb2.ChannelSubscriptionOptions(
        fanOutIntervalMs=1, fanOutDelayMs=0))
    slot = cs.fanout_conn.device_sub_slot
    time.sleep(0.005)
    ctl.tick()
    time.sleep(0.005)
    ctl.tick()
    _, pending = ctl.device_due(ch.id)
    assert slot in pending
    ch.tick_once(ch.get_time())
    assert len(data_updates(client)) == 1
    assert slot not in pending


def test_device_slot_freed_on_connection_drop():
    ctl, _, _ = make_world()
    ch = get_channel(START)
    ch.init_data(sim_pb2.SimSpatialChannelData(), None)
    client = stub(9)
    cs, _ = subscribe_to_channel(client, ch, control_pb2.ChannelSubscriptionOptions(
        fanOutIntervalMs=1))
    slot = cs.fanout_conn.device_sub_slot
    before = ctl._device_sub_count
    client.close(unexpected=True)
    ch.tick_once(ch.get_time())
    assert ctl._device_sub_count == before - 1
    assert not ctl.engine._sub_active[slot]
    assert slot in ctl.engine._sub_free
    assert cs.fanout_conn not in ch.fan_out_queue


# ---- device reads per tick -------------------------------------------------------


class Transfers:
    """Counts ``Tensor.cpu`` and ``Tensor.numpy`` calls while entered
    (each read of a tick's blob or column is one ``.cpu().numpy()``)."""

    def __init__(self, monkeypatch):
        self.cpu = self.numpy = 0
        real_cpu, real_numpy = torch.Tensor.cpu, torch.Tensor.numpy

        def cpu(t, *a, **k):
            self.cpu += 1
            return real_cpu(t, *a, **k)

        def numpy(t, *a, **k):
            self.numpy += 1
            return real_numpy(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", cpu)
        monkeypatch.setattr(torch.Tensor, "numpy", numpy)

    def take(self) -> tuple[int, int]:
        out = (self.cpu, self.numpy)
        self.cpu = self.numpy = 0
        return out


def test_query_plane_one_changed_rows_transfer_per_tick(monkeypatch):
    """Under the guard a steady tick reads the consume blob and the
    changed-rows blob, one transfer each, and nothing else: the follow
    flows through the plane (no per-follower read)."""
    ctl, _, channels = make_world(cols=4, servers=1, query_capacity=16)
    client = stub(9)
    eid = 7001
    ctl.track_entity(eid, SpatialInfo(50.0, 0.0, 50.0))
    ctl.register_follow_interest(client, eid, AOI_SPHERE, extent=(80.0, 0.0))
    reads = Transfers(monkeypatch)
    t0 = metrics.query_plane_transfers._value.get()
    per_tick = []
    for _ in range(3):
        ctl.tick()
        per_tick.append(reads.take())
        for ch in channels:
            ch.tick_once(0)
    assert per_tick == [(2, 2)] * 3
    assert ctl.queryplane.ledgers["transfers"] == 3
    assert metrics.query_plane_transfers._value.get() - t0 == 3
    assert client.spatial_subscriptions
    before = dict(client.spatial_subscriptions)
    ctl.track_entity(eid, SpatialInfo(350.0, 0.0, 50.0))
    run_ticks(ctl, channels, 2)
    assert client.spatial_subscriptions != before


# ---- the sim plane -----------------------------------------------------------


def make_sim_world(agents=24, census=1, **settings_over):
    global_settings.sim_enabled = True
    global_settings.sim_agents = agents
    global_settings.sim_census_every_ticks = census
    global_settings.sim_max_speed = 20.0
    global_settings.sim_p_wander = 0.6
    for k, v in settings_over.items():
        setattr(global_settings, k, v)
    return make_world(cols=4, servers=1, entity_capacity=256, query_capacity=16)


def test_sim_census_tick_reads_the_four_columns_under_the_guard(monkeypatch):
    """The census tick adds exactly the four kinematic columns to the
    tick's reads; the plane folds them into the host shadow."""
    ctl, _, channels = make_sim_world(census=3)
    run_ticks(ctl, channels, 1)
    reads = Transfers(monkeypatch)
    eng = ctl.engine
    per_tick = []
    for i in range(3):
        ctl.tick()
        per_tick.append(reads.take())
        if i == 1:  # the census tick: the host shadow is the device's
            slots = eng.agent_slots()
            assert np.array_equal(eng._positions[slots], eng._d_positions[slots].numpy())
            reads.take()
        for ch in channels:
            ch.tick_once(0)
    assert per_tick == [(2, 2), (2 + 4, 2 + 4), (2, 2)]
    assert ctl.simplane.ledgers["census_transfers"] == 1


def test_sim_census_without_the_guard_reads_tensors():
    """``-device-guard false``: the census columns reach the plane as
    tensors, which it reads itself."""
    ctl, _, channels = make_sim_world(census=2, device_guard_enabled=False)
    run_ticks(ctl, channels, 4)
    eng = ctl.engine
    slots = eng.agent_slots()
    assert ctl.simplane.ledgers["census_transfers"] == 2
    assert np.array_equal(eng._vel[slots], eng._d_vel[slots].numpy())


def test_agents_attach_and_cross_cells_via_ordinary_handover():
    ctl, _, channels = make_sim_world(census=2, sim_step_dt=0.5)
    run_ticks(ctl, channels, 3)
    assert len(ctl.simplane.authority._backed) == 24
    eng = ctl.engine
    eng.sim_stampede(eng.grid.num_cells - 1)
    crossings_before = metrics.handover_count._value.get()
    for _ in range(40):
        run_ticks(ctl, channels, 1)
        if (eng._positions[eng.agent_slots()][:, 0] > 300.0).all():
            break
    assert metrics.handover_count._value.get() > crossings_before
    rows = {}
    for ch in channels:
        for eid in ch.get_data_message().entities:
            if eid >= AGENT_BASE:
                rows[eid] = rows.get(eid, 0) + 1
    assert len(rows) == 24 and set(rows.values()) == {1}


def test_overload_l2_halves_sim_cadence():
    ctl, _, channels = make_sim_world(census=100)
    run_ticks(ctl, channels, 2)
    eng = ctl.engine
    base = eng.sim_tick
    governor.level = OverloadLevel.L2
    run_ticks(ctl, channels, 8)
    assert eng.sim_tick - base == 4
    assert governor.shed_counts.get("sim_cadence_defer") == 4 * 24


def test_sim_rebuild_double_entry_and_geometry_epoch():
    """A rebuild verifies the agent arrays clean with the Python ledger
    and the Prometheus counter moving together; an apply_grid re-homes
    every agent with zero loss."""
    ctl, _, channels = make_sim_world(census=1)
    run_ticks(ctl, channels, 3)
    eng = ctl.engine
    before = metrics.sim_device_rebuilds.labels(result="verified")._value.get()
    ids = set(eng.agent_ids().tolist())
    eng.apply_grid(eng.grid, ctl.rebuild_seed_cells())
    assert eng.verify_device_state(ctl.rebuild_seed_cells()) == []
    assert eng.sim_rebuild_counts == {"verified": 1}
    assert metrics.sim_device_rebuilds.labels(result="verified")._value.get() == before + 1
    assert set(eng.agent_ids().tolist()) == ids
    run_ticks(ctl, channels, 2)
    assert eng.agent_count() == 24


def test_sim_step_nan_sentinel_heals_population():
    ctl, _, channels = make_sim_world(census=1)
    run_ticks(ctl, channels, 3)
    eng = ctl.engine
    ids = set(eng.agent_ids().tolist())
    arm({"seed": 4, "faults": [{"point": "sim.step_nan", "every_n": 1, "max_fires": 1}]})
    run_ticks(ctl, channels, 3)
    disarm()
    assert guard.recovery_counts.get("corruption", 0) >= 1
    assert guard.state == DeviceState.ACTIVE
    assert set(eng.agent_ids().tolist()) == ids
    assert torch.isfinite(eng._d_positions[eng.agent_slots()]).all()


def test_wal_replay_restores_exact_census(tmp_path):
    """The in-process kill -9 smoke: the journaled census restores the
    exact population and RNG cursor, with the replay counter
    double-entried."""
    global_settings.wal_fsync_ms = 1.0
    wal.start(str(tmp_path / "gw.wal"))
    ctl, _, channels = make_sim_world(census=2)
    run_ticks(ctl, channels, 6)
    eng = ctl.engine
    slots = eng.agent_slots()
    want = [eng.agent_ids(slots).copy()] + [
        col[slots].copy() for col in (eng._positions, eng._vel, eng._sim_state, eng._sim_target)]
    tick = eng.sim_tick
    assert wal.flush()

    fresh_runtime(PORT)
    register_sim_types()
    report = boot_replay("", str(tmp_path / "gw.wal"))
    assert not report["torn"]
    assert wal.replay_counts.get("sim_census") == len(want[0])
    ctl2, _, _ = make_sim_world(agents=3)  # the census wins over sim_agents
    eng2 = ctl2.engine
    slots2 = eng2.agent_slots()
    got = [eng2.agent_ids(slots2)] + [
        col[slots2] for col in (eng2._positions, eng2._vel, eng2._sim_state, eng2._sim_target)]
    for a, b in zip(got, want):
        assert np.array_equal(a, b, equal_nan=True)
    assert eng2.sim_tick == tick
    assert ctl2.simplane.ledgers.get("agents_restored") == len(want[0])


# ---- entry-point options -----------------------------------------------------


def test_profile_gpu_writes_a_trace_on_the_cpu(tmp_path):
    from channeld_tpu_torch.core import profiling

    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        profiling.start_profiling("gpu", str(tmp_path))
        ctl, (sa, _), _ = make_world()
        add_entity(ctl, sa, ENTITY_START + 1, 50, 50)
        ctl.tick()
        path = profiling.stop_profiling()
    finally:
        for sig, handler in saved.items():  # start_profiling rebinds them
            signal.signal(sig, handler)
    assert path.startswith(str(tmp_path / "gpu_trace"))
    with open(path) as f:
        trace = f.read()
    assert '"traceEvents"' in trace and "aten::" in trace


@pytest.mark.parametrize("cfg", [dict(MeshDevices=2), dict(Sharding="cells"),
                                 dict(CellBucket=64), dict(MeshHosts=2)],
                         ids=["mesh", "cells", "bucket", "hosts"])
def test_load_config_refuses_the_multi_device_planes(cfg):
    with pytest.raises(NotImplementedError):
        make_world(**cfg)


@pytest.mark.cuda
def test_two_threads_ticking_two_engines_keep_k1_counts_exact():
    """After a watchdog timeout a zombie worker may still be inside
    ``tick()`` on the same stream as the fresh worker, and K1's
    zero-ahead counts buffer is shared per (device, stream, bins): two
    threads ticking two engines on one card must each get exact counts.
    Needs a card; ``chip_smoke.py`` phase 6c runs the same check."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops.engine import SpatialEngine
    from channeld_tpu_torch.ops.spatial_ops import GridSpec

    dev = torch.device("cuda", 0)
    grid = GridSpec(-15000.0, -15000.0, 2000.0, 2000.0, 15, 15)
    engines, errors = [], []
    for i in range(2):
        eng = SpatialEngine(grid, entity_capacity=1 << 14, query_capacity=8, device=dev)
        rng = np.random.default_rng(i)
        for j, (x, z) in enumerate(rng.uniform(-15000, 15000, (4000, 2))):
            eng.add_entity(0x80000 + j, float(x), 0.0, float(z))
        eng.warmup()
        engines.append(eng)
    barrier = threading.Barrier(2)

    def work(i, eng):
        rng = np.random.default_rng(10 + i)
        try:
            with torch.cuda.device(dev):
                barrier.wait(timeout=60)
                for t in range(100):
                    for j in rng.integers(0, 4000, 100):
                        x, z = rng.uniform(-15000, 15000, 2)
                        eng.update_entity(0x80000 + int(j), float(x), 0.0, float(z))
                    out = eng.tick(now_ms=33 * t)
                    want = K.assign_and_count_plain(grid, eng._d_positions, eng._d_valid)[1]
                    if not torch.equal(out["cell_counts"], want):
                        errors.append((i, t))
        except Exception as e:
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=work, args=(i, e)) for i, e in enumerate(engines)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:4]
