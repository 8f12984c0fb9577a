"""The gateway's recovery path: the port's device guard against the JAX
package's, case by case.

Each case runs one world and one fault through the JAX package's
``TPUSpatialController`` and ``DeviceGuard`` (JAX on the CPU), then
through the port's ``GPUSpatialController`` and ``DeviceGuard`` on
``device="cpu"``. Each package's own ``chaos`` singleton is armed with the
same scenario, and both legs run under one fixed ``time.monotonic`` that
moves a tick at a time, so backoffs, held ticks and ``start_at_s`` windows
land on the same ticks. What a case observes must be equal exactly: the
guard's state transitions, failure and recovery ledgers and held ticks,
the engine's slot cells, positions and counts after the rebuild, the
crossings re-detected, the overload ladder and its floor, and the
snapshots' channels.

The cases are tests/test_device_guard.py's rebuild and outage cases, its
device soak's fault schedule (``chip_smoke.device_recovery_scenario``,
the port's copy of scripts/device_soak.py's) with the soak's invariants,
and a lockstep gateway run of that schedule compared tick for tick. The
``cuda``-marked cases wedge a card for real and run only there
(``python -m pytest --noconftest -m cuda tests/test_torch_recovery.py``).
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading
import time
from random import Random
from typing import Optional

import numpy as np
import pytest
import torch

from test_torch_gateway import (
    JAX,
    PORT,
    TICK_S,
    FixedClock,
    Stub,
    World,
    first_difference,
    fresh_runtime,
    mod,
    port_globals,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = 0x10000
ENTITY_START = 0x80000
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield
        for pkg in PKGS:
            if f"{pkg}.chaos" in sys.modules:
                sys.modules[f"{pkg}.chaos"].disarm()


def chip_smoke():
    """The port's harness, loaded by path (its fault schedule lives there)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


def settings(pkg: str):
    return mod(pkg, "core.settings").global_settings


def guard(pkg: str):
    return mod(pkg, "core.device_guard").guard


def governor(pkg: str):
    return mod(pkg, "core.overload").governor


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def boot(pkg: str, clock: Optional[FixedClock], device: str = "cpu") -> None:
    """One package's runtime from boot, on the shared fixed clock (or on
    the host's own clock: None)."""
    if clock is not None:
        clock.reset()
    mod(pkg, "core.device_guard").reset_device_guard()
    fresh_runtime(pkg)
    mod(pkg, "models.sim").register_sim_types()
    s = settings(pkg)
    s.development = True
    s.device_retry_backoff_ms = 1
    # Far above any step (a JAX compile included): only the cases that
    # test the watchdog shorten it, around the tick they hang.
    s.device_step_deadline_s = 60.0
    s.tpu_entity_capacity = 64
    s.tpu_query_capacity = 8
    if pkg == PORT:
        s.spatial_device = device


def stub(pkg: str, conn_id: int, kind: str) -> Stub:
    conn = Stub(pkg, conn_id, kind)
    mod(pkg, "core.connection")._all_connections[conn_id] = conn
    return conn


def make_world(pkg: str):
    """tests/test_device_guard.py's 2x1 world of 100 m cells with two
    spatial servers, on one package's device controller."""
    if pkg == JAX:
        ctl = mod(JAX, "spatial.tpu_controller").TPUSpatialController()
    else:
        ctl = mod(PORT, "spatial.gpu_controller").GPUSpatialController()
    ctl.load_config(dict(WorldOffsetX=0, WorldOffsetZ=0, GridWidth=100, GridHeight=100,
                         GridCols=2, GridRows=1, ServerCols=2, ServerRows=1,
                         ServerInterestBorderSize=1))
    mod(pkg, "spatial.controller").set_spatial_controller(ctl)
    types, control_pb2 = mod(pkg, "core.types"), mod(pkg, "protocol.control_pb2")
    servers = []
    for i in (1, 2):
        server = stub(pkg, i, "SERVER")
        ctx = mod(pkg, "core.message").MessageContext(
            msg_type=types.MessageType.CREATE_CHANNEL,
            msg=control_pb2.CreateChannelMessage(), connection=server)
        for ch in ctl.create_channels(ctx):
            mod(pkg, "core.subscription").subscribe_to_channel(server, ch, None)
        servers.append(server)
    return ctl, servers


def entity_data(pkg: str, eid: int, x: float, z: float):
    d = mod(pkg, "models.sim_pb2").SimEntityChannelData()
    d.state.entityId = eid
    d.state.transform.position.x = x
    d.state.transform.position.z = z
    return d


def add_entity(pkg: str, ctl, server, eid: int, x: float, z: float):
    channel_mod = mod(pkg, "core.channel")
    info = mod(pkg, "spatial.controller").SpatialInfo(x, 0, z)
    entity_ch = channel_mod.create_entity_channel(eid, server)
    entity_ch.init_data(entity_data(pkg, eid, x, z), None)
    entity_ch.spatial_notifier = ctl
    cell_ch = channel_mod.get_channel(ctl.get_channel_id(info))
    cell_ch.get_data_message().add_entity(eid, entity_ch.get_data_message())
    ctl.track_entity(eid, info)
    return entity_ch


def tick(ctl, clock: FixedClock) -> None:
    clock.advance(TICK_S)
    ctl.tick()


def tick_until_active(pkg: str, ctl, clock: FixedClock, limit: int = 20) -> list:
    """Tick until the guard serves again; each tick's (state, ladder
    level, ladder floor)."""
    seen = []
    for _ in range(limit):
        if guard(pkg).state.name == "ACTIVE":
            break
        tick(ctl, clock)
        gov = governor(pkg)
        seen.append((guard(pkg).state.name, int(gov.level), gov._level_floor))
    return seen


def ledgers(pkg: str) -> dict:
    g = guard(pkg)
    return dict(state=g.state.name,
                transitions=[(e["from"], e["to"]) for e in g.events if "from" in e],
                recovered=[e["recovered"] for e in g.events if "recovered" in e],
                failures=dict(g.failure_counts), recoveries=dict(g.recovery_counts),
                held=g.held_ticks)


def tables(eng) -> dict:
    """The engine's entity and sub tables on the host (floats as bytes,
    so a NaN compares equal to itself)."""
    out = dict(cells=host(eng._d_cell).tolist(), positions=host(eng._d_positions).tobytes(),
               valid=host(eng._d_valid).tolist())
    if eng._d_sub_state is not None:
        out["subs"] = [host(a).tolist() for a in eng._d_sub_state]
    return out


def entities_of(pkg: str, ch_id: int) -> list:
    return sorted(mod(pkg, "core.channel").get_channel(ch_id).get_data_message().entities)


def arm(pkg: str, scenario: dict) -> None:
    mod(pkg, "chaos").arm(scenario)


def disarm(pkg: str) -> None:
    mod(pkg, "chaos").disarm()


def both(monkeypatch, case, **kw) -> dict:
    """``case(pkg, clock, **kw)`` on the JAX package, then on the port;
    the two observations must be equal. Returns the port's."""
    clock = FixedClock(monkeypatch)
    out = {}
    for pkg in PKGS:
        boot(pkg, clock)
        out[pkg] = case(pkg, clock, **kw)
        disarm(pkg)
    assert out[PORT] == out[JAX], first_difference(out[JAX], out[PORT])
    return out[PORT]


# ---- rebuild determinism ---------------------------------------------------


def mid_crossing_rebuild(pkg: str, clock: FixedClock) -> dict:
    ctl, (sa, _) = make_world(pkg)
    e_plain, e_flight = ENTITY_START + 1, ENTITY_START + 2
    add_entity(pkg, ctl, sa, e_plain, 30, 50)
    add_entity(pkg, ctl, sa, e_flight, 40, 50)
    tick(ctl, clock)
    journal = mod(pkg, "core.failover").journal
    recs = journal.prepare({e_flight: entity_data(pkg, e_flight, 140, 50)}, START, START + 1)
    conn = stub(pkg, 9, "CLIENT")
    ctl.engine.set_query(conn.id, mod(pkg, "ops.spatial_ops").AOI_SPHERE, (50.0, 50.0), (80.0, 80.0))
    sub_slot = ctl.device_sub_add(100, 0, START)
    seeds = ctl.rebuild_seed_cells()
    ctl.engine.rebuild_device_state(seeds)
    eng = ctl.engine
    obs = dict(pending=journal.pending_dst(e_flight), sub_slot=sub_slot,
               seeds=sorted(seeds.items()), verify=eng.verify_device_state(seeds),
               queries=[host(a).tobytes() for a in (eng._d_queries.kind, eng._d_queries.center,
                                                    eng._d_queries.extent)],
               **tables(eng))
    journal.commit(recs)
    return obs


def test_rebuild_bit_identical_including_mid_crossing_journal(monkeypatch):
    """The rebuild seeds every slot from where the entity's data lives:
    the failover journal's in-flight dst outranks the placement ledger.
    Seeds, the rebuilt entity, query and sub tables and the verify are
    the JAX package's."""
    got = both(monkeypatch, mid_crossing_rebuild)
    assert got["verify"] == [] and got["pending"] == START + 1
    seeds = dict(got["seeds"])
    assert sorted(seeds.values()) == [0, 1]
    assert got["cells"].count(1) == 1 and got["cells"].count(0) == 1


def nan_in_shadow(pkg: str, clock: FixedClock) -> dict:
    ctl, (sa, _) = make_world(pkg)
    eid = ENTITY_START + 1
    add_entity(pkg, ctl, sa, eid, 50, 50)
    ctl.engine.update_entity(eid, float("nan"), 0.0, 50.0)
    tick(ctl, clock)
    arm(pkg, {"seed": 9, "faults": [{"point": "device.nan", "every_n": 1, "max_fires": 1}]})
    tick(ctl, clock)
    disarm(pkg)
    return dict(ledgers(pkg), **tables(ctl.engine))


def test_rebuild_verifies_with_nan_position_in_shadow(monkeypatch):
    """A NaN coordinate in the host shadow round-trips the rebuild's
    verify: one corruption recovery, ACTIVE, as the JAX guard."""
    got = both(monkeypatch, nan_in_shadow)
    assert got["recoveries"] == {"corruption": 1} and got["state"] == "ACTIVE"


def seed_from_position(pkg: str, clock: FixedClock) -> dict:
    ctl, _ = make_world(pkg)
    eid = ENTITY_START + 3
    ctl.engine.add_entity(eid, 150, 0, 50)  # device-only registration
    ctl._last_positions[eid] = mod(pkg, "spatial.controller").SpatialInfo(150, 0, 50)
    seeds = ctl.rebuild_seed_cells()
    ctl.engine.rebuild_device_state(seeds)
    return dict(seeds=sorted(seeds.items()), verify=ctl.engine.verify_device_state(seeds),
                **tables(ctl.engine))


def test_rebuild_seed_falls_back_to_position(monkeypatch):
    """An entity with neither a journal record nor a placement-ledger
    row seeds from its last known position (cell 1), and the rebuilt
    tables are the JAX package's."""
    got = both(monkeypatch, seed_from_position)
    assert list(dict(got["seeds"]).values()) == [1] and got["verify"] == []


# ---- outages ----------------------------------------------------------------


def failed_rebuild(pkg: str, clock: FixedClock) -> dict:
    ctl, (sa, _) = make_world(pkg)
    add_entity(pkg, ctl, sa, ENTITY_START + 1, 50, 50)
    tick(ctl, clock)
    arm(pkg, {"seed": 5, "faults": [
        {"point": "device.nan", "every_n": 1, "max_fires": 1},
        {"point": "device.rebuild_fail", "every_n": 1, "max_fires": 1}]})
    tick(ctl, clock)
    gov = governor(pkg)
    down = (guard(pkg).state.name, int(gov.level), gov._level_floor)
    seen = tick_until_active(pkg, ctl, clock)
    disarm(pkg)
    tick(ctl, clock)
    return dict(ledgers(pkg), down=down, seen=seen, **tables(ctl.engine))


def test_rebuild_failure_retries_on_backoff(monkeypatch):
    """``device.rebuild_fail`` fails the first rebuild: FAILED, held
    with the ladder at L2, then the next eligible tick rebuilds; the
    same transitions, held ticks and rebuilt tables as the JAX guard."""
    got = both(monkeypatch, failed_rebuild)
    assert got["down"] == ("FAILED", 2, 2)
    assert got["failures"] == {"corruption": 1, "rebuild_fail": 1}
    assert got["recoveries"] == {"corruption": 1} and got["state"] == "ACTIVE"


def crossing_during_outage(pkg: str, clock: FixedClock) -> dict:
    ctl, (sa, _) = make_world(pkg)
    eid = ENTITY_START + 1
    ech = add_entity(pkg, ctl, sa, eid, 50, 50)
    handovers = []
    real = ctl.engine.handover_list
    ctl.engine.handover_list = lambda result: handovers.append(real(result)) or handovers[-1]
    tick(ctl, clock)
    arm(pkg, {"seed": 6, "faults": [
        {"point": "device.nan", "every_n": 1, "max_fires": 1},
        {"point": "device.rebuild_fail", "every_n": 1, "max_fires": 1}]})
    tick(ctl, clock)
    down = guard(pkg).state.name
    ech.data.on_update(entity_data(pkg, eid, 150, 50), 0, sa.id, ctl)  # moves while down
    seen = tick_until_active(pkg, ctl, clock)
    disarm(pkg)
    tick(ctl, clock)  # the rebuilt engine re-detects 0 -> 1
    channel_mod = mod(pkg, "core.channel")
    channel_mod.get_channel(START).tick_once(0)
    channel_mod.get_channel(START + 1).tick_once(0)
    counts = host(ctl.engine.last_result["cell_counts"]).tolist()
    return dict(ledgers(pkg), down=down, seen=seen, handovers=handovers, counts=counts,
                src=entities_of(pkg, START), dst=entities_of(pkg, START + 1))


def test_crossing_during_outage_redetected_after_rebuild(monkeypatch):
    """An entity that crosses while the engine is down is re-detected
    from the reseeded baseline: zero loss, zero duplication, the same
    crossings and counts as the JAX gateway."""
    got = both(monkeypatch, crossing_during_outage)
    assert got["down"] == "FAILED" and got["state"] == "ACTIVE"
    assert got["handovers"][-1] == [(ENTITY_START + 1, 0, 1)]
    assert got["src"] == [] and got["dst"] == [ENTITY_START + 1]
    assert got["counts"] == [0, 1]


def pinned_ladder(pkg: str, clock: FixedClock) -> dict:
    ctl, (sa, _) = make_world(pkg)
    add_entity(pkg, ctl, sa, ENTITY_START + 1, 50, 50)
    tick(ctl, clock)
    gov = governor(pkg)
    before = (int(gov.level), gov._level_floor)
    arm(pkg, {"seed": 7, "faults": [
        {"point": "device.nan", "every_n": 1, "max_fires": 1},
        {"point": "device.rebuild_fail", "every_n": 1, "max_fires": 3}]})
    tick(ctl, clock)
    down = (guard(pkg).state.name, int(gov.level), gov._level_floor)
    gov._step_ladder(settings(pkg))  # cannot step below the floor while down
    stepped = int(gov.level)
    seen = tick_until_active(pkg, ctl, clock)
    disarm(pkg)
    return dict(ledgers(pkg), before=before, down=down, stepped=stepped, seen=seen,
                after=(int(gov.level), gov._level_floor))


def test_outage_pins_overload_ladder_until_recovery(monkeypatch):
    """Three failed rebuilds hold the ladder at L2 on every tick of the
    outage; recovery releases the floor. Every tick's (state, level,
    floor) is the JAX gateway's."""
    got = both(monkeypatch, pinned_ladder)
    assert got["before"] == (0, 0) and got["down"] == ("FAILED", 2, 2) and got["stepped"] == 2
    assert all(level >= 2 and floor == 2 for state, level, floor in got["seen"] if state != "ACTIVE")
    assert got["failures"]["rebuild_fail"] == 3 and got["after"][1] == 0


def snapshots(pkg: str, clock: FixedClock, tmp_path) -> dict:
    from channeld_tpu_torch.protocol import snapshot_pb2  # one descriptor for both packages

    ctl, (sa, _) = make_world(pkg)
    add_entity(pkg, ctl, sa, ENTITY_START + 1, 50, 50)
    tick(ctl, clock)
    path = tmp_path / f"{pkg}.snap"
    settings(pkg).snapshot_path = str(path)
    g, written = guard(pkg), []
    real = g._snapshot

    def recorded(reason, sync=False):
        real(reason, sync=sync)
        snap = snapshot_pb2.GatewaySnapshot()
        snap.ParseFromString(path.read_bytes())
        written.append((reason, sync, sorted(c.channelId for c in snap.channels)))

    g._snapshot = recorded
    try:
        arm(pkg, {"seed": 8, "faults": [{"point": "device.nan", "every_n": 1, "max_fires": 1}]})
        tick(ctl, clock)
        disarm(pkg)
    finally:
        del g._snapshot
    return dict(ledgers(pkg), written=written)


def test_snapshots_on_fatal_and_recovery(monkeypatch, tmp_path):
    """A fatal snapshots at once (synchronously, before the rebuild) and
    the completed rebuild snapshots again; each reads back with the same
    channels as the JAX gateway's."""
    got = both(monkeypatch, snapshots, tmp_path=tmp_path)
    assert [w[:2] for w in got["written"]] == [("device_fatal", True), ("device_recovered", False)]
    assert got["written"][0][2] == got["written"][1][2] and len(got["written"][0][2]) > 2


def transient(pkg: str, clock: FixedClock) -> dict:
    ctl, (sa, _) = make_world(pkg)
    add_entity(pkg, ctl, sa, ENTITY_START + 1, 50, 50)
    tick(ctl, clock)
    arm(pkg, {"seed": 1, "faults": [{"point": "device.step_error", "every_n": 1, "max_fires": 2}]})
    tick(ctl, clock)
    gov = governor(pkg)
    down = (guard(pkg).state.name, int(gov.level), gov._level_floor)
    seen = tick_until_active(pkg, ctl, clock)
    disarm(pkg)
    return dict(ledgers(pkg), down=down, seen=seen, floor=gov._level_floor)


def test_transient_errors_retry_without_rebuild(monkeypatch):
    """Two transient step errors: DEGRADED with the ladder pinned, two
    backoff retries, one transient recovery and no rebuild, on the same
    ticks as the JAX guard."""
    got = both(monkeypatch, transient)
    assert got["down"] == ("DEGRADED", 2, 2)
    assert got["failures"] == {"step_error": 2} and got["recoveries"] == {"transient": 1}
    assert ("DEGRADED", "REBUILDING") not in got["transitions"] and got["floor"] == 0


def hang(pkg: str, clock: FixedClock) -> dict:
    ctl, (sa, _) = make_world(pkg)
    add_entity(pkg, ctl, sa, ENTITY_START + 1, 50, 50)
    tick(ctl, clock)
    settings(pkg).device_step_deadline_s = 0.1
    arm(pkg, {"seed": 3, "faults": [
        {"point": "device.step_hang", "every_n": 1, "max_fires": 1, "stall_ms": 300}]})
    gen = ctl.engine.generation
    zombies = []
    dg = mod(pkg, "core.device_guard")
    real_log = dg._log_zombie
    dg._log_zombie = lambda fut: zombies.append(repr(fut.exception())) or real_log(fut)
    try:
        t0 = time.perf_counter()
        tick(ctl, clock)
        waited = time.perf_counter() - t0
        settings(pkg).device_step_deadline_s = 60.0
        end = time.perf_counter() + 5.0
        while not zombies and time.perf_counter() < end:
            time.sleep(0.01)
    finally:
        dg._log_zombie = real_log
    disarm(pkg)
    tick(ctl, clock)
    return dict(ledgers(pkg), zombies=zombies, fenced=ctl.engine.generation - gen,
                waited_under_stall=waited < 0.3, **tables(ctl.engine))


def test_hang_watchdog_fences_off_the_zombie(monkeypatch):
    """A step stalled past a 0.1 s deadline is abandoned; the tick does
    not wait the stall out, the engine rebuilds (cause hang) and serves,
    and the zombie raises on the stale generation: the same ledgers and
    generation moves as the JAX guard."""
    got = both(monkeypatch, hang)
    assert got["recoveries"] == {"hang": 1} and got["state"] == "ACTIVE"
    assert got["waited_under_stall"] and "stale device tick" in got["zombies"][0]
    assert got["fenced"] == 2  # the watchdog's bump, then the rebuild's


def test_a_polled_rebuild_keeps_the_writes_made_while_it_ran(monkeypatch):
    """A rebuild that outlasts the guard's per-tick wait (its uploads
    queued behind a wedged stream; here the worker's first upload copies
    its host column, then waits 0.3 s) is polled while the loop thread
    goes on ticking, and an entity crosses meanwhile. The rebuild uploads
    the host shadow as the loop thread copied it before handing the
    rebuild over, and the move stays dirty: the rebuild verifies clean
    at the first try (no ``rebuild_fail``), and the next tick hands the
    entity over. (The JAX guard reads the shadow on its worker and
    clears the dirty marks after its uploads: ROADMAP F13.)"""
    clock = FixedClock(monkeypatch)
    boot(PORT, clock)
    ctl, (sa, _) = make_world(PORT)
    mover, still = ENTITY_START + 1, ENTITY_START + 2
    ech = add_entity(PORT, ctl, sa, mover, 50, 50)
    add_entity(PORT, ctl, sa, still, 30, 50)
    tick(ctl, clock)
    eng, g = ctl.engine, guard(PORT)
    loop_thread = threading.current_thread()
    real_upload, wedge = eng._upload, []

    def queued_upload(arr):
        out = real_upload(arr)
        if threading.current_thread() is not loop_thread and not wedge:
            wedge.append(arr.shape)
            time.sleep(0.3)
        return out

    monkeypatch.setattr(eng, "_upload", queued_upload)
    settings(PORT).device_step_deadline_s = 0.1
    arm(PORT, {"seed": 11, "faults": [{"point": "device.nan", "every_n": 1, "max_fires": 1}]})
    tick(ctl, clock)
    disarm(PORT)
    assert g.state.name == "REBUILDING"  # still uploading: polled from the next tick
    ech.data.on_update(entity_data(PORT, mover, 150, 50), 0, sa.id, ctl)
    polls = 0
    while g.state.name != "ACTIVE" and polls < 100:
        tick(ctl, clock)
        polls += 1
    monkeypatch.setattr(eng, "_upload", real_upload)
    assert g.state.name == "ACTIVE" and polls > 1
    assert g.failure_counts == {"corruption": 1} and g.recovery_counts == {"corruption": 1}
    tick(ctl, clock)
    for cid in (START, START + 1):
        mod(PORT, "core.channel").get_channel(cid).tick_once(0)
    assert entities_of(PORT, START) == [still] and entities_of(PORT, START + 1) == [mover]


# ---- the device soak's schedule through both gateways ----------------------

# Ticks of the device soak's faults on the fixed clock: tick 0 clean; the
# transient errors on ticks 1 and 5 (the 100 and 200 ms backoffs hold 2-4
# and 6-11; 12 serves); the hang on 14 (its first rebuild fails, the
# 200 ms backoff holds 15-20, 21 rebuilds, 22 serves); the corruption on
# 24 (rebuilt in that tick, 25 serves); two steady ticks after.
ERROR_TICK, HANG_TICK, NAN_TICK, SOAK_TICKS = 1, 14, 24, 28
HANG_DEADLINE_S, HANG_STALL_MS = 0.1, 300.0


class FaultWorld(World):
    """test_torch_gateway's World on the device soak's schedule: a storm
    of a quarter of the entities into one cell on each fault tick (so
    crossings are in flight), dispersed two ticks later; the watchdog's
    deadline cut to HANG_DEADLINE_S on the hang tick only; each tick also
    records whether the guard served it, the ladder, and every snapshot
    the guard wrote (read back)."""

    def __init__(self, pkg, clock, entities, sim, snapshot_path, monkeypatch):
        self.storms = (ERROR_TICK, HANG_TICK, NAN_TICK)
        super().__init__(pkg, clock, entities, sim)
        s = settings(pkg)
        s.device_retry_backoff_ms = 100  # the gateway's default
        s.snapshot_path = snapshot_path
        self.snapshots = []
        self.verified = []
        g = guard(pkg)
        real_snapshot = g._snapshot

        def recorded_snapshot(reason, sync=False):
            real_snapshot(reason, sync=sync)
            snap = mod(pkg, "core.snapshot").load_snapshot(snapshot_path)
            self.snapshots.append((reason, sorted(c.channelId for c in snap.channels)))

        monkeypatch.setattr(g, "_snapshot", recorded_snapshot)
        real_verify = self.eng.verify_device_state
        monkeypatch.setattr(self.eng, "verify_device_state",
                            lambda seeds: self.verified.append(real_verify(seeds)) or self.verified[-1])
        scrape = mod(pkg, "chaos.invariants").scrape
        self.metrics_at_boot = scrape(mod(pkg, "core.metrics").registry)
        arm(pkg, chip_smoke().fault_ticks_scenario(ERROR_TICK, HANG_TICK, NAN_TICK,
                                                   stall_ms=HANG_STALL_MS))

    def drive(self, t: int) -> None:
        x0, z0, x1, z1 = self.bounds
        rng = self.rng
        if t in self.storms:
            self.crowd = rng.sample(self.entity_ids, len(self.entity_ids) // 4)
            for eid in self.crowd:
                self.move(eid, rng.uniform(-45.0, -5.0), rng.uniform(5.0, 45.0))
            return
        if t - 2 in self.storms:
            for eid in self.crowd:
                self.move(eid, rng.uniform(x0, x1), rng.uniform(z0, z1))
            return
        for eid in rng.sample(self.entity_ids, len(self.entity_ids) // 3):
            x, z = self.positions[eid]
            self.move(eid, min(max(x + rng.uniform(-15, 15), x0), x1),
                      min(max(z + rng.uniform(-15, 15), z0), z1))

    def tick(self, t: int) -> dict:
        s = settings(self.pkg)
        s.device_step_deadline_s = HANG_DEADLINE_S if t == HANG_TICK else 60.0
        self.eng.last_result = None  # set again only by a tick the guard ran
        obs = super().tick(t)
        gov = governor(self.pkg)
        obs["ladder"] = (int(gov.level), gov._level_floor)
        obs["served"] = self.eng.last_result is not None
        return obs

    def census(self) -> dict:
        """The soak's zero-loss invariants: every entity in exactly one
        spatial channel's table, still tracked by the engine, and the
        placement ledger naming that channel."""
        chans = mod(self.pkg, "core.channel").all_channels()
        placed: dict[int, list] = {}
        for cid in self.spatial:
            for eid in chans[cid].get_data_message().entities:
                placed.setdefault(eid, []).append(cid)
        return dict(
            misplaced=[e for e in self.entity_ids if len(placed.get(e, [])) != 1],
            untracked=[e for e in self.entity_ids if self.eng.slot_of_entity(e) is None],
            ledger_off=[e for e in self.entity_ids
                        if self.ctl._data_cell.get(e) != placed.get(e, [None])[0]])

    def metric_deltas(self) -> dict:
        inv = mod(self.pkg, "chaos.invariants")
        d = inv.delta(inv.scrape(mod(self.pkg, "core.metrics").registry), self.metrics_at_boot)
        g = guard(self.pkg)
        return dict(
            recoveries={c: inv.sample_total(d, "device_recoveries_total", cause=c)
                        for c in g.recovery_counts},
            failures={c: inv.sample_total(d, "device_step_failures_total", cause=c)
                      for c in g.failure_counts})


def soak_legs(monkeypatch, tmp_path, entities: int, sim: bool) -> dict:
    clock = FixedClock(monkeypatch)
    legs = {}
    for pkg in PKGS:
        world = FaultWorld(pkg, clock, entities, sim, str(tmp_path / f"{pkg}.snap"), monkeypatch)
        legs[pkg] = [world.tick(t) for t in range(SOAK_TICKS)]
        disarm(pkg)
        legs[pkg + ".world"] = world
    return legs


def test_device_soak_schedule_holds_the_soak_invariants(monkeypatch, tmp_path):
    """The device soak (tests/test_device_guard.py::test_device_smoke_soak's
    schedule, on a fixed clock) through the JAX gateway and the port's,
    with the sim plane's agents on: both legs recover transient, hang and
    corruption once each, every rebuild verifies clean, no entity is
    lost or duplicated, the ledgers equal the metrics, the ladder is
    pinned at L2 through each outage and released, the fatal and
    recovery snapshots read back; and the two gateways agree on all of
    it, on the same ticks."""
    legs = soak_legs(monkeypatch, tmp_path, entities=80, sim=True)
    report = {}
    for pkg in PKGS:
        world, obs = legs[pkg + ".world"], legs[pkg]
        g = guard(pkg)
        assert g.state.name == "ACTIVE", pkg
        assert g.recovery_counts == {"transient": 1, "hang": 1, "corruption": 1}, pkg
        assert g.failure_counts == {"step_error": 2, "hang": 1, "rebuild_fail": 1,
                                    "corruption": 1}, pkg
        assert world.metric_deltas() == dict(recoveries=g.recovery_counts,
                                             failures=g.failure_counts), pkg
        assert world.verified and all(v == [] for v in world.verified), (pkg, world.verified)
        assert world.census() == dict(misplaced=[], untracked=[], ledger_off=[]), pkg
        down = [o["ladder"] for o in obs if o["guard"][0] != "ACTIVE"]
        assert down and all(level >= 2 and floor == 2 for level, floor in down), (pkg, down)
        assert obs[-1]["ladder"][1] == 0
        assert max(g.recovery_times_s) <= settings(pkg).device_recovery_deadline_s
        assert [r for r, _ in world.snapshots] == ["device_fatal", "device_recovered"] * 2, pkg
        report[pkg] = dict(ledgers(pkg), served=[o["served"] for o in obs],
                           ladder=[o["ladder"] for o in obs],
                           snapshots=world.snapshots, times=list(g.recovery_times_s),
                           crossings=[len(h) for o in obs for h in o["handovers"]])
    assert report[PORT] == report[JAX], first_difference(report[JAX], report[PORT])
    served = report[PORT]["served"]
    assert served.count(False) == 11 + 8 + 1  # ticks 1-11, 14-21 and 24 (see the schedule)


def test_port_gateway_equals_jax_gateway_through_the_fault_schedule(monkeypatch, tmp_path):
    """The same schedule, without the sim plane, compared tick for tick:
    handovers, spatial tables, every outbound stream, changed query rows
    and epochs, due slots, the guard tuple, the ladder and whether the
    tick was served, on every tick of the outages and after."""
    legs = soak_legs(monkeypatch, tmp_path, entities=160, sim=False)
    for t, (want, got) in enumerate(zip(legs[JAX], legs[PORT])):
        assert got == want, f"tick {t}: {first_difference(want, got)}"
    port = legs[PORT]
    assert [o["served"] for o in port].count(False) == 20
    assert sum(len(h) for o in port[NAN_TICK + 1:] for h in o["handovers"]) > 0
    assert port[-1]["guard"][:3] == ("ACTIVE", {"transient": 1, "hang": 1, "corruption": 1},
                                     {"step_error": 2, "hang": 1, "rebuild_fail": 1,
                                      "corruption": 1})


# ---- a real wedge on the card ----------------------------------------------


def calibrate_sleep_cycles(seconds: float) -> int:
    """``torch.cuda._sleep`` cycles worth ``seconds`` on this card, from
    a timed short sleep."""
    probe = 20_000_000
    torch.cuda._sleep(probe)  # warm the clocks
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    stop.record()
    stop.synchronize()
    return int(probe * seconds * 1e3 / start.elapsed_time(stop))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["readback", "flush"])
def test_a_real_wedge_heals_behind_the_generation_fence(where):
    """A kernel that keeps the card busy 3.5 s inside the guarded window
    (queued after the tick's kernels, so the readback overruns the 2 s
    deadline; or before them, so the tick's own upload waits) is
    abandoned as a hang; the rebuild, queued behind the wedge on the
    same stream, completes once it drains; the zombie's late tick never
    commits over the rebuilt state; K1's counts stay exact on the next
    two ticks, and no entity is lost."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K

    boot(PORT, None, device="cuda")
    s = settings(PORT)
    s.tpu_entity_capacity = 1 << 14
    s.device_step_deadline_s = 2.0
    s.device_retry_backoff_ms = 100
    ctl, (sa, sb) = make_world(PORT)
    rng = Random(7)
    ids = [ENTITY_START + 1 + i for i in range(2000)]
    channels = {eid: add_entity(PORT, ctl, (sa, sb)[i % 2], eid, rng.uniform(1, 199),
                                rng.uniform(1, 99)) for i, eid in enumerate(ids)}
    eng, g = ctl.engine, guard(PORT)
    dg = mod(PORT, "core.device_guard")

    def step():
        for eid in rng.sample(ids, 200):
            channels[eid].data.on_update(
                entity_data(PORT, eid, rng.uniform(1, 199), rng.uniform(1, 99)), 0,
                channels[eid].get_owner().id, ctl)
        ctl.tick()
        for cid in (START, START + 1):
            mod(PORT, "core.channel").get_channel(cid).tick_once(0)

    for _ in range(3):
        step()
    cycles = calibrate_sleep_cycles(3.5)
    real_tick, wedged = eng.tick, []

    def wedged_tick(*a, **k):
        if wedged:
            return real_tick(*a, **k)
        wedged.append(time.perf_counter())
        if where == "flush":
            torch.cuda._sleep(cycles)
            return real_tick(*a, **k)
        out = real_tick(*a, **k)
        torch.cuda._sleep(cycles)
        return out

    zombies, verified = [], []
    real_log, real_verify = dg._log_zombie, eng.verify_device_state
    eng.tick = wedged_tick
    eng.verify_device_state = lambda seeds: verified.append(real_verify(seeds)) or verified[-1]
    dg._log_zombie = lambda fut: zombies.append(repr(fut.exception())) or real_log(fut)
    try:
        step()
        assert g.failure_counts.get("hang") == 1 and g.state.name != "ACTIVE"
        polled = 0
        end = time.perf_counter() + 30.0
        while g.state.name != "ACTIVE" and time.perf_counter() < end:
            step()
            polled += 1
        assert g.state.name == "ACTIVE", g.report()
        healed = time.perf_counter() - wedged[0]
        end = time.perf_counter() + 10.0
        while not zombies and time.perf_counter() < end:
            time.sleep(0.01)
        counts = []
        for _ in range(2):
            step()
            want = K.assign_and_count_plain(eng.grid, eng._d_positions, eng._d_valid)[1]
            counts.append(torch.equal(eng.last_result["cell_counts"], want))
    finally:
        eng.tick, eng.verify_device_state, dg._log_zombie = real_tick, real_verify, real_log
        g.shutdown()
    assert g.recovery_counts == {"hang": 1}, g.report()
    assert g.failure_counts == {"hang": 1}, g.report()
    assert healed >= 3.0, healed  # the rebuild waited for the wedge
    assert verified == [[]] and counts == [True, True]
    assert zombies, "the abandoned step never finished"
    if where == "flush":
        assert "stale device tick" in zombies[0], zombies
    placed = {}
    for cid in (START, START + 1):
        for eid in entities_of(PORT, cid):
            placed[eid] = placed.get(eid, 0) + 1
    assert all(placed.get(e) == 1 for e in ids) and all(eng.slot_of_entity(e) is not None for e in ids)
    assert polled >= 1
