"""The crash soak through the port's GPU controller, held against the JAX
package: a gateway on the device controller killed mid-burst, restarted
from its snapshot and WAL, reclaiming and then yielding its shard.

``chip_smoke.py``'s phase 16 keeps (the test loads chip_smoke.py by path):

- the lockstep crash world (``CrashWorld``, 16a): gateway "b" of
  scripts/crash_soak.py's world (WORLD_SPATIAL on the device controller,
  the sim plane, the query plane and the device guard on, the WAL and the
  snapshot armed as ``wal_settings_hook("b")`` arms them) with gateway "a",
  the leader, a scripted stub behind a tapped trunk link, written against
  one package's modules (``gateway_modules(pkg)``). Here at a small size
  (256 slots, 32 query rows, 6 entities a side, 8 agents, 2 sensors, 2
  commits each way, a kill burst of 4), 150 ticks of a fixed clock through
  the JAX package (``TPUSpatialController`` on the CPU) and the port on
  ``cpu``: every tick's handovers, tables (the humans' rows), placement
  ledger, engine slots, cells and counts, agents, changed query rows,
  ledgers, snapshot and the stub's holdings equal exactly; every trunk
  message, frame of every outbound stream, record of the WAL's durable
  prefix and agent row of the cells' tables the same bytes, or, where it
  carries an agent, equal when parsed by the JAX package's schemas with
  its floats within the ulp bound that ``tests/test_torch_sim.py`` states
  (the agents' sim columns too); each restart's replay report, the
  events, the census (zero lost, zero duplicated across b and the stub)
  and the ledgers against their metrics hold on both packages. The JAX
  legs run the port's fixes of F22 and F23 (``reference_with_port_fixes``);
  the port's fixes are held to the census and the cells that the JAX
  package decodes from each kill's WAL and snapshot; the reference as it
  is equals the port up to the first restart, and the tests named after
  each fault show it failing after;
- the ``--cpu-leg`` child: the leg its parent sized, as run in process;
- the port's copies of scripts/crash_soak.py's parameters, world and WAL
  settings: equal to the script's own, loaded by path;
- the ``--crash-child`` role (16b's gateway "b"): it boots, and leaves no
  module of JAX or of the JAX package in its process;
- each checker names the check a report breaks.

No live multi-process soak runs here (phase 16 runs 16b on the card). One
``cuda`` case runs 16a small on the card against its CPU leg.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
import types
from types import SimpleNamespace

import pytest
import torch

from test_torch_elastic import REPO, chip_smoke
from test_torch_fleet import UNCOMPARED, assert_columns_close, script
from test_torch_gateway import JAX, PORT, port_globals
from test_torch_sim import tol

CPU = torch.device("cpu")
SMALL = dict(entity_capacity=256, query_capacity=32, entities=6, agents=8, sensors=2, commits=2,
             burst=4, parked=2, deadline_s=60.0, columns=True)
CRASH_EXTENT = 100.0  # WORLD_SPATIAL spans x and z in [-100, 100)
EVENTS = ("inbound_commit_tracked_at_cell_centres", "outbound_commit_untracked",
          "kill_1_in_flight_batches_aborted_at_the_stub",
          "restart_1_residents_retracked_at_cell_centres", "restart_1_sensor_rows_restored",
          "restart_1_sim_census_restored", "restart_1_replayed_snapshot_and_wal", "reclaimed",
          "abort_notices_purged_the_applied_copy",
          "parked_crossings_reoffered_from_the_card_and_committed",
          "stub_burst_reoffered_and_committed", "wal_torn_and_writer_wedged",
          "kill_2_in_flight_batches_aborted_at_the_stub",
          "restart_2_residents_retracked_at_cell_centres", "restart_2_sensor_rows_restored",
          "restart_2_sim_census_restored", "restart_2_replayed_snapshot_and_wal",
          "restart_2_torn_tail_truncated", "yield_dropped_copies_leave_the_card_in_the_same_tick",
          "yield_missing_ids_handed_over_the_trunk", "yielded")
_LEGS: dict = {}


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield


def rebind(fn, module):
    """``fn``'s code against ``module``'s globals."""
    return types.FunctionType(fn.__code__, module.__dict__, fn.__name__, fn.__defaults__)


def reference_with_port_fixes(monkeypatch) -> None:
    """The JAX package with the port's fixes of the two faults phase 16
    found in it: a census that a boot replay stages after the sim plane
    went live goes into that plane (ROADMAP F22: the reference leaves it
    staged, and the restarted gateway runs a fresh spawn), and a replay's
    re-tracked entities get their device baseline cell (F23: in the
    reference a move before the first tick after the restart crosses
    unseen). The tests of each fault hold the port's fix to values decoded
    from the journal instead."""
    jplane, pplane = (importlib.import_module(f"{p}.sim.plane") for p in (JAX, PORT))
    jctl = importlib.import_module(f"{JAX}.spatial.controller")
    for name in ("take_census", "_seed_census", "_adopt"):
        monkeypatch.setattr(jplane.SimPlane, name,
                            rebind(getattr(pplane.SimPlane, name), jplane), raising=False)
    monkeypatch.setattr(jplane.SimAuthority, "reset_pending",
                        lambda self: setattr(self, "_pending", []), raising=False)
    staged = jplane.restore_census

    def restore_census(rec, source="wal replay"):
        n = staged(rec, source)
        plane = getattr(jctl.get_spatial_controller(), "simplane", None)
        if n and plane is not None:
            plane.take_census()
        return n

    monkeypatch.setattr(jplane, "restore_census", restore_census)
    jwal, pwal = (importlib.import_module(f"{p}.core.wal") for p in (JAX, PORT))
    monkeypatch.setattr(jwal, "_reseed_controller", rebind(pwal._reseed_controller, jwal))


def crash_leg(pkg: str, tmp_path, monkeypatch=None, fixes: bool = True) -> tuple:
    """16a small through one package (cached per process: several tests
    read the same legs)."""
    key = (pkg, fixes)
    if key not in _LEGS:
        cs = chip_smoke()
        if pkg == JAX and fixes:
            reference_with_port_fixes(monkeypatch)
        try:
            _LEGS[key] = cs.run_crash_leg(cs.gateway_modules(pkg), CPU, cs.crash_size(**SMALL),
                                          str(tmp_path))
        finally:
            if monkeypatch is not None:
                monkeypatch.undo()
    return _LEGS[key]


def compared(obs: dict) -> dict:
    """One tick's observations without the digests of what may carry the
    agents' sim floats (the agents' table rows, the WAL, every outbound
    stream, the trunk messages): streams as message counts, the trunk as
    types and lengths. ``assert_raw_close`` holds their content."""
    out = {k: v for k, v in obs.items() if k not in UNCOMPARED + ("agent_rows", "wal", "raw")}
    out["sent"] = {c: (n, "") for c, (n, _) in obs["sent"].items()}
    out["trunk"] = {gw: [m[:2] for m in msgs] for gw, msgs in obs["trunk"].items()}
    return out


def jax_module(name: str):
    return importlib.import_module(f"{JAX}.{name}")


def repeated(f) -> bool:
    from google.protobuf.descriptor import FieldDescriptor as F

    return f.is_repeated if hasattr(f, "is_repeated") else f.label == F.LABEL_REPEATED


def agent_ids_in(msg, base: int) -> set:
    """The agent ids (base and above) among a message's integer fields and
    map keys, nested messages and Any payloads included."""
    from google.protobuf.descriptor import FieldDescriptor as F

    found = set()
    for f, v in msg.ListFields():
        if f.message_type is not None and f.message_type.GetOptions().map_entry:
            found |= {k for k in v if isinstance(k, int) and k >= base}
            vf = f.message_type.fields_by_name["value"]
            values = list(v.values()) if vf.message_type is not None else []
        elif repeated(f):
            values = list(v)
        else:
            values = [v]
        for x in values:
            if f.type == F.TYPE_MESSAGE:
                inner = jax_module("utils.anyutil").unpack_any(x) \
                    if x.DESCRIPTOR.full_name == "google.protobuf.Any" else x
                found |= agent_ids_in(inner, base)
            elif isinstance(x, int) and not isinstance(x, bool) and x >= base:
                found.add(x)
    return found


def assert_messages_close(w, g, atol: float, where: str) -> None:
    """Two messages of one schema equal field by field, float fields within
    ``atol``, Any payloads unpacked and held the same way."""
    from google.protobuf.descriptor import FieldDescriptor as F

    assert w.DESCRIPTOR.full_name == g.DESCRIPTOR.full_name, where
    if w.DESCRIPTOR.full_name == "google.protobuf.Any":
        assert w.type_url == g.type_url, where
        unpack = jax_module("utils.anyutil").unpack_any
        return assert_messages_close(unpack(w), unpack(g), atol, where)
    wf, gf = dict(w.ListFields()), dict(g.ListFields())
    assert [f.name for f in wf] == [f.name for f in gf], where
    for f, v in wf.items():
        u, at = gf[f], f"{where}.{f.name}"
        if f.message_type is not None and f.message_type.GetOptions().map_entry:
            assert sorted(v) == sorted(u), at
            pairs = [(v[k], u[k]) for k in sorted(v)]
            vf = f.message_type.fields_by_name["value"]
            kind = F.TYPE_MESSAGE if vf.message_type is not None else vf.type
        else:
            pairs = list(zip(v, u)) if repeated(f) else [(v, u)]
            if repeated(f):
                assert len(v) == len(u), at
            kind = f.type
        for x, y in pairs:
            if kind == F.TYPE_MESSAGE:
                assert_messages_close(x, y, atol, at)
            elif kind in (F.TYPE_FLOAT, F.TYPE_DOUBLE):
                assert abs(x - y) <= atol or x == y, (at, x, y, atol)
            else:
                assert x == y, (at, x, y)


def assert_same_or_agents_close(w: bytes, g: bytes, cls, base: int, atol: float,
                                where: str) -> None:
    """One serialized message: the same bytes, or one that carries an agent
    id and equals field by field with its floats within ``atol``."""
    if w == g:
        return
    assert cls is not None, f"{where}: bytes differ and no schema to parse them"
    wm, gm = cls(), cls()
    wm.ParseFromString(w)
    gm.ParseFromString(g)
    assert agent_ids_in(wm, base), f"{where}: differs but carries no agent"
    assert_messages_close(wm, gm, atol, where)


def wal_records(blob: bytes, tmp_path) -> list:
    path = tmp_path / "wal.bin"
    path.write_bytes(blob)
    return jax_module("core.wal").read_wal_records(str(path), truncate=False)[0]


def assert_raw_close(w: dict, g: dict, t: int, base: int, tmp_path) -> None:
    """What one tick's digests fold, JAX against the port, parsed by the JAX
    package's schemas: every trunk message, every frame of every outbound
    stream, every record of the WAL's durable prefix and every agent row of
    the cells' tables the same bytes, or, where it carries an agent, equal
    field by field with its floats within the ulp bound of the world's
    scale per sim pass."""
    atol = (t + 1) * tol(CRASH_EXTENT)
    trunk = jax_module("federation.trunk").TRUNK_MESSAGES
    templates = importlib.import_module(f"{JAX}.protocol").MESSAGE_TEMPLATES
    assert [m[0] for m in w["trunk"]] == [m[0] for m in g["trunk"]], f"tick {t}: trunk types"
    for i, ((tp, x), (_, y)) in enumerate(zip(w["trunk"], g["trunk"])):
        assert_same_or_agents_close(x, y, trunk.get(tp), base, atol, f"tick {t} trunk {i} ({tp})")
    assert sorted(w["frames"]) == sorted(g["frames"]), f"tick {t}: connections"
    for conn, frames in w["frames"].items():
        assert [f[:2] for f in frames] == [f[:2] for f in g["frames"][conn]], \
            f"tick {t}: connection {conn}'s frames"
        for i, ((tp, _, x), (_, _, y)) in enumerate(zip(frames, g["frames"][conn])):
            assert_same_or_agents_close(x, y, templates.get(tp), base, atol,
                                        f"tick {t} connection {conn} frame {i} ({tp})")
    assert len(w["wal"]) == len(g["wal"]), f"tick {t}: WAL length"
    wr, gr = wal_records(w["wal"], tmp_path), wal_records(g["wal"], tmp_path)
    assert [(r.seq, r.kind) for r in wr] == [(r.seq, r.kind) for r in gr], f"tick {t}: WAL"
    cls = type(wr[0]) if wr else None
    for x, y in zip(wr, gr):
        assert_same_or_agents_close(x.SerializeToString(deterministic=True),
                                    y.SerializeToString(deterministic=True), cls, base, atol,
                                    f"tick {t} WAL record {x.seq} ({x.kind})")
    assert [r[:2] for r in w["agent_rows"]] == [r[:2] for r in g["agent_rows"]], \
        f"tick {t}: agent rows"
    state = jax_module("models.sim_pb2").EntityState
    for (cid, eid, x), (_, _, y) in zip(w["agent_rows"], g["agent_rows"]):
        assert_same_or_agents_close(x, y, state, base, atol, f"tick {t} agent row {eid} in {cid}")


def assert_legs_agree(want: list, got: list, ticks: range, base: int, tmp_path) -> None:
    """The JAX leg and the port's on ``ticks``: every observation exact
    but the float-bearing digests, and those through ``assert_raw_close``."""
    cs = chip_smoke()
    for t in ticks:
        w, g = want[t], got[t]
        if w.get("down") or g.get("down"):
            assert w == g, f"tick {t}: b down on one package only"
            continue
        where = cs.first_gateway_diff(compared(w), compared(g))
        assert where is None, f"tick {t}: {where}"
        assert g["snapshot"] == w["snapshot"], f"tick {t}: snapshot"
        assert_raw_close(w["raw"], g["raw"], t, base, tmp_path)


def failed_names(checks: list) -> set:
    return {name for name, ok, _ in checks if not ok}


def test_crash_lockstep_equals_jax_tick_for_tick(tmp_path, monkeypatch):
    """16a's world through both packages: every tick equal (what carries the
    agents' sim floats, parsed, within the ulp bound), the same replay
    reports, the events, the census and the ledgers holding on both sides,
    and the same books at the end."""
    cs = chip_smoke()
    want, wr = crash_leg(JAX, tmp_path, monkeypatch)
    got, gr = crash_leg(PORT, tmp_path)
    assert len(got) == len(want) == cs.crash_size()["ticks"]
    assert_legs_agree(want, got, range(len(got)), agent_base(), tmp_path)
    assert_columns_close(wr["columns"], gr["columns"])
    for pkg, (obs, r) in ((JAX, (want, wr)), (PORT, (got, gr))):
        failed = [(name, detail) for name, ok, detail in cs.crash_checks(obs, r) if not ok]
        assert not failed, (pkg, failed)
        assert [name for name, _, _ in r["events"]] == list(EVENTS), pkg
    assert [(k["wal"][0], k["snapshot"][0]) for k in gr["kills"]] == [
        (k["wal"][0], k["snapshot"][0]) for k in wr["kills"]]
    for key in ("lost", "duplicated", "journal", "in_flight", "pending", "replays",
                "ledger", "control", "resurrections", "stub", "stub_log", "sim", "yield_at",
                "engine_ticks", "census"):
        assert gr[key] == wr[key], key
    assert [b["records"] for b in gr["books"]] == [b["records"] for b in wr["books"]]
    assert gr["resurrections"] == {"announced": 1, "yielded": 1}
    assert gr["stub"] == {"peer_reclaimed": 1, "peer_yielded": 1}
    assert [r["torn"] for r in gr["replays"]] == [False, True]
    mt = cs.gateway_modules(PORT).types.MessageType
    sent = {m[0] for o in got if not o.get("down") for m in o["trunk"]["a"]}
    assert {mt.TRUNK_HANDOVER_PREPARE, mt.TRUNK_HANDOVER_ACK, mt.TRUNK_RESURRECT_HELLO} <= sent
    assert all(o["served"] and o["ran"] == 1 for o in got if not o.get("down"))


def agent_base() -> int:
    g = jax_module("core.settings").global_settings
    return g.entity_channel_id_start + jax_module("sim.plane").AGENT_ID_OFFSET


def journaled_cells(durable: dict) -> dict:
    """{human id: the cell whose table lists it} in the snapshot and WAL a
    kill left, decoded by the JAX package: the snapshot's cell tables under
    the WAL's channel records above its sequence, last wins."""
    g = jax_module("core.settings").global_settings
    lo, hi = g.spatial_channel_id_start, g.entity_channel_id_start
    snap = jax_module("core.snapshot").snapshot_pb2.GatewaySnapshot()
    snap.ParseFromString(durable["snapshot"])
    tables = {e.channelId: e.data for e in snap.channels
              if lo <= e.channelId < hi and e.HasField("data")}
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".wal") as f:
        f.write(durable["wal"])
        f.flush()
        records = jax_module("core.wal").read_wal_records(f.name, truncate=False)[0]
    for r in records:
        if r.seq <= snap.walSeq or not lo <= r.channelId < hi:
            continue
        if r.kind == "channel_state" and r.data.type_url:
            tables[r.channelId] = r.data
        elif r.kind == "channel_removed":
            tables.pop(r.channelId, None)
    unpack, base = jax_module("utils.anyutil").unpack_any, agent_base()
    return {eid: cid for cid, data in sorted(tables.items())
            for eid in unpack(data).entities if eid < base}


def test_restarts_take_the_journaled_census_and_cells(tmp_path):
    """ROADMAP F22 and F23, the port held to the journal: at each restart,
    before its first tick, the live agents (ids, positions, velocities,
    states, targets) and the sim tick are the last census that the JAX
    package decodes from the WAL and snapshot the kill left, and every
    human re-tracked from b's journaled cell tables has that cell as its
    device previous cell."""
    cs = chip_smoke()
    J = cs.gateway_modules(JAX)
    lo = jax_module("core.settings").global_settings.spatial_channel_id_start
    _, gr = crash_leg(PORT, tmp_path)
    assert len(gr["durable"]) == len(gr["booted"]) == 2
    for durable, booted in zip(gr["durable"], gr["booted"]):
        census = cs.journaled_census(J, durable["wal"], durable["snapshot"])
        assert census is not None and len(census[1]) == SMALL["agents"]
        assert cs.booted_agents(booted) == census
        cells = journaled_cells(durable)
        assert cells
        assert {e: booted["prev_cells"].get(e) for e in cells} == {
            e: cid - lo for e, cid in cells.items()}


def test_port_equals_the_reference_as_it_is_up_to_the_first_restart(tmp_path):
    """The JAX package without the port's fixes and the port, tick for tick
    as in the lockstep test, from the first tick to the first restart
    (neither fault has a path to run before it)."""
    want, _ = crash_leg(JAX, tmp_path, fixes=False)
    got, _ = crash_leg(PORT, tmp_path)
    assert_legs_agree(want, got, range(chip_smoke().CRASH_AT["restart1"]), agent_base(), tmp_path)


def test_reference_runs_a_fresh_spawn_over_a_replayed_census(tmp_path):
    """ROADMAP F22, the reference as it is: the crash soak's boot (the
    controller loads, its sim plane spawns, then the replay) stages the
    journaled census where no plane will take it, so each restart runs a
    fresh population, not the census decoded from the journal; the port
    takes it into the live plane."""
    cs = chip_smoke()
    J = cs.gateway_modules(JAX)
    obs, r = crash_leg(JAX, tmp_path, fixes=False)
    failed = failed_names(cs.crash_checks(obs, r))
    assert {"restart_1_sim_census_restored", "restart_2_sim_census_restored"} <= failed
    for durable, booted in zip(r["durable"], r["booted"]):
        assert cs.booted_agents(booted) != cs.journaled_census(J, durable["wal"],
                                                               durable["snapshot"])
    got, gr = crash_leg(PORT, tmp_path)
    assert gr["sim"].get("agents_restored") == SMALL["agents"]  # the last incarnation's ledger
    assert "agents_restored" not in r["sim"]


def test_reference_loses_a_crossing_made_before_the_first_tick_after_a_restart(tmp_path):
    """ROADMAP F23, the reference as it is: the replay re-tracks each
    resident at its journaled cell's centre but leaves the device's previous
    cell unset, so b's entities moved west just after the restart never
    cross (they stay in b's cells); the port seeds the baseline and they
    park and commit on the trunk's return."""
    cs = chip_smoke()
    obs, r = crash_leg(JAX, tmp_path, fixes=False)
    assert "parked_crossings_reoffered_from_the_card_and_committed" in failed_names(
        cs.crash_checks(obs, r))
    for durable, booted in zip(r["durable"], r["booted"]):
        cells = journaled_cells(durable)
        assert cells and {booted["prev_cells"].get(e) for e in cells} == {-1}
    got, gr = crash_leg(PORT, tmp_path)
    assert "parked_crossings_reoffered_from_the_card_and_committed" not in failed_names(
        cs.crash_checks(got, gr))


def test_cpu_leg_child_runs_the_leg_the_parent_sized(tmp_path):
    """``chip_smoke.py --cpu-leg 16a SCRATCH`` (the child that runs a
    lockstep phase's CPU leg beside the card leg): at the size the parent
    pickled, its observations and books are the in-process port leg's."""
    cs = chip_smoke()
    leg = cs.CpuLeg("16a", **SMALL)
    assert leg.size == cs.crash_size(**SMALL)
    obs, r = leg.result()
    got, gr = crash_leg(PORT, tmp_path)
    assert [{k: v for k, v in o.items() if k not in UNCOMPARED} for o in obs] == [
        {k: v for k, v in o.items() if k not in UNCOMPARED} for o in got]
    for key in ("replays", "kills", "booted", "lost", "duplicated", "ledger", "stub_log", "sim",
                "census"):
        assert r[key] == gr[key], key
    assert [e[:2] for e in r["events"]] == [e[:2] for e in gr["events"]]


def test_port_copies_of_the_crash_soak_equal_the_script():
    """chip_smoke.py's copies of scripts/crash_soak.py's CrashSoakParams,
    shard ranges, id bases, ``persistence_paths`` and ``wal_settings_hook``
    (both gateways), and its world (the federation soak's)."""
    cs = chip_smoke()
    crash = script("crash_soak")
    assert dataclasses.asdict(cs.CrashSoakParams()) == dataclasses.asdict(crash.CrashSoakParams())
    assert (cs.CRASH_XR, cs.CRASH_ZR, cs.CRASH_BASE) == (crash.XR, crash.ZR, crash.BASE)
    assert cs.WORLD_SPATIAL == crash.WORLD_SPATIAL
    assert cs.persistence_paths("/s", "b") == crash.persistence_paths("/s", "b")
    for gw in ("a", "b"):
        mine, theirs = SimpleNamespace(), SimpleNamespace()
        cs.wal_settings_hook(gw, "/s", cs.CrashSoakParams())(mine)
        crash.wal_settings_hook(gw, "/s", crash.CrashSoakParams())(theirs)
        assert vars(mine) == vars(theirs)


def test_crash_child_imports_neither_jax_nor_the_jax_package(tmp_path):
    """``chip_smoke.py --crash-child CONFIG REPORT STATE SEED`` (16b's gateway
    "b", which needs no card): it boots its shard with the WAL armed,
    reports, exits, and no module of JAX or of the JAX package was loaded in
    its process."""
    cs = chip_smoke()
    ports = dict(zip(("a_trunk", "a_client", "b_trunk", "b_client"), cs.fed_free_ports(4)))
    config, report = tmp_path / "fed.json", tmp_path / "report.json"
    config.write_text(json.dumps(cs.fed_config(ports)))
    state = tmp_path / "state"
    state.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    with open(tmp_path / "child.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--crash-child", str(config),
             str(report), str(state), "20260804"], cwd=REPO, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=log, text=True, env=env)
    try:
        lines = []
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and "READY" not in lines:
            line = proc.stdout.readline()
            assert line, (tmp_path / "child.log").read_text()[-2000:]
            lines.append(line.strip())
        for cmd in ("flush_wal", "report", "exit"):
            proc.stdin.write(json.dumps({"cmd": cmd}) + "\n")
            proc.stdin.flush()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    r = json.loads(report.read_text())
    assert r["modules"] == []
    assert r["spatial"] == "StaticGrid2DSpatialController"
    assert r["gateway"] == "b" and r["pending"] == r["parked"] == 0
    assert r["persistence"]["wal"]["enabled"] and os.path.exists(state / "gw_b.wal")


# ---- each checker names the check a report breaks --------------------------

BOOK = dict(when="end", metric={"records": {"flip": 2}, "replayed": {}, "resurrection": {}},
            records={"flip": 2}, replayed={}, resurrections={})
CRASH_REPORT = dict(events=[(name, True, "") for name in EVENTS], lost=[], duplicated={},
                    books=[BOOK], journal={"prepared": 5, "committed": 4, "aborted": 1},
                    in_flight=0, pending=(0, 0, 0), restart_s=[1.0, 1.0], replay_s=[0.1, 0.1],
                    deadlines=(30.0, 90.0))
CRASH_OBS = [dict(served=True), dict(down=True), dict(served=True)]
CRASH_BREAKS = {
    "census_zero_lost": dict(lost=[7]),
    "census_zero_duplicated": dict(duplicated={7: [("b", 1), ("a", 0)]}),
    "wal_records_ledger_equals_metric": dict(books=[dict(BOOK, records={"flip": 3})]),
    "wal_replayed_ledger_equals_metric": dict(books=[dict(BOOK, replayed={"flip": 1})]),
    "resurrection_ledger_equals_metric": dict(books=[dict(BOOK, resurrections={"yielded": 1})]),
    "journal_balanced": dict(in_flight=1),
    "nothing_pending_or_parked": dict(pending=(0, 1, 0)),
    "every_tick_up_served": "obs",
    "restarts_within_deadline": dict(restart_s=[1.0, 91.0])}
INVARIANTS = ("two_crashes", "zero_committed_entities_lost_or_duplicated",
              "journal_prepared_equals_committed_plus_aborted")
SOAK_REPORT = dict(invariants={"ok": True, "checks": [
                       {"name": n, "ok": True, "detail": ""} for n in INVARIANTS]},
                   crashes=[{"phase": "reclaim", "mid_burst": True},
                            {"phase": "adopt", "mid_burst": True}],
                   gateways={"b": {"modules": [], "spatial": "StaticGrid2DSpatialController"}})
SOAK_BREAKS = {
    "zero_committed_entities_lost_or_duplicated": "invariant",
    "child_imports_no_jax": dict(gateways={"b": {"modules": ["channeld_tpu"],
                                                 "spatial": "StaticGrid2DSpatialController"}}),
    "child_on_the_host_grid": dict(gateways={"b": {"modules": [],
                                                   "spatial": "GPUSpatialController"}}),
    "one_reclaimed_then_one_adopted": dict(crashes=[{"phase": "adopt", "mid_burst": True}])}


def test_each_crash_checker_passes_its_unbroken_report():
    cs = chip_smoke()
    assert failed_names(cs.crash_checks(CRASH_OBS, CRASH_REPORT)) == set()
    assert failed_names(cs.crash_soak_checks(SOAK_REPORT)) == set()


@pytest.mark.parametrize("name", sorted(CRASH_BREAKS))
def test_crash_checker_names_the_broken_check(name):
    cs = chip_smoke()
    brk = CRASH_BREAKS[name]
    if brk == "obs":
        obs, r = CRASH_OBS + [dict(served=False)], CRASH_REPORT
    else:
        obs, r = CRASH_OBS, dict(CRASH_REPORT, **brk)
    assert failed_names(cs.crash_checks(obs, r)) == {name}


@pytest.mark.parametrize("name", sorted(SOAK_BREAKS))
def test_crash_soak_checker_names_the_broken_check(name):
    cs = chip_smoke()
    brk = SOAK_BREAKS[name]
    if brk == "invariant":
        r = dict(SOAK_REPORT, invariants={"ok": False, "checks": [
            {"name": n, "ok": n != name, "detail": ""} for n in INVARIANTS]})
    else:
        r = dict(SOAK_REPORT, **brk)
    assert failed_names(cs.crash_soak_checks(r)) == {name}


@pytest.mark.cuda
def test_crash_lockstep_on_the_card():
    """16a small on the card against its CPU leg: every tick equal through
    both crashes, both legs holding the crash soak's books, K1 and K2 once
    per engine tick and exact on each restart's first tick and the yield
    tick."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K

    cs = chip_smoke()
    K.build()
    launches, entries = cs.phase_crash_lockstep(K, torch.device("cuda", 0),
                                                cs.CpuLeg("16a", **dict(SMALL, columns=False)))
    assert launches["assign_count"] == launches["aoi"] > 0
    for name in ("assign_count", "aoi"):
        assert set(entries[name]) == {"16a_restart1", "16a_restart2", "16a_yield"}
        assert {e["max_abs_err"] for e in entries[name].values()} == {0}
