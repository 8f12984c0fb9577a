"""The fleet's device side through the port's GPU controller, held against
the JAX package, and the federation soak's live fleet through the port.

``chip_smoke.py``'s phase 15 keeps (the test loads chip_smoke.py by path):

- the lockstep fleet (``FleetWorld``, 15a): gateway "a" of
  scripts/global_soak.py's three-gateway world (WORLD_3 on the device
  controller, the sim plane and the query plane on, the control plane
  armed, "a" the leader) with the peers b and c as scripted stubs behind
  tapped trunk links, written against one package's modules
  (``gateway_modules(pkg)``). Here at a small size (256 slots, 32 query
  rows, 24 entities, 8 agents, 4 sensors; bursts 8 / 4 / 8 / 6; c's
  adoption of 6 entities, 2 in-flight ones and 2 sensor rows), 120 ticks of
  a fixed clock through the JAX package (``TPUSpatialController`` on the
  CPU) and the port on ``cpu``: every tick's handovers, trunk messages (as
  bytes, in order), tables, placement ledger, engine slots, cells and
  counts, agents, changed query rows, ledgers, the peers' holdings and
  every outbound stream equal exactly; the agents' sim columns within the
  ulp bound that ``tests/test_torch_sim.py`` states; the six events, the
  census (zero lost, zero duplicated across a, stub b and stub c) and the
  ledgers against their metrics hold on both packages;
- the port's copies of scripts/federation_soak.py's and
  scripts/global_soak.py's worlds, directories and parameters (15b runs the
  former's ``run_fed_soak``): equal to the scripts' own, loaded by path;
- the ``--fed-child`` role (15b's gateway "b"): it boots, and leaves no
  module of JAX or of the JAX package in its process;
- each checker names the check a report breaks.

No live multi-process soak runs here (phase 15 runs 15b on the card). One
``cuda`` case runs 15a small on the card against its CPU leg.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_elastic import REPO, chip_smoke
from test_torch_gateway import JAX, PORT, port_globals
from test_torch_sim import tol

PKGS = (JAX, PORT)
CPU = torch.device("cpu")
# Host timings, the card's reads and the whole-table sim digest (its free
# rows' NaN fill is not part of what both compute; the agent rows are held
# within the ulp bound): not compared exactly.
UNCOMPARED = ("tick_ms", "step_ms", "reads", "sim")
SMALL = dict(entity_capacity=256, query_capacity=32, entities=24, agents=8, sensors=4,
             followers=2, burst=8, burst_agents=2, refusal=4, herd=6, herd_agents=2, sever=8,
             adopt=6, adopt_sensors=2, claimed=2, ticks=120, deadline_s=60.0, columns=True)
WORLD_EXTENT = 150.0  # WORLD_3 spans x in [-150, 150)
SIM_SPEED = 6.0  # the gateway's sim_max_speed
EVENTS = ("outbound_burst_untracked_after_commit", "agents_departed_with_the_burst",
          "refused_burst_back_at_its_source", "inbound_herd_tracked_at_cell_centres",
          "inbound_agents_reflagged", "severed_burst_aborted_and_restored",
          "parked_crossings_reoffered_and_committed", "c_declared_dead_and_adopted_here",
          "c_cells_hosted_here", "c_entities_adopted_and_tracked", "claimed_ids_not_recreated",
          "c_sensor_rows_restored")


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield


def script(name: str):
    """One of scripts/*.py, loaded by path (scripts/ on sys.path: the
    global soak imports the federation soak)."""
    scripts = os.path.join(REPO, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(scripts, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def fleet_leg(pkg: str, tmp_path) -> tuple:
    cs = chip_smoke()
    return cs.run_fleet_leg(cs.gateway_modules(pkg), CPU, cs.fleet_size(**SMALL), str(tmp_path))


def compared(obs: dict) -> dict:
    return {k: v for k, v in obs.items() if k not in UNCOMPARED}


def assert_columns_close(want: list, got: list) -> None:
    """The agent rows' positions, velocities and waypoints within the ulp
    bound of their scale per sim pass (t + 1 passes by tick t), FSM states
    exactly."""
    assert len(got) == len(want)
    for t, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(g[2], w[2]), f"tick {t}: FSM states differ"
        for i, scale in ((0, WORLD_EXTENT), (1, SIM_SPEED), (3, WORLD_EXTENT)):
            np.testing.assert_allclose(g[i], w[i], rtol=0, atol=(t + 1) * tol(scale),
                                       equal_nan=True, err_msg=f"tick {t} column {i}")


def test_fleet_lockstep_equals_jax_tick_for_tick(tmp_path):
    """15a's world through both packages: every tick equal (the agents' sim
    columns within the ulp bound), the same trunk traffic in both
    directions, the six events, the census and the ledgers holding on both
    sides, and the same books at the end."""
    cs = chip_smoke()
    legs = {pkg: fleet_leg(pkg, tmp_path) for pkg in PKGS}
    (want, wr), (got, gr) = legs[JAX], legs[PORT]
    assert len(got) == len(want) == SMALL["ticks"]
    for t, (w, g) in enumerate(zip(want, got)):
        where = cs.first_gateway_diff(compared(w), compared(g))
        assert where is None, f"tick {t}: {where}"
    assert_columns_close(wr["columns"], gr["columns"])
    for pkg, (obs, r) in legs.items():
        failed = [(name, detail) for name, ok, detail in cs.fleet_checks(obs, r) if not ok]
        assert not failed, (pkg, failed)
        assert [name for name, _, _ in r["events"]] == list(EVENTS), pkg
    for key in ("lost", "duplicated", "fed_ledger", "fed_metric", "adoptions", "deaths", "ledger",
                "control", "sim", "journal", "adopted_at", "engine_ticks", "local_cells"):
        assert gr[key] == wr[key], key
    ledger = gr["ledger"]
    assert ledger["committed"] >= SMALL["burst"] + SMALL["refusal"] + SMALL["sever"]
    assert ledger["refused"] > 0 and ledger["applied"] == SMALL["herd"]
    assert gr["control"]["queries_adopted"] == SMALL["adopt_sensors"]
    assert gr["control"]["entities_adopted"] + gr["control"]["entities_replayed"] == SMALL["adopt"]
    sent = {gw: {t for o in got for t, _ in o["trunk"][gw]} for gw in ("b", "c")}
    mt = cs.gateway_modules(PORT).types.MessageType
    assert {mt.TRUNK_HANDOVER_PREPARE, mt.TRUNK_ABORT_NOTICE, mt.TRUNK_GATEWAY_DEAD,
            mt.TRUNK_ADOPT_QUERY, mt.TRUNK_ADOPT_DONE, mt.TRUNK_SHARD_EPOCH} <= sent["b"]
    assert {mt.TRUNK_LOAD_REPORT, mt.TRUNK_SHARD_EPOCH} <= sent["c"]
    assert all(o["ran"] == 1 and o["served"] for o in got)


def test_port_copies_of_the_fleet_soaks_equal_the_scripts():
    """chip_smoke.py's copies: the federation soak's WORLD_SPATIAL,
    FedSoakParams and ``_fed_config``; the global soak's WORLD_3, shard
    ranges, id bases, GlobalSoakParams, ``_fed_config3`` and
    ``_settings_hook``; the smoke soak's parameters."""
    cs = chip_smoke()
    fed, glob = script("federation_soak"), script("global_soak")
    assert cs.WORLD_SPATIAL == fed.WORLD_SPATIAL
    assert cs.WORLD_3 == glob.WORLD_3
    assert (cs.GLOBAL_XR, cs.GLOBAL_ZR, cs.GLOBAL_BASE) == (glob.XR, glob.ZR, glob.BASE)
    assert dataclasses.asdict(cs.FedSoakParams()) == dataclasses.asdict(fed.FedSoakParams())
    assert dataclasses.asdict(cs.GlobalSoakParams()) == dataclasses.asdict(
        glob.GlobalSoakParams())
    ports = {f"{gw}_{kind}": 1000 + i for i, (gw, kind) in enumerate(
        (gw, kind) for gw in "abc" for kind in ("trunk", "client"))}
    assert cs.fed_config(ports) == fed._fed_config(ports)
    assert cs.fed_config3(ports) == glob._fed_config3(ports)
    mine, theirs = SimpleNamespace(), SimpleNamespace()
    cs.global_settings_hook(cs.GlobalSoakParams())(mine)
    glob._settings_hook(glob.GlobalSoakParams())(theirs)
    assert vars(mine) == vars(theirs)
    # tests/test_federation.py::test_federation_smoke_soak's parameters.
    assert dataclasses.asdict(cs.fed_smoke_params()) == dataclasses.asdict(fed.FedSoakParams(
        entities=32, burst=8, refusal_burst=4, sever_burst=8, herd_back=6,
        phase_timeout_s=15.0, quiesce_s=1.5))


def test_fed_child_imports_neither_jax_nor_the_jax_package(tmp_path):
    """``chip_smoke.py --fed-child CONFIG REPORT`` (15b's gateway "b", which
    needs no card): it boots its shard on the host grid, says READY with its
    boot's parts, reports, exits, and no module of JAX, of the JAX package
    or of torch was loaded in its process (ROADMAP F27)."""
    cs = chip_smoke()
    ports = dict(zip(("a_trunk", "a_client", "b_trunk", "b_client"), cs.fed_free_ports(4)))
    config, report = tmp_path / "fed.json", tmp_path / "report.json"
    config.write_text(json.dumps(cs.fed_config(ports)))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    with open(tmp_path / "child.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--fed-child", str(config),
             str(report)], cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
            text=True, env=env)
    try:
        ready = None
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and ready is None:
            line = proc.stdout.readline()
            assert line, (tmp_path / "child.log").read_text()[-2000:]
            if line.startswith("READY"):
                ready = json.loads(line[len("READY"):])
        for cmd in ("report", "exit"):
            proc.stdin.write(json.dumps({"cmd": cmd}) + "\n")
            proc.stdin.flush()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert ready["modules"] == [] and min(ready[k] for k in ("imports_s", "modules_s",
                                                             "gateway_s")) > 0
    r = json.loads(report.read_text())
    assert r["modules"] == [] and r["boot"] == ready
    assert r["spatial"] == "StaticGrid2DSpatialController"
    assert r["gateway"] == "b" and r["pending"] == r["parked"] == 0


# ---- each checker names the check a report breaks --------------------------

FLEET_REPORT = dict(events=[(name, True, "") for name in EVENTS], lost=[], duplicated={},
                    fed_ledger={"committed": 3}, fed_metric={"committed": 3},
                    adoptions=(1, 1), deaths=(1, 1),
                    journal={"prepared": 5, "committed": 4, "aborted": 1}, in_flight=0,
                    pending=0, parked=0)
FLEET_OBS = [dict(served=True)] * 3
FLEET_BREAKS = {
    "census_zero_lost": dict(lost=[7]),
    "census_zero_duplicated": dict(duplicated={7: [("a", 1), ("b", 0)]}),
    "federation_ledger_equals_metric": dict(fed_metric={"committed": 2}),
    "adoptions_equal_metric": dict(adoptions=(1, 0)),
    "deaths_equal_metric": dict(deaths=(2, 2)),
    "journal_balanced": dict(in_flight=1),
    "nothing_pending_or_parked": dict(parked=1),
    "every_tick_served": "obs"}
INVARIANTS = ("cross_gateway_handovers_committed", "every_entity_on_exactly_one_gateway",
              "refusals_equal_busy_frames")
FED_REPORT = dict(invariants={"ok": True, "checks": [
                      {"name": n, "ok": True, "detail": ""} for n in INVARIANTS]},
                  stats=dict(committed=8, refused=1, redirects=1),
                  census=dict(missing=[], duplicated={}),
                  gateway_a=dict(spatial="StaticGrid2DSpatialController"),
                  gateway_b=dict(modules=[], spatial="StaticGrid2DSpatialController"))
FED_BREAKS = {
    "every_entity_on_exactly_one_gateway": "invariant",
    "at_least_8_committed": dict(stats=dict(committed=7, refused=1, redirects=1)),
    "at_least_1_refused": dict(stats=dict(committed=8, refused=0, redirects=1)),
    "exactly_1_redirect": dict(stats=dict(committed=8, refused=1, redirects=2)),
    "census_nothing_missing": dict(census=dict(missing=["9"], duplicated={})),
    "census_nothing_duplicated": dict(census=dict(missing=[], duplicated={"9": []})),
    "child_imports_no_jax": dict(gateway_b=dict(modules=["jax"],
                                                spatial="StaticGrid2DSpatialController")),
    "both_gateways_on_the_host_grid": dict(gateway_a=dict(spatial="GPUSpatialController"))}


def failed_names(checks: list) -> set:
    return {name for name, ok, _ in checks if not ok}


def test_each_fleet_checker_passes_its_unbroken_report():
    cs = chip_smoke()
    assert failed_names(cs.fleet_checks(FLEET_OBS, FLEET_REPORT)) == set()
    assert failed_names(cs.fed_soak_checks(FED_REPORT)) == set()


@pytest.mark.parametrize("name", sorted(FLEET_BREAKS))
def test_fleet_checker_names_the_broken_check(name):
    cs = chip_smoke()
    brk = FLEET_BREAKS[name]
    if brk == "obs":
        obs, r = FLEET_OBS + [dict(served=False)], FLEET_REPORT
    else:
        obs, r = FLEET_OBS, dict(FLEET_REPORT, **brk)
    assert failed_names(cs.fleet_checks(obs, r)) == {name}


@pytest.mark.parametrize("name", sorted(FED_BREAKS))
def test_fed_soak_checker_names_the_broken_check(name):
    cs = chip_smoke()
    brk = FED_BREAKS[name]
    if brk == "invariant":
        r = dict(FED_REPORT, invariants={"ok": False, "checks": [
            {"name": n, "ok": n != name, "detail": ""} for n in INVARIANTS]})
    else:
        r = dict(FED_REPORT, **brk)
    assert failed_names(cs.fed_soak_checks(r)) == {name}


@pytest.mark.cuda
def test_fleet_lockstep_on_the_card():
    """15a small on the card against its CPU leg: every tick equal, both legs
    holding the fleet's books, 2 device reads a steady tick, K1 and K2 once
    per engine tick and exact after the inbound herd and the adoption."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K

    cs = chip_smoke()
    K.build()
    launches, entries = cs.phase_fleet_lockstep(K, torch.device("cuda", 0),
                                                cs.fleet_size(**dict(SMALL, columns=False)))
    assert launches["assign_count"] == launches["aoi"] == SMALL["ticks"]
    for name in ("assign_count", "aoi"):
        assert set(entries[name]) == {"15a_herd", "15a_adoption"}
        assert {e["max_abs_err"] for e in entries[name].values()} == {0}
