"""The live chaos soak and the overload ladder through the port's GPU
controller, held against the JAX package.

``chip_smoke.py``'s phase 14 keeps the port's copies of scripts/chaos_soak.py
and scripts/overload_soak.py (the test loads chip_smoke.py by path), written
against one package's modules (``gateway_modules(pkg)``):

- the lockstep world (``OverloadWorld``, 14a): the overload soak's world on
  config/spatial_tpu_cells_2x2.json at 8 shards (the JAX package's 8 virtual
  devices, the port's 8 CPU shards) with CellBucket 6, at the soaks' tables
  (256 slots, 32 query rows), 32 entities, 6 clients' forwards, 2 observers
  at 200 ms, storms of 16, a saturation window of 8 s of a fixed clock whose
  ``time.sleep`` moves it (a stall costs its tick exactly its length on both
  packages). Every tick's ladder (level, pressure, components,
  transitions), shed ledger, overflow, handovers (the deferred too), tables
  and outbound streams (the late clients' ServerBusyMessage too) are equal
  exactly, and both packages hold 14a's invariants;
- the live chaos soak and the live overload soak (14b, 14c) through the port
  on ``cpu`` at ``tests/test_chaos.py``'s smoke scenario and
  ``tests/test_overload.py::test_overload_smoke_soak``'s parameters, with
  shorter timelines;
- the port's copies of the soaks' scenarios and parameters equal the
  scripts' own, and each invariant checker names the invariant a report
  breaks.

One ``cuda`` case runs 14a small on the card against its CPU leg.
"""

from __future__ import annotations

import asyncio
import importlib.util
import os
import sys

import pytest
import torch

from test_torch_elastic import REPO, chip_smoke
from test_torch_gateway import JAX, PORT, port_globals

PKGS = (JAX, PORT)
CPU = torch.device("cpu")
# Host timings and the port's own transfer counts: not part of what both compute.
UNCOMPARED = ("tick_ms", "reads", "transfers")
LOCKSTEP = dict(entity_capacity=256, query_capacity=32, entities=32, clients=6, observers=2,
                storm_size=16, saturation_s=8.0)
# tests/test_chaos.py::SMOKE_SCENARIO.
SMOKE_SCENARIO = {
    "name": "smoke", "seed": 424242, "config_overrides": {"CellBucket": 4}, "faults": [
        {"point": "transport.reset", "every_n": 60, "max_fires": 4},
        {"point": "transport.truncate", "every_n": 90, "max_fires": 3},
        {"point": "transport.corrupt", "every_n": 110, "max_fires": 3},
        {"point": "connection.eof_race", "every_n": 140, "max_fires": 2},
        {"point": "connection.queue_full", "every_n": 100, "burst": 2},
        {"point": "channel.tick_budget", "every_n": 80, "stall_ms": 10, "max_fires": 20},
        {"point": "device.dispatch_stall", "every_n": 8, "stall_ms": 25, "max_fires": 15}]}
# test_chaos_smoke_soak's parameters, 20 s + 8 s cut to 12 s + 4 s.
CHAOS_SMOKE = dict(duration_s=16.0, clients=8, entities=64, msg_rate=20.0, storm_every_s=5.0,
                   storm_size=32, quiesce_s=4.0, scenario=SMOKE_SCENARIO)
# test_overload_smoke_soak's parameters, its 4 / 12 / 20 / 4 s cut to 2 / 6 / 6 / 2 s
# (warmup / saturation / recovery deadline / quiesce), and its settle of at most
# 30 s to at most 4 s.
OVERLOAD_SMOKE = dict(warmup_s=2.0, saturation_s=6.0, recover_deadline_s=6.0, quiesce_s=2.0,
                      clients=6, observers=3, entities=32, msg_rate=10.0, storm_every_s=4.0,
                      storm_size=24, global_tick_ms=100, require_handover_defer=False,
                      require_update_priority=False)
# The invariants the live smokes leave unasserted: each failed in at least one
# of 5 runs of this file under ``-n 6`` on a CPU box, where the loaded CPU
# engine overruns the GLOBAL budget and the ladder (on, as the soaks leave it)
# climbs to L3: the chaos soak's clients are then refused at auth (a refusal
# ends their socket, so some are mid-reconnect at the end, and with little
# traffic the transport points do not fire); the overload soak's ladder
# walks home after its recovery deadline, and a refusal sent while it climbed
# in the settle (before the ledger is re-zeroed) can reach its client after
# the books open. Phase 14 asserts them all on the card.
CHAOS_SMOKE_UNASSERTED = {"all_disconnects_recovered", "every_fault_point_fired"}
OVERLOAD_SMOKE_UNASSERTED = {"returned_to_L0_within_deadline", "busy_frames_le_admission_sheds"}


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield
        for pkg in PKGS:
            if f"{pkg}.chaos" in sys.modules:
                sys.modules[f"{pkg}.chaos"].disarm()


def lockstep_leg(pkg: str, tmp_path) -> tuple:
    """14a's world through one package: (observations, report)."""
    cs = chip_smoke()
    p = cs.overload_lockstep_params(**LOCKSTEP)
    config = cs.cells_config(8, str(tmp_path), cs.overload_scenario(p)["config_overrides"])
    return cs.run_overload_lockstep(cs.gateway_modules(pkg), CPU, p, config)


def compared(obs: dict) -> dict:
    return {k: v for k, v in obs.items() if k not in UNCOMPARED}


def failed_checks(obs: list, r: dict) -> list:
    return [(name, detail) for name, ok, detail in chip_smoke().overload_lockstep_checks(obs, r)
            if not ok]


def test_overload_lockstep_equals_jax_tick_for_tick(tmp_path):
    """Every tick of 14a's world equal in both packages: the level,
    pressure, components and transitions, the shed ledger, the overflow,
    the handovers and the deferred crossings, the tables and every
    outbound stream; and the same timeline: the transitions, the ticks the
    window closed and the ladder reached L0 on, the shed ledger and its
    metric, the busy frames and the chaos fires. The JAX package holds
    14a's invariants."""
    cs = chip_smoke()
    want, wr = lockstep_leg(JAX, tmp_path)
    got, gr = lockstep_leg(PORT, tmp_path)
    assert len(got) == len(want)
    for t, (w, g) in enumerate(zip(want, got)):
        where = cs.first_gateway_diff(compared(w), compared(g))
        assert where is None, f"tick {t}: {where}"
    assert sum(len(o["handovers"]) for o in got) > 0
    assert any(o["deferred"] for o in got) and any(o["overflow"] for o in got)
    for key in ("transitions", "closed_at", "recovered_at", "shed_counts", "metric_sheds",
                "admitted", "busy_frames", "fires", "census"):
        assert gr[key] == wr[key], key
    assert [(frm, to) for frm, to, _ in gr["transitions"]] == [
        (0, 1), (1, 2), (2, 3), (3, 2), (2, 1), (1, 0)]
    assert gr["fires"]["device.dispatch_stall"] > 0 and gr["fires"]["channel.tick_budget"] > 0
    assert not failed_checks(want, wr)


def test_port_overload_lockstep_invariants(tmp_path):
    """14a's invariants on the port: L2 and L3 reached one step at a time,
    no rise after the descent, L0 by the end, the ledger equal to
    overload_sheds_total, the low-priority shed and a handover deferral, 3
    late clients refused with one ServerBusyMessage each, no entity lost;
    two engine transfers a tick (the consume blob and the query plane's
    changed rows)."""
    obs, r = lockstep_leg(PORT, tmp_path)
    assert not failed_checks(obs, r)
    assert {o["transfers"] for o in obs} == {2}


def script(name: str):
    """One of scripts/*.py, loaded by path (tests/test_chaos.py's way)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def test_port_copies_of_the_soaks_equal_the_scripts():
    """chip_smoke.py's copies: the chaos soak's DEFAULT_SCENARIO and
    SoakParams, the overload soak's OverloadSoakParams and default_scenario
    (at its defaults and at 14a's timeline), field by field."""
    cs = chip_smoke()
    chaos, overload = script("chaos_soak"), script("overload_soak")
    assert cs.chaos_scenario() == chaos.DEFAULT_SCENARIO
    for mine, theirs in ((cs.chaos_params(), chaos.SoakParams()),
                         (cs.overload_params(), overload.OverloadSoakParams())):
        for key, value in mine.items():
            assert getattr(theirs, key) == value, key
    for kw in ({}, dict(warmup_s=2.0, saturation_s=12.0), dict(warmup_s=6.0, saturation_s=20.0)):
        assert cs.overload_scenario(cs.overload_params(**kw)) == overload.default_scenario(
            overload.OverloadSoakParams(**kw))


# ---- each checker names the invariant a report breaks --------------------------

POINTS = [r["point"] for r in SMOKE_SCENARIO["faults"]]
CHAOS_REPORT = dict(lost_tracking=[], missing=[], duped=[], received=10, drained=10, sent=12,
                    disordered=[], recovery_latencies=[0.1, 0.2], disconnects=2, reconnects=2,
                    global_tick_p99_s=0.1, overflow=5, handovers=3,
                    fires={point: 1 for point in POINTS}, points=POINTS)
CHAOS_BREAKS = {
    "no_lost_entity_tracking": dict(lost_tracking=[7]),
    "every_entity_in_exactly_one_cell": dict(duped=[7]),
    "received_equals_owner_drained": dict(drained=9),
    "received_le_sent": dict(received=13, drained=13),
    "per_client_order_no_dup": dict(disordered=[3]),
    "reconnect_within_deadline": dict(recovery_latencies=[0.1, 9.0]),
    "all_disconnects_recovered": dict(disconnects=3),
    "global_tick_p99_bounded": dict(global_tick_p99_s=2.0),
    "cells_overflow_shed_fired": dict(overflow=0),
    "handovers_orchestrated": dict(handovers=0),
    "every_fault_point_fired": dict(fires=dict({point: 1 for point in POINTS},
                                               **{"connection.eof_race": 0}))}
LADDER = [{"t": t, "from": frm, "to": to} for t, frm, to in (
    (7.0, 0, 1), (8.0, 1, 2), (9.0, 2, 3), (27.5, 3, 2), (28.5, 2, 1), (29.5, 1, 0))]
SHEDS = {"update_priority": 5, "handover_defer": 2, "admission_connection": 1}
OVERLOAD_REPORT = dict(lost_tracking=[], missing=[], duped=[], max_level=3, peak_at_close=3,
                       sat_close=26.0, transitions=LADDER, recovered_in_s=3.0, final_level=0,
                       per_level_p99={0: 0.1, 1: 0.2, 2: 0.3, 3: 0.3}, metric_sheds=SHEDS,
                       shed_counts=SHEDS, busy_seen=1, handovers=4)
NO_SHEDS = dict(metric_sheds={}, shed_counts={}, busy_seen=0)
OVERLOAD_BREAKS = {
    "ladder_reached_at_least_L2": dict(max_level=1),
    "ladder_moves_one_step_at_a_time": dict(
        transitions=LADDER[:1] + [dict(LADDER[1], to=3)] + LADDER[3:]),
    "release_never_exceeds_overload_peak": dict(
        peak_at_close=2, transitions=LADDER[:4] + [{"t": 28.2, "from": 2, "to": 3},
                                                   {"t": 28.3, "from": 3, "to": 2}] + LADDER[4:]),
    "returned_to_L0_within_deadline": dict(recovered_in_s=None, final_level=2),
    **{f"tick_p99_bounded_at_L{lvl}": dict(per_level_p99={**OVERLOAD_REPORT["per_level_p99"],
                                                          lvl: 2.5}) for lvl in range(4)},
    "no_lost_entity_tracking": dict(lost_tracking=[7]),
    "every_entity_in_exactly_one_cell": dict(missing=[7]),
    "shed_accounting_exact": dict(metric_sheds=dict(SHEDS, update_priority=4)),
    "sheds_fired": NO_SHEDS,
    "low_priority_updates_shed": dict(metric_sheds={"handover_defer": 2},
                                      shed_counts={"handover_defer": 2}, busy_seen=0),
    "handover_deferred": dict(metric_sheds={"update_priority": 5},
                              shed_counts={"update_priority": 5}, busy_seen=0),
    "busy_frames_le_admission_sheds": dict(busy_seen=2),
    "handovers_orchestrated": dict(handovers=0)}
# A report with no sheds at all also breaks the two required sheds: the case
# for ``sheds_fired`` runs with both requirements off, as the CI smoke does.
OVERLOAD_BREAK_PARAMS = {"sheds_fired": dict(require_update_priority=False,
                                             require_handover_defer=False)}
LOCKSTEP_LEVELS = [0, 0, 1, 2, 3, 3, 2, 1, 0, 0]
LOCKSTEP_SHEDS = {"update_priority": 9, "handover_defer": 4, "admission_connection": 3}
LOCKSTEP_REPORT = dict(
    transitions=[(0, 1, 2.5), (1, 2, 3.0), (2, 3, 3.5), (3, 2, 11.0), (2, 1, 12.0),
                 (1, 0, 13.0)],
    shed_counts=LOCKSTEP_SHEDS, metric_sheds=LOCKSTEP_SHEDS, admitted=3, busy_frames=3,
    late_closed=True, recovered_at=8, census=dict(lost_tracking=[], missing=[], duped=[]))
LOCKSTEP_BREAKS = {
    "ladder_reached_at_least_L2": ([0, 1, 1, 0], {}),
    "ladder_reached_L3": ([0, 1, 2, 2, 1, 0], {}),
    "ladder_moves_one_step_at_a_time": (None, dict(transitions=[(0, 1, 2.5), (1, 3, 3.0),
                                                                (3, 2, 11.0), (2, 1, 12.0),
                                                                (1, 0, 13.0)])),
    "no_rise_after_the_descent_began": (None, dict(transitions=[
        (0, 1, 2.5), (1, 2, 3.0), (2, 3, 3.5), (3, 2, 11.0), (2, 3, 11.5), (3, 2, 12.0),
        (2, 1, 12.5), (1, 0, 13.0)])),
    "at_L0_by_the_end": (LOCKSTEP_LEVELS[:-2], dict(recovered_at=None)),
    "shed_accounting_exact": (None, dict(metric_sheds=dict(LOCKSTEP_SHEDS, handover_defer=3))),
    "low_priority_updates_shed": (None, dict(
        shed_counts={"handover_defer": 4, "admission_connection": 3},
        metric_sheds={"handover_defer": 4, "admission_connection": 3})),
    "handover_deferred": (None, dict(
        shed_counts={"update_priority": 9, "admission_connection": 3},
        metric_sheds={"update_priority": 9, "admission_connection": 3})),
    "l3_admissions_refused_with_server_busy": (None, dict(busy_frames=2)),
    "no_lost_entity_tracking": (None, dict(census=dict(lost_tracking=[7], missing=[],
                                                       duped=[]))),
    "every_entity_in_exactly_one_cell": (None, dict(census=dict(lost_tracking=[], missing=[],
                                                                duped=[7])))}
# Breaking L2 breaks L3 with it.
LOCKSTEP_ALSO = {"ladder_reached_at_least_L2": {"ladder_reached_L3"}}


def failing(checks) -> set:
    return {name for name, ok, _ in checks if not ok}


def lockstep_checks(levels, **report) -> list:
    obs = [{"governor": (lvl,)} for lvl in levels]
    return chip_smoke().overload_lockstep_checks(obs, dict(LOCKSTEP_REPORT, **report))


def test_each_checker_passes_its_unbroken_report():
    cs = chip_smoke()
    assert not failing(cs.chaos_live_checks(CHAOS_REPORT, cs.chaos_params()))
    assert not failing(cs.overload_live_checks(OVERLOAD_REPORT, cs.overload_params()))
    assert not failing(lockstep_checks(LOCKSTEP_LEVELS))


def test_every_invariant_has_a_breaking_case():
    cs = chip_smoke()
    assert {n for n, _, _ in cs.chaos_live_checks(CHAOS_REPORT, cs.chaos_params())} \
        == set(CHAOS_BREAKS)
    assert {n for n, _, _ in cs.overload_live_checks(OVERLOAD_REPORT, cs.overload_params())} \
        == set(OVERLOAD_BREAKS)
    assert {n for n, _, _ in lockstep_checks(LOCKSTEP_LEVELS)} == set(LOCKSTEP_BREAKS)


@pytest.mark.parametrize("name", sorted(CHAOS_BREAKS))
def test_chaos_checker_names_the_broken_invariant(name):
    cs = chip_smoke()
    checks = cs.chaos_live_checks(dict(CHAOS_REPORT, **CHAOS_BREAKS[name]), cs.chaos_params())
    assert failing(checks) == {name}


@pytest.mark.parametrize("name", sorted(OVERLOAD_BREAKS))
def test_overload_checker_names_the_broken_invariant(name):
    cs = chip_smoke()
    p = cs.overload_params(**OVERLOAD_BREAK_PARAMS.get(name, {}))
    assert failing(cs.overload_live_checks(dict(OVERLOAD_REPORT, **OVERLOAD_BREAKS[name]), p)) \
        == {name}


@pytest.mark.parametrize("name", sorted(LOCKSTEP_BREAKS))
def test_lockstep_checker_names_the_broken_invariant(name):
    levels, report = LOCKSTEP_BREAKS[name]
    checks = lockstep_checks(LOCKSTEP_LEVELS if levels is None else levels, **report)
    assert failing(checks) == {name} | LOCKSTEP_ALSO.get(name, set())


# ---- the live phases on the port's CPU ------------------------------------------


def test_port_chaos_live_smoke(tmp_path):
    """14b through the port on the CPU at the chaos soak's smoke scenario:
    the soak's books hold (but ``CHAOS_SMOKE_UNASSERTED``)."""
    cs = chip_smoke()
    p = cs.chaos_params(**CHAOS_SMOKE)
    r = asyncio.run(cs.chaos_live(cs.gateway_modules(PORT), CPU, p, str(tmp_path), 1))
    failed = [(name, detail) for name, ok, detail in cs.chaos_live_checks(r, p)
              if not ok and name not in CHAOS_SMOKE_UNASSERTED]
    assert not failed, failed
    assert r["engine"] == "cpu" and r["engine_ticks"] > 0


def test_port_overload_live_smoke(tmp_path):
    """14c through the port on the CPU at the overload soak's smoke
    parameters: the ladder climbs to L2 or above one step at a time and
    sheds with an exact ledger (but ``OVERLOAD_SMOKE_UNASSERTED``)."""
    cs = chip_smoke()
    p = cs.overload_params(**OVERLOAD_SMOKE)
    r = asyncio.run(cs.overload_live(cs.gateway_modules(PORT), CPU, p, str(tmp_path), 1,
                                     settle_max_s=4.0))
    failed = [(name, detail) for name, ok, detail in cs.overload_live_checks(r, p)
              if not ok and name not in OVERLOAD_SMOKE_UNASSERTED]
    assert not failed, failed
    assert r["max_level"] >= 2 and sum(r["shed_counts"].values()) > 0
    assert r["engine"] == "cpu" and r["engine_ticks"] > 0


@pytest.mark.cuda
def test_overload_lockstep_on_the_card():
    """14a small on the card against its CPU leg: every tick equal, both
    legs holding the ladder's invariants, 2 device reads a tick, K1 and K2
    once a tick and exact on the overflow tick's and the saturation tick's
    live tensors."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K

    cs = chip_smoke()
    K.build()
    launches, entries = cs.phase_overload_lockstep(
        K, torch.device("cuda", 0), cs.CpuLeg("14a", n_dev=1, **LOCKSTEP))
    assert launches["assign_count"] == launches["aoi"] > 0
    for name in ("assign_count", "aoi"):
        assert {e["max_abs_err"] for e in entries[name].values()} == {0}
