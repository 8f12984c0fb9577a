"""The failover and balance soaks through the port's GPU controller, held
against the JAX package.

``chip_smoke.py``'s phase 19 keeps the port's copies of
scripts/failover_soak.py and scripts/balance_soak.py (the test loads
chip_smoke.py by path): each script's run, from its baseline to its books,
is one generator (``failover_schedule``, ``balance_schedule``) written
against one package's modules (``gateway_modules(pkg)``) and driven either
on a fixed clock or live:

- the lockstep world (``LossWorld``, 19a): the scripts' world on
  config/spatial_tpu_cells_2x2.json at 8 shards (the JAX package's 8 virtual
  devices, the port's 8 CPU shards), a master and 4 recoverable server
  stubs, the scripts' pins, knobs, weather and tables (256 slots, 32 query
  rows), 32 entities, on a fixed clock whose ``time.sleep`` moves it. The
  failover schedule keeps both kills (the first mid-handover burst, the
  second during the first failover epoch) and the probes at an orphaned
  cell; the balance schedule keeps the hotspot's migrations and the
  destination killed mid-migration, which no JAX smoke runs. Every tick's
  handovers, tables, outbound streams (the cell-authority messages apart),
  failover and balancer ledgers and events, kill timeline, journal, frozen
  and deferred crossings, cell owners and ``ownerless_drops_total`` are
  equal exactly, and both packages hold every invariant of the script;
- the live soaks (19b, 19c) through the port on ``cpu`` at
  ``tests/test_failover.py::test_failover_smoke_soak``'s and
  ``tests/test_balancer.py::test_balance_smoke_soak``'s parameters, with
  shorter timelines (the one invariant of each that a loaded CPU breaks
  left unasserted: ``SMOKE_UNASSERTED``);
- the port's copies of the scripts' parameters, scenarios, pins, invariant
  names and artifact keys equal the scripts' own, and each checker names
  the invariant a report breaks.

One ``cuda`` case runs 19a small on the card against its CPU leg.
"""

from __future__ import annotations

import ast
import asyncio
import copy
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
SMALL = dict(entity_capacity=256, query_capacity=32, entities=32)
# 19a's schedules at the scripts' tables and 32 entities, their phases shorter
# than 19a's (the kills, windows, probes and the hotspot are 19a's own).
LOCKSTEP = dict(failover=dict(SMALL, warmup_s=1.0, aftermath_s=3.0, quiesce_s=0.5),
                balance=dict(SMALL, warmup_s=1.0, kill_phase_s=5.0, aftermath_s=1.0,
                             quiesce_s=0.5))
# test_failover_smoke_soak's parameters, its 4 / 6 / 5 s cut to 2 / 4 / 2 s
# (warmup / aftermath / quiesce).
FAILOVER_SMOKE = dict(warmup_s=2.0, aftermath_s=4.0, quiesce_s=2.0, clients=6, entities=64,
                      msg_rate=15.0, storm_size=32, kills=1, recover_window_s=1.2,
                      probe_frames=12)
# test_balance_smoke_soak's parameters, its 3 / 14 / 4 / 4 s cut to 1.5 / 6 / 2 / 2 s
# (warmup / hotspot / aftermath / quiesce).
BALANCE_SMOKE = dict(warmup_s=1.5, hotspot_s=6.0, aftermath_s=2.0, quiesce_s=2.0, clients=6,
                     entities=96, msg_rate=15.0, kill_mid_migration=False, epoch_ticks=60,
                     cooldown_ticks=150, freeze_min_ticks=3)
# What each package's ``ownerless_drops_total`` holds before a lockstep leg:
# earlier tests in the same process leave counts behind, and unequal ones
# catch a world that reads the registry's total instead of its own drops.
DIRTY_DROPS = {JAX: 3, PORT: 7}
# The invariants the live smokes leave unasserted: each failed in at least one
# of 6 runs of the live cases beside other test files' live and lockstep cases
# under ``-n 4`` / ``-n 6`` on a CPU box (and held in each run alone), where
# the loaded CPU engine stretches the gateway's ticks: the prober connects and
# authenticates after the orphaned window's last frame time has passed, so it
# sends nothing (the failover soak's probes are held exactly in the lockstep
# case, and each one drop the gateway counts is still checked here); and a
# stretched tick folds the uniform warmup's crossings into one rate spike that
# arms the balancer. Phase 19 asserts them all on the card.
SMOKE_UNASSERTED = dict(failover={"ownerless_window_probed"},
                        balance={"no_migration_while_balanced"})


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield
        for pkg in PKGS:
            if f"{pkg}.chaos" in sys.modules:
                sys.modules[f"{pkg}.chaos"].disarm()


def compared(obs: dict) -> dict:
    return {k: v for k, v in obs.items() if k not in UNCOMPARED}


def failed(schedule: str, r: dict, p: dict) -> list:
    return [(name, detail) for name, ok, detail in chip_smoke().loss_checks(schedule, r, p)
            if not ok]


@pytest.mark.parametrize("schedule", ["failover", "balance"])
def test_lockstep_equals_jax_tick_for_tick(schedule, tmp_path):
    """Every tick of 19a's schedule equal in both packages, and the same
    books: the kill timeline, the failover, balancer and journal reports,
    the census and the steady-state loads. Both packages hold every
    invariant of the script under its name; the port moves two device
    tables to the host a tick (the consume blob and the query plane's
    changed rows). Each package's registry starts dirty, by a different
    count (``DIRTY_DROPS``)."""
    cs = chip_smoke()
    for pkg, n in DIRTY_DROPS.items():
        cs.gateway_modules(pkg).metrics.ownerless_drops.labels(channel_type="SPATIAL").inc(n)
    size = cs.loss_lockstep_size(str(tmp_path), n_dev=8, **LOCKSTEP)
    p, config = size[schedule]["params"], size[schedule]["config"]
    (want, wr), (got, gr) = (cs.run_loss_schedule(cs.gateway_modules(pkg), CPU, schedule, p,
                                                  config) for pkg in PKGS)
    assert len(got) == len(want)
    for t, (w, g) in enumerate(zip(want, got)):
        where = cs.first_gateway_diff(compared(w), compared(g))
        assert where is None, f"tick {t}: {where}"
    for key in ("kills", "failover", "balancer", "kill", "journal", "books", "steady_state",
                "chaos"):
        assert cs.lockstep_part(gr, key) == cs.lockstep_part(wr, key), key
    for r in (wr, gr):
        assert not failed(schedule, r, p)
        assert [c["name"] for c in r["invariants"]["checks"]] == list(cs.loss_names(schedule, p))
    assert {o["transfers"] for o in got} == {2}
    assert sum(len(o["handovers"]) for o in got) > 0
    if schedule == "failover":
        assert [k["label"] for k in gr["kills"]] == [label for _, label in cs.FAILOVER_KILLS]
        assert gr["stats"]["ownerless_drops"] == gr["stats"]["probe_frames_sent"] > 0
        assert gr["failover"]["ledger"]["cells_rehosted"] >= 8
    else:
        ledger = gr["balancer"]["ledger"]
        assert ledger["committed"] >= 3 and ledger["aborted"] == 1
        assert gr["kill"]["aborted"] and gr["kill"]["owner_is_src_after_abort"]
        assert gr["failover"]["ledger"]["servers_lost"] == 1


# ---- the copies equal the scripts ---------------------------------------------


def script(name: str):
    """One of scripts/*.py, loaded by path (tests/test_failover.py's way)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def script_tree(name: str) -> ast.AST:
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
        return ast.parse(f.read())


def script_invariants(name: str) -> list:
    """The names the script's invariant checker is handed, in source order."""
    calls = [node for node in ast.walk(script_tree(name)) if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute) and isinstance(node.func.value, ast.Name)
             and node.func.value.id == "inv" and node.args
             and isinstance(node.args[0], ast.Constant)]
    return [c.args[0].value for c in sorted(calls, key=lambda c: (c.lineno, c.col_offset))]


def script_pins(name: str, p, namespace: dict) -> dict:
    """Each ``global_settings.<name> = <value>`` the script makes, its first
    assignment, evaluated with its parameters ``p``."""
    pins = {}
    assigns = sorted((n for n in ast.walk(script_tree(name)) if isinstance(n, ast.Assign)),
                     key=lambda n: n.lineno)
    for node in assigns:
        for target in node.targets:
            if isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name) \
                    and target.value.id == "global_settings" and target.attr not in pins:
                pins[target.attr] = eval(compile(ast.Expression(node.value), name, "eval"),
                                         dict(namespace, p=p))
    return pins


@pytest.mark.parametrize("name", ["failover_soak", "balance_soak"])
def test_port_copies_equal_the_script(name):
    """chip_smoke.py's copies: the params (every field but the paths) and
    the default scenario field by field, the entity sim's seed, the
    invariant names in the script's order, the pins ``loss_pins`` sets (each
    ``global_settings`` assignment of the script, with its parameters), and
    the keys scripts/check_artifacts.py requires of the artifact."""
    cs = chip_smoke()
    mod = script(name)
    schedule = name.split("_")[0]
    params_cls = mod.FailoverSoakParams if schedule == "failover" else mod.BalanceSoakParams
    theirs = params_cls()
    mine = cs.SCHEDULES[schedule].params()
    fields = set(theirs.__dataclass_fields__) - {"config_path", "scenario", "out_path"}
    assert set(mine) - {"scenario"} == fields
    for key in fields:
        assert mine[key] == getattr(theirs, key), key
    assert mine["scenario"] == mod.default_scenario(theirs)
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
        assert f"^ {cs.SCHEDULES[schedule].sim_seed:#X}".replace("0X", "0x") in f.read()
    assert script_invariants(name) == list(cs.loss_names(schedule, mine))
    P = cs.gateway_modules(PORT)
    cs.loss_pins(P, CPU, mine, balancer=schedule == "balance")
    s = P.settings.global_settings
    pins = script_pins(name, theirs, dict(ChannelSettings=P.settings.ChannelSettings,
                                          ChannelType=P.types.ChannelType, int=int))
    assert pins and {k: getattr(s, k) for k in pins} == pins
    artifacts = script("check_artifacts")
    pattern = f"SOAK_{schedule.upper()}_*.json"
    assert artifacts.SCHEMAS[pattern] == cs.ARTIFACT_KEYS[f"{schedule}_soak"]


# ---- each checker names the invariant a report breaks --------------------------

KILLS = [dict(label="kill-1-mid-handover-burst", orphaned=True, rehosted_in_s=1.6),
         dict(label="kill-2-during-failover", orphaned=True, rehosted_in_s=1.7)]
EVENTS = [dict(orphan_cells=[1, 2, 3, 4], rehosted={"1": 2, "2": 4, "3": 5, "4": 2},
               duration_ms=2.0),
          dict(orphan_cells=[5, 6], rehosted={"5": 2, "6": 5}, duration_ms=1.5)]
JOURNAL = dict(counts={"prepared": 40, "committed": 38, "aborted": 2}, in_flight=0)
FAILOVER_REPORT = dict(
    kills=KILLS, failover=dict(events=EVENTS), journal=JOURNAL,
    books=dict(servers_lost=2, server_lost_metric=2, cells=16, cells_owned=16, rehost_metric=6,
               journal_metric=dict(JOURNAL["counts"]), lost_tracking=[], missing=[], duped=[],
               ownerless_entities=[]),
    stats=dict(probe_frames_sent=20, probe_frames_forwarded=2, ownerless_drops=18,
               cells_rehosted=6, global_tick_p99_s=0.1, post_failover_tick_p99_s=0.1,
               handovers_after_failover=5))


def _set(path: str, value):
    """A break: the report with ``path`` (dotted) set to ``value``."""
    def apply(r):
        *keys, last = path.split(".")
        for k in keys:
            r = r[k]
        r[last] = value
    return apply


FAILOVER_BREAKS = {
    "one_server_lost_event_per_kill": [_set("books.servers_lost", 3),
                                       _set("books.server_lost_metric", 3)],
    "server_lost_metric_matches_ledger": [_set("books.server_lost_metric", 1)],
    "all_cells_owned_after_failover": [_set("books.cells_owned", 15)],
    "every_orphan_cell_rehosted": [_set("failover.events", [
        EVENTS[0], dict(EVENTS[1], orphan_cells=[5, 6, 7])])],
    "failover_pass_under_deadline": [_set("failover.events", [
        EVENTS[0], dict(EVENTS[1], duration_ms=3500.0)])],
    "every_kill_orphaned_cells": [_set("kills", [KILLS[0], dict(KILLS[1], orphaned=False)])],
    "rehost_within_window_plus_deadline": [_set("kills", [KILLS[0],
                                                          dict(KILLS[1], rehosted_in_s=None)])],
    "rehost_accounting_exact": [_set("books.rehost_metric", 5)],
    "journal_metric_matches_ledger": [_set("books.journal_metric",
                                           {"prepared": 40, "committed": 38})],
    "journal_prepared_equals_committed_plus_aborted": [
        _set("journal.counts", {"prepared": 41, "committed": 38, "aborted": 2}),
        _set("books.journal_metric", {"prepared": 41, "committed": 38, "aborted": 2})],
    "journal_nothing_in_flight": [_set("journal.in_flight", 1)],
    "no_lost_entity_tracking": [_set("books.lost_tracking", [7])],
    "every_entity_in_exactly_one_cell": [_set("books.duped", [7])],
    "every_entity_channel_has_live_owner": [_set("books.ownerless_entities", [7])],
    "ownerless_drops_exact": [_set("stats.ownerless_drops", 17)],
    "ownerless_window_probed": [_set("stats.probe_frames_sent", 0),
                                _set("stats.probe_frames_forwarded", 0),
                                _set("stats.ownerless_drops", 0)],
    "global_tick_p99_bounded": [_set("stats.global_tick_p99_s", 2.0)],
    "post_failover_tick_p99_bounded": [_set("stats.post_failover_tick_p99_s", None)],
    "handovers_after_failover": [_set("stats.handovers_after_failover", 0)]}

COMMITS = [dict(cell=5, result="committed", epoch=0, resolved_tick=40),
           dict(cell=1, result="committed", epoch=0, resolved_tick=47),
           dict(cell=4, result="committed", epoch=1, resolved_tick=96),
           dict(cell=11, result="dst_dead", epoch=3, resolved_tick=330)]
LEDGER = {"planned": 4, "committed": 3, "aborted": 1}
BALANCE_REPORT = dict(
    books=dict(committed_at_warmup=0, hotspot_committed=3, steady_imbalance=1.25,
               metric_results=dict(LEDGER), in_flight=False, frozen=([], 0), lost_tracking=[],
               missing=[], duped=[]),
    balancer=dict(ledger=LEDGER, events=COMMITS),
    steady_state=dict(server_entities={"2": 30, "3": 34, "4": 32, "5": 32}),
    kill=dict(aborted=True, owner_is_src_after_abort=True), notes=[], journal=JOURNAL,
    stats=dict(global_tick_p99_s=0.1))
BALANCE_BREAKS = {
    "no_migration_while_balanced": [_set("books.committed_at_warmup", 1)],
    "hotspot_migrations_committed": [_set("books.hotspot_committed", 0)],
    "steady_state_entity_imbalance_under_threshold": [_set("books.steady_imbalance", 1.6)],
    "migration_metric_matches_ledger": [_set("books.metric_results",
                                             {"planned": 4, "committed": 3})],
    "migrations_planned_equals_committed_plus_aborted": [
        _set("balancer.ledger", {"planned": 5, "committed": 3, "aborted": 1}),
        _set("books.metric_results", {"planned": 5, "committed": 3, "aborted": 1})],
    "no_migration_left_in_flight": [_set("books.in_flight", True)],
    "no_frozen_crossing_left_behind": [_set("books.frozen", ([11], 2))],
    "per_epoch_commits_within_budget": [_set("balancer.events", COMMITS[:2] + [
        dict(COMMITS[2], epoch=0, cell=6)] + COMMITS[3:])],
    "no_cell_migrates_twice_within_cooldown": [_set("balancer.events", COMMITS[:2] + [
        dict(COMMITS[2], cell=5)] + COMMITS[3:])],
    "kill_mid_migration_landed": [_set("kill", None), _set("notes", ["no migration observed"])],
    "crash_mid_migration_aborts_to_old_owner": [_set("kill", dict(
        aborted=True, owner_is_src_after_abort=False))],
    "no_lost_entity_tracking": [_set("books.lost_tracking", [7])],
    "every_entity_in_exactly_one_cell": [_set("books.missing", [7])],
    "journal_prepared_equals_committed_plus_aborted": [
        _set("journal.counts", {"prepared": 40, "committed": 37, "aborted": 2})],
    "journal_nothing_in_flight": [_set("journal.in_flight", 2)],
    "global_tick_p99_bounded": [_set("stats.global_tick_p99_s", 1.6)]}
REPORTS = dict(failover=(FAILOVER_REPORT, FAILOVER_BREAKS),
               balance=(BALANCE_REPORT, BALANCE_BREAKS))


def failing(schedule: str, report: dict) -> set:
    cs = chip_smoke()
    p = cs.SCHEDULES[schedule].params()
    return {name for name, ok, _ in cs.loss_checks(schedule, report, p) if not ok}


@pytest.mark.parametrize("schedule", ["failover", "balance"])
def test_each_checker_passes_its_unbroken_report_and_names_every_invariant(schedule):
    cs = chip_smoke()
    report, breaks = REPORTS[schedule]
    p = cs.SCHEDULES[schedule].params()
    assert not failing(schedule, report)
    names = [name for name, _, _ in cs.loss_checks(schedule, report, p)]
    assert names == list(cs.loss_names(schedule, p)) and set(names) == set(breaks)


@pytest.mark.parametrize("schedule,name", [(s, n) for s in ("failover", "balance")
                                           for n in sorted(REPORTS[s][1])])
def test_checker_names_the_broken_invariant(schedule, name):
    report, breaks = REPORTS[schedule]
    broken = copy.deepcopy(report)
    for apply in breaks[name]:
        apply(broken)
    assert failing(schedule, broken) == {name}


# ---- the live soaks on the port's CPU -------------------------------------------


@pytest.mark.parametrize("schedule", ["failover", "balance"])
def test_port_live_smoke(schedule, tmp_path):
    """19b / 19c through the port's gateway on the CPU at the JAX smoke
    soak's parameters: every invariant of the script checked under its name
    and held (but ``SMOKE_UNASSERTED``), the artifact's keys, the engine on
    the CPU."""
    cs = chip_smoke()
    p = cs.SCHEDULES[schedule].params(**(FAILOVER_SMOKE if schedule == "failover"
                                     else BALANCE_SMOKE))
    r = asyncio.run(cs.loss_live(cs.gateway_modules(PORT), CPU, schedule, p, str(tmp_path), 1))
    assert [(name, d) for name, d in failed(schedule, r, p)
            if name not in SMOKE_UNASSERTED[schedule]] == []
    assert [c["name"] for c in r["invariants"]["checks"]] == list(cs.loss_names(schedule, p))
    assert cs.artifact_keys_missing(r) == []
    assert r["engine"] == "cpu" and r["engine_ticks"] > 0
    if schedule == "failover":
        assert r["stats"]["cells_rehosted"] >= 4 and r["stats"]["handovers_after_failover"] > 0
    else:
        assert r["stats"]["migrations_committed"] >= 1


@pytest.mark.cuda
def test_failover_balance_lockstep_on_the_card():
    """19a small on the card against its CPU leg: every tick of both
    schedules equal, both legs holding the scripts' invariants, 2 device
    reads a tick, K1 and K2 once a tick and exact on every kill, re-host and
    migration tick's live tensors."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K

    cs = chip_smoke()
    K.build()
    launches, entries = cs.phase_loss_lockstep(
        K, torch.device("cuda", 0), cs.CpuLeg("19a", n_dev=1, **LOCKSTEP))
    for path in ("failover_lockstep", "balance_lockstep"):
        assert launches[path]["assign_count"] == launches[path]["aoi"] > 0
    for name in ("assign_count", "aoi"):
        assert {e["max_abs_err"] for e in entries[name].values()} == {0}
