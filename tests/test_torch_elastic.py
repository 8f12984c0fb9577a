"""The elastic world: live cell split and merge, the balancer's granule
migrations and failover re-hosts through the port's GPU controller,
against the JAX gateway's, tick for tick.

Each run drives one seeded world through the JAX package's
``TPUSpatialController`` (JAX on the CPU) and then through the port's
``GPUSpatialController`` on ``device="cpu"``, on the schedule of
``chip_smoke.elastic_scenario`` (the port's copy of
scripts/density_soak.py's phases; the test loads chip_smoke.py by path)
under one fixed ``time.monotonic``: a pileup into a quarter of one cell
splits it twice (the device grid goes 4x4 -> 8x8 -> 16x16) and the
balancer migrates the granules; a repile into a second cell whose owner
is dropped on the tick its split starts draining (the split aborts,
failover re-hosts the cell, the re-planned split commits, a
``device.step_hang`` on its commit tick); then the crowd disperses and
cold siblings consolidate and merge back to the boot grid. Every tick's
handovers, spatial tables, outbound streams (the cell geometry, migration
and re-host messages among them), changed query rows, due slots, the
guard tuple, the geometry epoch, the micro grid and its leaf map, the
partition, balancer and failover ledgers, the journal, the deferred and
frozen crossings and the device's cell baselines must be equal.

The JAX legs of those runs take the port's seed for a leaf that a merge
has just retired (ROADMAP F14): the reference seeds it past the base grid
and its readback sentinel then rebuilds the engine for a corruption that
never happened; ``test_merge_to_the_boot_grid_seeds_inside_it`` shows
both packages' own behaviour.

Also here: the port restoring the JAX gateway's WAL with a committed
geometry record, a hang on a re-grid's commit tick and one while a split
drains, F8's readiness text, the schedule itself, and one ``cuda`` case
(``apply_grid`` on a card engine against a CPU engine through both of
K1's histogram paths).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from test_torch_gateway import (
    CONFIG_4X4,
    CONFIG_CELLS,
    JAX,
    PORT,
    FixedClock,
    World,
    first_difference,
    fresh_runtime,
    mod,
    port_globals,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = (JAX, PORT)
START = 0x10000
ENTITIES = 160
TICKS = 120
# The hang on the re-planned split's commit tick: a 300 ms stall past a
# 0.1 s deadline on that tick only (JAX compiles for a new grid inside
# the guarded step, so every other tick keeps 60 s).
HANG = dict(stall_ms=300.0, deadline_s=0.1)


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield
        for pkg in PKGS:
            if f"{pkg}.chaos" in sys.modules:
                sys.modules[f"{pkg}.chaos"].disarm()


def chip_smoke():
    """The port's harness, loaded by path (the elastic schedule lives there)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


def settings(pkg: str):
    return mod(pkg, "core.settings").global_settings


def host(x) -> np.ndarray:
    if isinstance(x, list):  # a meshed port engine: one tensor per shard
        return np.concatenate([host(p) for p in x])
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scenario(config: str, entities: int = ENTITIES, ticks: int = TICKS, hang: bool = True,
             weather: bool = False) -> dict:
    with open(config) as f:
        c = json.load(f)["Config"]
    scn = chip_smoke().elastic_scenario(entities, c["GridCols"], c["GridRows"], c["ServerCols"],
                                        c["ServerRows"], ticks, hang=hang, weather=weather)
    if hang:
        scn["hang"] = dict(HANG)
    return scn


def reference_with_port_fixes(monkeypatch) -> None:
    """The JAX controller running the port's ``_micro_of_channel`` and
    ``entity_position`` (their code against the JAX module's own globals):
    a retired cell's residents seeded at their own micro cell (ROADMAP
    F14) and a split sorting a resident whose crossing out is parked by
    where that crossing leaves from (F15). The tests named after each
    fault run the reference as it is."""
    import types

    jmod = importlib.import_module(f"{JAX}.spatial.tpu_controller")
    port_cls = mod(PORT, "spatial.gpu_controller").GPUSpatialController
    for name in ("_micro_of_channel", "entity_position"):
        fn = getattr(port_cls, name)
        monkeypatch.setattr(jmod.TPUSpatialController, name,
                            types.FunctionType(fn.__code__, jmod.__dict__, name, fn.__defaults__))


class ElasticWorld(World):
    """test_torch_gateway's World (2x2 servers, followers, sensors,
    subscriptions) with the partition, balancer and failover planes on
    ``elastic_scenario``'s schedule. A kill makes the owner's stub
    recoverable and closes it, as an aborted server socket does; the
    reaper's pass runs at each tick's start. Records every seed map the
    controller builds (with the journal's pending destinations), every
    verify, and every geometry epoch."""

    def __init__(self, pkg, clock, entities: int, scn: dict, config: str = CONFIG_4X4,
                 trigger=None):
        self.scn, self.trigger_fn = scn, trigger or chip_smoke().elastic_trigger
        s = settings(pkg)
        for name, value in chip_smoke().elastic_settings(scn).items():
            setattr(s, name, value)
        self.trigger, self.fired, self.seed_calls, self.verified, self.epochs = {}, [], [], [], []
        self.t = -1
        super().__init__(pkg, clock, entities, sim=False, config=config)
        if self.eng._mesh is not None:
            # 24 rows a shard (World's 24 is the whole engine's budget): a
            # re-grid rebuilds the step with the budget set after warmup.
            self.eng.max_handovers = 24 * self.eng._mesh.size
        mod(pkg, "core.tracing").recorder.enabled = False  # no dump per depth-bound veto
        ctl, eng = self.ctl, self.eng
        journal = mod(pkg, "core.failover").journal
        real_seeds, real_verify, real_changed = (ctl.rebuild_seed_cells, eng.verify_device_state,
                                                 ctl.on_geometry_changed)

        def recorded_seeds():
            seeds = real_seeds()
            pending = {}
            for eid, slot in eng.tracked_entities():
                dst = journal.pending_dst(eid)
                if dst is not None:
                    pending[slot] = (dst, ctl._micro_of_channel(dst, eid))
            self.seed_calls.append((self.t, sorted(seeds.items()), sorted(pending.items())))
            return seeds

        def recorded_verify(seeds):
            self.verified.append(real_verify(seeds))
            return self.verified[-1]

        def recorded_changed():
            old = (ctl._mcols, ctl._mrows)
            real_changed()
            self.epochs.append((self.t, ctl.geometry_epoch, old, (ctl._mcols, ctl._mrows)))

        ctl.rebuild_seed_cells, eng.verify_device_state = recorded_seeds, recorded_verify
        ctl.on_geometry_changed = recorded_changed
        if scn["weather"]:
            mod(pkg, "chaos").arm(chip_smoke().elastic_chaos(scn, hang=False))

    @property
    def spatial(self) -> list:
        """The live leaf channels, re-read on every use."""
        chans = mod(self.pkg, "core.channel").all_channels()
        return sorted(cid for cid, ch in chans.items()
                      if START <= cid < 0x80000 and not ch.is_removing())

    @spatial.setter
    def spatial(self, _boot) -> None:
        pass

    def drive(self, t: int) -> None:
        P = lambda name: mod(self.pkg, name)  # noqa: E731
        cs = chip_smoke()
        self.t = t
        P("core.connection_recovery").tick_connection_recovery_once()
        partition = P("spatial.partition").partition
        action = self.trigger_fn(self.scn, t, self.trigger, self.ctl, partition,
                                 P("core.failover").journal, START)
        for eid, x, z in cs.elastic_moves(self.scn, t, self.rng, self.ctl, self.entity_ids,
                                          self.positions):
            self.move(eid, x, z)
        if action == "kill":
            owner = P("core.channel").get_channel(partition.op_in_flight().target).get_owner()
            P("core.connection_recovery").make_recoverable(owner)
            owner.close(unexpected=True)
            P("core.connection")._all_connections.pop(owner.id, None)
            P("core.connection").close_epoch += 1
            self.fired.append((t, "kill", owner.id))
        elif action == "hang":
            P("chaos").arm(cs.elastic_chaos(self.scn, hang=True))
            settings(self.pkg).device_step_deadline_s = self.scn["hang"]["deadline_s"]
            self.fired.append((t, "hang", None))

    def tick(self, t: int) -> dict:
        P = lambda name: mod(self.pkg, name)  # noqa: E731
        settings(self.pkg).device_step_deadline_s = 60.0
        self.eng.last_result = None  # set again only by a tick the guard ran
        obs = super().tick(t)
        ctl, gov = self.ctl, P("core.overload").governor
        obs["elastic"] = chip_smoke().elastic_state(
            ctl, P("spatial.partition").partition, P("spatial.balancer").balancer,
            P("core.failover").plane, P("core.failover").journal)
        obs["micro_leaf"] = None if ctl._micro_leaf is None else list(ctl._micro_leaf)
        obs["baselines"] = host(self.eng._d_cell).tolist()
        obs["served"] = self.eng.last_result is not None
        obs["ladder"] = (int(gov.level), gov._level_floor)
        return obs

    def report(self) -> dict:
        P = lambda name: mod(self.pkg, name)  # noqa: E731
        part, bal = P("spatial.partition").partition, P("spatial.balancer").balancer
        chans = P("core.channel").all_channels()
        placed: dict[int, list] = {}
        for cid in self.spatial:
            for eid in chans[cid].get_data_message().entities:
                placed.setdefault(eid, []).append(cid)
        jc = P("core.failover").journal.counts
        drop = ("elapsed_ms", "duration_ms")  # host times
        return dict(
            partition=dict(part.ledger), balancer=dict(bal.ledger),
            failover=dict(P("core.failover").plane.ledger),
            partition_events=[{k: v for k, v in e.items() if k not in drop} for e in part.events],
            balancer_events=[{k: v for k, v in e.items() if k not in drop} for e in bal.events],
            rehosts=[e["rehosted"] for e in P("core.failover").plane.events],
            journal=(jc.get("prepared", 0), jc.get("committed", 0), jc.get("aborted", 0),
                     P("core.failover").journal.in_flight_count()),
            splits=sorted(self.ctl.tree.splits), micro=(self.ctl._mcols, self.ctl._mrows),
            guard=(dict(P("core.device_guard").guard.recovery_counts),
                   dict(P("core.device_guard").guard.failure_counts)),
            fired=list(self.fired), seed_calls=list(self.seed_calls), verified=list(self.verified),
            epochs=list(self.epochs),
            lost=[e for e in self.entity_ids if len(placed.get(e, ())) != 1],
            untracked=[e for e in self.entity_ids if self.eng.slot_of_entity(e) is None],
            ledger_off=[e for e in self.entity_ids
                        if self.ctl._data_cell.get(e) != placed.get(e, [None])[0]],
            in_flight=(part.op_in_flight() is None, bal.migration_in_flight() is None))


_RUNS: dict = {}


def elastic_run(monkeypatch, key: str, config: str = CONFIG_4X4, entities: int = ENTITIES,
                hang: bool = True, weather: bool = False, bucket: int = 0) -> dict:
    """The schedule through the JAX gateway, then the port's; {pkg: (per
    tick observations, report)}. Cached per process: several tests read
    one run."""
    if key in _RUNS:
        return _RUNS[key]
    if bucket:
        with open(config) as f:
            cfg = json.load(f)
        cfg["Config"]["CellBucket"] = bucket
        fd, config = tempfile.mkstemp(suffix=".json", prefix="elastic_cells_")
        with os.fdopen(fd, "w") as f:
            json.dump(cfg, f)
    scn = scenario(config, entities, hang=hang, weather=weather)
    clock = FixedClock(monkeypatch)
    reference_with_port_fixes(monkeypatch)
    out = {}
    try:
        for pkg in PKGS:
            world = ElasticWorld(pkg, clock, entities, scn, config)
            obs = [world.tick(t) for t in range(scn["ticks"])]
            out[pkg] = (obs, world.report())
            mod(pkg, "chaos").disarm()
    finally:
        if bucket:
            os.remove(config)
    _RUNS[key] = out
    return out


def assert_equal_ticks(run: dict) -> None:
    for t, (want, got) in enumerate(zip(run[JAX][0], run[PORT][0])):
        assert got == want, f"tick {t}: {first_difference(want, got)}"
    assert run[PORT][1] == run[JAX][1], first_difference(run[JAX][1], run[PORT][1])


def assert_soak_invariants(report: dict) -> None:
    """The density soak's invariants: nothing lost, duplicated or left in
    flight, planned == committed + aborted per op."""
    assert report["lost"] == [] and report["untracked"] == [] and report["ledger_off"] == []
    prepared, committed, aborted, in_flight = report["journal"]
    assert prepared == committed + aborted and in_flight == 0
    assert report["in_flight"] == (True, True)
    p = report["partition"]
    for op in ("split", "merge"):
        assert p.get(f"{op}_planned", 0) == p.get(f"{op}_committed", 0) + p.get(f"{op}_aborted", 0)
    assert report["verified"] and all(v == [] for v in report["verified"])


# ---- the single-device engine ----------------------------------------------


def test_split_regrids_the_device_engine_equal_to_jax(monkeypatch):
    """The pileup splits its cell, then the crowded child: two re-grids
    (4x4 -> 8x8 -> 16x16), each rebuilt and verified clean on both sides,
    with the same micro grid, leaf map, seeds and device baselines on
    every tick."""
    run = elastic_run(monkeypatch, "single")
    assert_equal_ticks(run)
    obs, report = run[PORT]
    regrids = [(old, new) for _, _, old, new in report["epochs"] if old != new]
    assert regrids[:2] == [((4, 4), (8, 8)), ((8, 8), (16, 16))]
    first = next(t for t, o in enumerate(obs) if o["elastic"][2] == (16, 16))
    leaf = obs[first]["micro_leaf"]
    assert len(leaf) == 256 and len(set(leaf)) == 16 - 1 + 4 - 1 + 4  # 22 leaves
    assert report["partition"]["split_committed"] >= 3
    assert report["partition"].get("split_vetoed", 0) > 0  # the depth bound
    assert_soak_invariants(report)


def test_granule_migrations_equal_to_jax(monkeypatch):
    """The balancer moves the split's granules to other servers: the same
    migrations, CellMigratedMessage bytes to every stub, and the same
    crossings deferred while a granule was frozen."""
    run = elastic_run(monkeypatch, "single")
    assert_equal_ticks(run)
    obs, report = run[PORT]
    assert report["balancer"].get("committed", 0) >= 1
    migrated = [m for o in obs for msgs in o["sent"].values() for m in msgs if m[0] == 26]
    assert migrated
    assert any(o["elastic"][8] for o in obs)  # crossings parked on a frozen cell


def test_kill_mid_split_aborts_rehosts_and_replans(monkeypatch):
    """The repile cell's owner drops on the tick its split starts
    draining: the split aborts (dst_dead) with the epoch unchanged,
    failover re-hosts the dead server's cells (CellRehostedMessage), and
    the re-planned split commits on the new owner. Every seed map built
    while a journal record was in flight seeds that entity at its pending
    destination's micro cell."""
    run = elastic_run(monkeypatch, "single")
    assert_equal_ticks(run)
    obs, report = run[PORT]
    kills = [f for f in report["fired"] if f[1] == "kill"]
    assert len(kills) == 1
    aborted = [e for e in report["partition_events"] if e["result"] == "aborted"]
    assert len(aborted) == 1 and aborted[0]["op"] == "split" and aborted[0]["reason"] == "dst_dead"
    epoch_before = obs[kills[0][0] - 1]["elastic"][0]
    assert aborted[0]["epoch"] == epoch_before
    assert report["failover"]["cells_rehosted"] >= 1
    assert any(m[0] == 25 for o in obs for msgs in o["sent"].values() for m in msgs)
    replanned = [e for e in report["partition_events"] if e["op"] == "split"
                 and e["result"] == "committed" and e["target"] == aborted[0]["target"]]
    assert replanned
    pending = [(seeds, p) for _, seeds, p in report["seed_calls"] if p]
    assert pending
    for seeds, p in pending:
        seeds = dict(seeds)
        assert all(seeds[slot] == micro for slot, (_, micro) in p)


def test_merge_returns_the_device_grid_to_the_boot_geometry(monkeypatch):
    """The crowd disperses: cold sibling groups consolidate on one owner
    (directed migrations) and merge back until the device grid is 4x4
    again, equal to JAX on every tick; nothing lost or duplicated."""
    run = elastic_run(monkeypatch, "single")
    assert_equal_ticks(run)
    obs, report = run[PORT]
    assert report["splits"] == [] and report["micro"] == (4, 4)
    assert obs[-1]["micro_leaf"] is None
    assert report["partition"]["merge_committed"] >= 2
    assert any(m[0] == 28 for o in obs for msgs in o["sent"].values() for m in msgs)
    assert_soak_invariants(report)


def test_hang_on_a_commit_tick_meets_the_committed_op(monkeypatch):
    """The ``device.step_hang`` lands on the tick the re-planned split
    commits (the geometry is applied before the guarded step): the
    watchdog abandons the step, the ladder is pinned at L2, the rebuild
    seeds from the new geometry, and the committed op settles during the
    outage. The same ticks, ledgers and seeds as the JAX guard."""
    run = elastic_run(monkeypatch, "single")
    assert_equal_ticks(run)
    obs, report = run[PORT]
    (hang_tick, _, _), = [f for f in report["fired"] if f[1] == "hang"]
    (_, _, _, micro), = [e for e in report["epochs"] if e[0] == hang_tick]
    assert not obs[hang_tick]["served"] and obs[hang_tick]["ladder"] == (2, 0)
    assert report["guard"] == ({"hang": 1}, {"hang": 1})
    rebuilt = [seeds for t, seeds, _ in report["seed_calls"] if t == hang_tick]
    assert rebuilt and all(0 <= c < micro[0] * micro[1] for seeds in rebuilt for _, c in seeds)
    # The partition plane's ticks count from 1: the op was planned before
    # the hang tick and settled after it.
    (op,) = [e for e in report["partition_events"] if e["result"] == "committed"
             and e["planned_tick"] - 1 < hang_tick < e["resolved_tick"] - 1]
    assert op["op"] == "split"


def mini_runs(monkeypatch, entities: int, ticks: int, phases: dict, trigger=None,
              hang: bool = False) -> dict:
    """A depth-1 schedule through the JAX gateway (as it is, unless the
    caller patched it) and the port's: {pkg: (per tick observations,
    report)}."""
    clock = FixedClock(monkeypatch)
    out = {}
    for pkg in PKGS:
        scn = scenario(CONFIG_4X4, entities, ticks, hang=hang)
        scn["phases"] = dict(phases)
        scn["partition"]["max_depth"] = 1
        world = ElasticWorld(pkg, clock, entities, scn, trigger=trigger)
        out[pkg] = ([world.tick(t) for t in range(ticks)], world.report())
        mod(pkg, "chaos").disarm()
    return out


def test_hang_on_a_regrid_commit_tick_rebuilds_on_the_new_grid(monkeypatch):
    """The hang lands on the tick a depth-changing split commits: the
    commit's ``apply_grid`` rebuilds and verifies the engine on the new
    grid (4x4 -> 8x8) before the guarded step hangs; the watchdog then
    fences the zombie off, the guard rebuilds again from seeds on the new
    grid, and both verify clean. Equal to the JAX gateway tick for tick."""

    def commit_trigger(scn, t, state, ctl, partition, journal, start):
        op = partition.op_in_flight()
        if (op is not None and op.op == "split" and op.state == "draining"
                and "hung" not in state
                and partition._tick + 1 - op.planned_tick >= scn["partition"]["freeze_min_ticks"]
                and not journal.in_flight_touching(op.target)):
            state["hung"] = (t, op.op_id)
            return "hang"
        return None

    reference_with_port_fixes(monkeypatch)
    phases = dict(warmup=(0, 2), pileup=(2, 24), repile=(24, 24), disperse=(24, 24))
    out = mini_runs(monkeypatch, 64, 24, phases, trigger=commit_trigger, hang=True)
    assert_equal_ticks(out)
    obs, report = out[PORT]
    (hang_tick, _, _), = report["fired"]
    assert [(t, old, new) for t, _, old, new in report["epochs"]] == [(hang_tick, (4, 4), (8, 8))]
    assert not obs[hang_tick]["served"] and report["guard"] == ({"hang": 1}, {"hang": 1})
    assert len(report["verified"]) == 2 and all(v == [] for v in report["verified"])
    assert report["partition"]["split_committed"] == 1 and "split_aborted" not in report["partition"]
    assert report["lost"] == [] and report["ledger_off"] == []


def test_retired_cells_seed_their_residents_in_place(monkeypatch):
    """ROADMAP F14. A split or a merge applies its geometry before it
    moves the residents, so the seeds name the retired cells. The
    reference seeds every resident at its retired cell's center: the
    next step reports each one off it as a crossing (rows the handover
    budget then lacks), and after a merge back to the base grid a
    retired child's id maps past the grid, so the readback sentinel
    rebuilds the engine for a corruption that never happened. The port
    seeds each resident at its own micro cell: neither happens, and the
    tables come out the same."""
    phases = dict(warmup=(0, 2), pileup=(2, 16), repile=(16, 16), disperse=(16, 40))
    out = mini_runs(monkeypatch, 64, 40, phases)
    for pkg in PKGS:
        obs, report = out[pkg]
        assert report["partition"]["merge_committed"] == 1 and report["micro"] == (4, 4), pkg
        assert report["lost"] == [] and report["ledger_off"] == [], pkg
    epochs = out[PORT][1]["epochs"]
    assert [e[:1] + e[2:] for e in out[JAX][1]["epochs"]] == [e[:1] + e[2:] for e in epochs]
    (split_tick, _, _, _), (merge_tick, _, _, _) = epochs

    def rows(pkg, t):
        return sum(len(h) for h in out[pkg][0][t]["handovers"])

    assert rows(JAX, split_tick) == 24 and rows(PORT, split_tick) == 0  # 24: the row budget
    jax_seeds = [s for t, s, _ in out[JAX][1]["seed_calls"] if t == merge_tick][0]
    port_seeds = [s for t, s, _ in out[PORT][1]["seed_calls"] if t == merge_tick][0]
    assert max(c for _, c in jax_seeds) >= 16  # a retired child's id, past the grid
    assert max(c for _, c in port_seeds) < 16
    assert out[JAX][1]["guard"] == ({"corruption": 1}, {"corruption": 1})
    assert not out[JAX][0][merge_tick]["served"]
    assert out[PORT][1]["guard"] == ({}, {})
    assert all(o["served"] for o in out[PORT][0])
    assert out[PORT][0][-1]["tables"] == out[JAX][0][-1]["tables"]


def test_a_split_keeps_residents_whose_crossing_out_is_parked_in_one_cell(monkeypatch):
    """ROADMAP F15. The crowd leaves the cell on the tick after its split
    is planned: their crossings out of the frozen cell are parked, and
    the split commits with them still resident. The reference sorts them
    into children by their new positions (outside the cell), while the
    parked crossings replay from their old ones: the replay removes each
    from another child than the one holding it and the copy stays behind
    (entities in two cells). The port sorts them by where the parked
    crossing leaves from: every entity in exactly one cell."""

    def leave_trigger(scn, t, state, ctl, partition, journal, start):
        op = partition.op_in_flight()
        if (op is not None and op.op == "split" and op.state == "draining"
                and "left" not in state):
            state["left"] = t
            scn["phases"].update(pileup=(2, t), repile=(t, t), disperse=(t, scn["ticks"]))
        return None

    phases = dict(warmup=(0, 2), pileup=(2, 40), repile=(40, 40), disperse=(40, 40))
    out = mini_runs(monkeypatch, 64, 24, phases, trigger=leave_trigger)
    jax, port = out[JAX][1], out[PORT][1]
    assert jax["partition"]["split_committed"] == port["partition"]["split_committed"] == 1
    assert jax["lost"] and port["lost"] == []
    assert port["ledger_off"] == [] and port["untracked"] == []


def test_hang_while_a_split_drains_aborts_it(monkeypatch):
    """A hang one tick into a split's drain: the next tick's advance finds
    the ladder pinned at L2 and aborts the op (``overload``), nothing
    mutated; the split is re-planned and commits after the recovery.
    Equal to the JAX gateway tick for tick (an op commits during an
    outage only when its commit came before the hung step)."""

    def drain_trigger(scn, t, state, ctl, partition, journal, start):
        op = partition.op_in_flight()
        if (op is not None and op.op == "split" and op.state == "draining"
                and partition._tick == op.planned_tick and "hung" not in state):
            state["hung"] = (t, op.op_id)
            return "hang"
        return None

    reference_with_port_fixes(monkeypatch)
    phases = dict(warmup=(0, 2), pileup=(2, 30), repile=(30, 30), disperse=(30, 60))
    out = mini_runs(monkeypatch, 64, 60, phases, trigger=drain_trigger, hang=True)
    assert_equal_ticks(out)
    obs, report = out[PORT]
    aborted = [e for e in report["partition_events"] if e["result"] == "aborted"]
    assert [e["reason"] for e in aborted] == ["overload"]
    assert report["partition"]["split_committed"] == 1 and report["guard"][0] == {"hang": 1}
    assert report["splits"] == [] and report["partition"]["merge_committed"] == 1


# ---- the cells plane --------------------------------------------------------


def test_cells_plane_elastic_equal_to_jax(monkeypatch):
    """config/spatial_tpu_cells_2x2.json's world (Sharding cells) on 8
    CPU shards against JAX's 8 virtual devices, with the density soak's
    dispatch-stall weather and a CellBucket the pileup overflows (shed and
    re-offered): every re-grid re-derives each shard's block, and the
    whole schedule (splits, migrations, the kill, the re-host, the
    merges) is equal tick for tick, the undelivered slots and the
    overflow delta included."""
    run = elastic_run(monkeypatch, "cells", config=CONFIG_CELLS, hang=False, weather=True,
                      bucket=24)
    assert_equal_ticks(run)
    obs, report = run[PORT]
    assert sum(o["overflow"] for o in obs) > 0 and any(o["undelivered"] for o in obs)
    regrids = [(old, new) for _, _, old, new in report["epochs"] if old != new]
    assert ((8, 8), (16, 16)) in regrids and regrids[-1][1] == (4, 4)
    assert report["partition"]["split_aborted"] == 1 and report["failover"]["cells_rehosted"] >= 1
    assert report["balancer"].get("committed", 0) >= 1
    assert report["splits"] == []
    assert_soak_invariants(report)


# ---- state carried across: a WAL with a geometry record --------------------


def restored(pkg: str, snap: str, wal_path: str, scn: dict) -> dict:
    """One package's gateway booted as ``core/server.py`` boots it (the
    controller, then the snapshot and WAL replay) and what it holds."""
    fresh_runtime(pkg)
    mod(pkg, "models.sim").register_sim_types()
    s = settings(pkg)
    s.tpu_entity_capacity, s.tpu_query_capacity = 1024, 64
    for name, value in chip_smoke().elastic_settings(scn).items():
        setattr(s, name, value)
    if pkg == PORT:
        s.spatial_device = "cpu"
    mod(pkg, "spatial.controller").init_spatial_controller(CONFIG_4X4)
    report = mod(pkg, "core.wal").boot_replay(snap, wal_path)
    assert not report["torn"] and report["wal_records"] > 0, report
    ctl = mod(pkg, "spatial.controller").get_spatial_controller()
    chans = mod(pkg, "core.channel").all_channels()
    state = dict(
        epoch=ctl.geometry_epoch, splits=sorted(ctl.tree.splits), micro=(ctl._mcols, ctl._mrows),
        leaf=None if ctl._micro_leaf is None else list(ctl._micro_leaf),
        channels=sorted((cid, int(ch.channel_type)) for cid, ch in chans.items()),
        tables={cid: ch.get_data_message().SerializeToString(deterministic=True)
                for cid, ch in chans.items() if ch.data is not None and ch.data.msg is not None},
        ledger=dict(sorted(ctl._data_cell.items())),
        seeds=sorted(ctl.rebuild_seed_cells().items()),
        baselines=host(ctl.engine._d_cell).tolist(),
        grid=(ctl.engine.grid.cols, ctl.engine.grid.rows, ctl.engine.grid.cell_w))
    mod(pkg, "core.wal").reset_wal()
    return state


def test_port_restores_the_jax_gateways_wal_with_a_geometry_record(monkeypatch, tmp_path):
    """The JAX gateway journals the pileup (a snapshot after the first
    split, holding its geometry; the WAL through the second) and is
    abandoned; the JAX gateway and the port each boot from the snapshot
    and the WAL: the same geometry epoch, micro grid, leaf map, channels,
    tables, placement ledger, seeds and device baselines."""
    snap, wal_path = str(tmp_path / "gw.snap"), str(tmp_path / "gw.wal")
    scn = scenario(CONFIG_4X4, 96, hang=False)
    clock = FixedClock(monkeypatch)
    reference_with_port_fixes(monkeypatch)
    jwal = mod(JAX, "core.wal").wal
    settings(JAX).wal_fsync_ms = 1.0
    jwal.start(wal_path)
    world = ElasticWorld(JAX, clock, 96, scn)
    partition = mod(JAX, "spatial.partition").partition
    t = 0
    while world.ctl.tree.epoch == 0 or partition.op_in_flight() is not None:
        world.tick(t)
        t += 1
    snapshot = mod(JAX, "core.snapshot")
    snapshot.write_snapshot(snapshot.take_snapshot(), snap)
    assert snapshot.load_snapshot(snap).geometryEpoch == 1  # the first split's
    for t in range(t, 30):
        world.tick(t)
    assert world.ctl.tree.epoch >= 2 and (world.ctl._mcols, world.ctl._mrows) == (16, 16)
    assert jwal.flush()
    mod(JAX, "core.wal").reset_wal()
    from_jax = restored(JAX, snap, wal_path, scn)
    from_port = restored(PORT, snap, wal_path, scn)
    assert from_port["micro"] == (16, 16) and from_port["grid"][:2] == (16, 16)
    assert from_port["splits"] and from_port["leaf"] is not None
    assert from_port == from_jax, first_difference(from_jax, from_port)


# ---- F8: readiness after a sticky CUDA error --------------------------------


def test_readiness_reads_terminal_after_a_sticky_cuda_error():
    """A sticky CUDA error leaves the port's guard FAILED for good (F8):
    /readyz's device check says the failure is terminal and needs a
    restart; a FAILED guard still retrying its rebuild keeps the
    reference's text."""
    dg = mod(PORT, "core.device_guard")
    opshttp = mod(PORT, "core.opshttp")
    guard = dg.guard
    guard._rebuild_failed(RuntimeError("CUDA error: device-side assert triggered"))
    assert guard.terminal
    ok, detail = opshttp._device_ready()
    assert not ok and "terminally" in detail and "restart" in detail
    guard.reset()
    guard._rebuild_failed(RuntimeError("rebuild verification failed"))
    assert guard.state == dg.DeviceState.FAILED and not guard.terminal
    assert opshttp._device_ready() == (False, "device engine FAILED (rebuild retrying)")
    jax_guard = mod(JAX, "core.device_guard").guard
    jax_guard._rebuild_failed(RuntimeError("rebuild verification failed"))
    assert mod(JAX, "core.opshttp")._device_ready() == opshttp._device_ready()


# ---- the schedule -----------------------------------------------------------


def test_elastic_scenario_schedule_is_pinned():
    """chip_smoke.py's phase 11 schedule: phases, pileup cells, the kill
    and hang rules, the knobs scaled to the entity count, the weather."""
    cs = chip_smoke()
    scn = cs.elastic_scenario(4000, 15, 15, 3, 3)
    assert scn["ticks"] == 120
    assert scn["phases"] == dict(warmup=(0, 10), pileup=(10, 50), repile=(50, 70),
                                 disperse=(70, 120))
    assert scn["pileup_cells"] == ((2, 2), (12, 12))
    assert scn["hang"] == dict(stall_ms=3500.0, deadline_s=2.0) and scn["weather"] == []
    assert scn["partition"] == dict(enabled=True, split_entities=1000, merge_entities=499,
                                    max_depth=2, eval_ticks=1, hold_ticks=2, epoch_ticks=40,
                                    budget_per_epoch=6, cooldown_ticks=10, freeze_min_ticks=2,
                                    drain_deadline_ticks=30)
    assert scn["balancer"] == dict(enabled=True, imbalance_enter=1.25, imbalance_exit=1.1,
                                   hold_ticks=2, epoch_ticks=40, budget_per_epoch=3,
                                   cooldown_ticks=40, min_entity_delta=1000, freeze_min_ticks=2)
    assert (scn["recover_window_ms"], scn["overload_down_hold_s"]) == (100, 0.2)
    mesh = cs.elastic_scenario(2000, 4, 4, 2, 2, hang=False, weather=True)
    assert mesh["pileup_cells"] == ((1, 1), (3, 3)) and mesh["hang"] is None
    assert mesh["weather"] == [{"point": "device.dispatch_stall", "every_n": 40, "stall_ms": 20,
                                "max_fires": 50}]
    s = cs.elastic_settings(scn)
    assert s["partition_split_entities"] == 1000 and s["server_conn_recover_timeout_ms"] == 100
    assert s["device_step_deadline_s"] == 2.0 and s["failover_enabled"]
    assert cs.elastic_chaos(scn, hang=True)["faults"] == [
        {"point": "device.step_hang", "every_n": 1, "max_fires": 1, "stall_ms": 3500.0}]

    class Ctl:
        world_offset_x = world_offset_z = -15000.0
        grid_width = grid_height = 2000.0
        grid_cols = grid_rows = 15

    from random import Random

    ids = list(range(100))
    positions = {e: (0.0, 0.0) for e in ids}
    herd = cs.elastic_moves(scn, 10, Random(1), Ctl, ids, positions)
    x0, z0, x1, z1 = cs.elastic_region(Ctl, (2, 2))
    assert (x0, z0, x1, z1) == (-10960.0, -10960.0, -10040.0, -10040.0)
    assert len(herd) == 100 and all(x0 <= x <= x1 and z0 <= z <= z1 for _, x, z in herd)
    assert len(cs.elastic_moves(scn, 11, Random(1), Ctl, ids, positions)) == 12
    assert len(cs.elastic_moves(scn, 70, Random(1), Ctl, ids, positions)) == 100
    assert len(cs.elastic_moves(scn, 71, Random(1), Ctl, ids, positions)) == 25


# ---- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_apply_grid_on_a_card_engine_equals_a_cpu_engine():
    """``apply_grid`` split (15x15 -> 30x30 -> 60x60, K1's shared-memory
    histogram), to 256x256 (its global atomics) and merge back on a card
    engine and a CPU engine fed the same moves: every tick's handovers
    and counts equal, every rebuild verified clean on both. Needs a card;
    ``chip_smoke.py`` phase 11 runs the gateway's re-grids."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K
    from channeld_tpu_torch.ops.engine import SpatialEngine
    from channeld_tpu_torch.ops.spatial_ops import GridSpec

    dev = torch.device("cuda", 0)
    engines = [SpatialEngine(GridSpec(-15000.0, -15000.0, 2000.0, 2000.0, 15, 15),
                             entity_capacity=1 << 14, query_capacity=8, device=d)
               for d in (dev, torch.device("cpu"))]
    rng = np.random.default_rng(11)
    pos = rng.uniform(-15000, 15000, (6000, 2))
    for eng in engines:
        for j, (x, z) in enumerate(pos):
            eng.add_entity(0x80000 + j, float(x), 0.0, float(z))
        eng.set_query(1, 1, (0.0, 0.0), (4000.0, 0.0), (1.0, 0.0), 0.5)
    paths = set()
    for n in (15, 30, 60, 256, 60, 15):
        grid = GridSpec(-15000.0, -15000.0, 30000.0 / n, 30000.0 / n, n, n)
        moves = []
        for t in range(3):
            idx = rng.permutation(len(pos))[:1500]
            pos[idx] = np.clip(pos[idx] + rng.uniform(-900, 900, (len(idx), 2)), -14999, 14999)
            moves.append([(int(j), float(pos[j, 0]), float(pos[j, 1])) for j in idx])
        seeds_xz = {0x80000 + j: (x, z) for j, (x, z) in enumerate(pos)}
        outs = []
        for eng in engines:
            if eng.grid.cols != n:
                seeds = {}
                for eid, slot in eng.tracked_entities():
                    x, z = seeds_xz[eid]
                    seeds[slot] = int((z + 15000) // grid.cell_h) * n + int((x + 15000) // grid.cell_w)
                eng.apply_grid(grid, seeds)
                assert eng.verify_device_state(seeds) == []
            ticks = []
            for t in range(3):
                for j, x, z in moves[t]:
                    eng.update_entity(0x80000 + j, x, 0.0, z)
                res = eng.tick()
                count, _, counts, _ = eng.consume(res)
                ticks.append((eng.handover_list(res), np.asarray(counts).tolist(), count))
            outs.append(ticks)
        paths.add(K.uses_shared_histogram(grid, dev))
        assert outs[0] == outs[1], f"{n}x{n}"
        assert sum(len(h) for h, _, _ in outs[0]) > 0
    assert paths == {True, False}
