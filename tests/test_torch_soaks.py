"""The device-resident populations under churn and chaos, through the port's
GPU controller against the JAX package's TPU controller, tick for tick.

``chip_smoke.py``'s phase 12 keeps the port's copies of
scripts/sim_soak.py's and scripts/sensor_soak.py's worlds and schedules
(``sim_soak_scenario``/``SimSoakWorld``, ``sensor_soak_scenario``/
``SensorSoakWorld``; the test loads chip_smoke.py by path). Each is
written against one package's modules (``gateway_modules(pkg)``), so the
same seeded world runs once through ``channeld_tpu`` (JAX on the CPU)
and once through ``channeld_tpu_torch`` on ``device="cpu"``, under one
fixed ``time.monotonic``:

- the sim soak (the smoke size of ``tests/test_sim.py``: 32 agents, 8
  humans, 20/20/8/6 ticks, a census every 3): steady censuses, the
  ``sim.stampede`` herd, ``sim.step_nan`` caught by the readback sentinel
  and healed by a rebuild from the host shadow, and a same-grid
  ``apply_grid``. Every tick's handovers, cell tables, the server's
  outbound stream, changed query rows, the guard's state and ledgers and
  the plane's, authority's and rebuild ledgers are equal exactly; the
  agent columns agree within ``ULPS`` ulps of their scale per sim pass
  (``tests/test_torch_sim.py``, ROADMAP F2), their FSM states exactly;
- ``sim.step_nan`` and ``sim.stampede`` on their own;
- the reverse of ``test_torch_gateway``'s WAL case: the port journals
  censuses and is abandoned, and the JAX gateway and the port each
  replay its WAL;
- the sensor soak at its own registrations (256 entities, 48 follows, 48
  clients, 24 sensors) over 45 ticks with its rebuild and same-grid
  epoch: every tick's changed rows, ledgers, streams, subscriptions and
  callback equal, and the soak's books on both sides.

One ``cuda`` case runs phase 12 small on the card.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from test_torch_elastic import chip_smoke
from test_torch_gateway import JAX, PORT, fresh_runtime, gateway_state, mod, port_globals
from test_torch_sim import tol

PKGS = (JAX, PORT)
CPU = torch.device("cpu")
# Host timings and the card's counts: not part of what the packages compute.
UNCOMPARED = ("sim", "tick_ms", "step_ms", "reads", "syncs")
SIM_SMOKE = dict(agents=32, humans=8, ticks=(20, 20, 8, 6), census_every=3, slots=256,
                 queries=16)
WORLD_EXTENT = 400.0  # the sim soak's 4x1 cells of 100 m


@pytest.fixture(autouse=True)
def _runtime(tmp_path):
    with port_globals(tmp_path):
        yield
        for pkg in PKGS:
            if f"{pkg}.chaos" in sys.modules:
                sys.modules[f"{pkg}.chaos"].disarm()


def sim_scenario(**kw) -> dict:
    scn = chip_smoke().sim_soak_scenario(**dict(SIM_SMOKE, **kw))
    scn["settings"]["device_step_deadline_s"] = 60.0  # a JAX compile inside a step
    return scn


def sim_world(pkg: str, clock, scn: dict, wal_path: str = ""):
    cs = chip_smoke()
    return cs.SimSoakWorld(cs.gateway_modules(pkg), CPU, clock, scn, wal_path=wal_path,
                           columns=True)


def compared(obs: dict) -> dict:
    return {k: v for k, v in obs.items() if k not in UNCOMPARED}


def assert_ticks_equal(want: list, got: list) -> None:
    cs = chip_smoke()
    assert len(got) == len(want)
    for t, (w, g) in enumerate(zip(want, got)):
        where = cs.first_gateway_diff(compared(w), compared(g))
        assert where is None, f"tick {t}: {where}"


def assert_columns_close(want: list, got: list) -> None:
    """Positions, velocities and waypoints within ULPS ulps of their scale
    per sim pass (t + 1 passes at most by tick t), FSM states exactly."""
    speed = 20.0  # the soak's sim_max_speed
    for t, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(g[2], w[2]), f"tick {t}: FSM states differ"
        for i, scale in ((0, WORLD_EXTENT), (1, speed), (3, WORLD_EXTENT)):
            np.testing.assert_allclose(g[i], w[i], rtol=0, atol=(t + 1) * tol(scale),
                                       err_msg=f"tick {t} column {i}")


def failed(checks: list) -> list:
    return [c for c in checks if not c[1]]


def run_sim_soak(scn: dict, tmp_path) -> dict:
    cs = chip_smoke()
    legs = {}
    for pkg in PKGS:
        with cs.FixedClock() as clock:
            world = sim_world(pkg, clock, scn, str(tmp_path / f"{pkg}.wal"))
            obs = world.run()
            legs[pkg] = dict(obs=obs, columns=world.columns, checks=list(world.checks),
                             report=world.report())
            world.close()
    return legs


def test_sim_soak_phases_equal_jax_tick_for_tick(tmp_path):
    """The sim soak's four phases through both packages: every tick equal
    (the agent columns within the ulp bound), every invariant of the soak
    on both sides, the stampede's crossings and the step_nan rebuild."""
    legs = run_sim_soak(sim_scenario(), tmp_path)
    want, got = legs[JAX], legs[PORT]
    assert not failed(want["checks"]) and not failed(got["checks"]), (
        failed(want["checks"]), failed(got["checks"]))
    assert len(got["checks"]) == len(want["checks"]) >= 20
    assert_ticks_equal(want["obs"], got["obs"])
    assert_columns_close(want["columns"], got["columns"])
    assert got["report"] == want["report"]
    report = got["report"]
    assert report["handovers"] > 0 and report["recoveries"] == {"corruption": 1}
    assert report["ledgers"]["chaos_stampede"] == 1 and report["ledgers"]["chaos_nan"] == 1
    assert report["ledgers"]["censuses_journaled"] >= 4
    # The corruption was caught on the guard phase's first tick.
    start = report["phase_ticks"]["guard"][0]
    caught = [t for t, o in enumerate(got["obs"]) if o["guard"][1].get("corruption")]
    assert caught[0] == start and not got["obs"][start]["served"]


@pytest.mark.parametrize("fire_at", [1, 5])
def test_sim_step_nan_is_caught_on_the_same_tick_and_healed(fire_at):
    """``sim.step_nan`` rots a quarter of the agent rows on the device. The
    readback sentinel catches the impossible source cell on the same tick
    in both packages, with equal recovery counts; the rebuild re-seeds the
    agent columns from the host shadow (the last census: every tick here)
    bit for bit, so they equal JAX's within the ulp bound of the passes run
    before the rot; nothing NaN survives. (A rot on tick 0 is overwritten
    by the spawn's pending uploads in both packages: nothing to catch.)"""
    cs = chip_smoke()
    scn = sim_scenario(census_every=1)
    cols, obs, shadows = {}, {}, {}
    for pkg in PKGS:
        P = cs.gateway_modules(pkg)
        with cs.FixedClock() as clock:
            world = sim_world(pkg, clock, scn)
            world.seed_humans()
            seen = [world.tick(t) for t in range(fire_at)]
            shadow = [np.asarray(c)[world.eng.agent_slots()].copy() for c in
                      (world.eng._positions, world.eng._vel, world.eng._sim_state,
                       world.eng._sim_target)]
            P.chaos.arm({"seed": 1, "faults": [
                {"point": "sim.step_nan", "every_n": 1, "max_fires": 1}]})
            seen.append(world.tick(fire_at))
            P.chaos.disarm()
            healed = world.columns[-1]
            seen += [world.tick(fire_at + 1 + t) for t in range(3)]
            assert world.plane.ledgers.get("chaos_nan") == 1
            assert P.guard.guard.state.name == "ACTIVE"
            assert all(np.isfinite(c).all() for c in world.columns[-1][:2])
            cols[pkg], obs[pkg], shadows[pkg] = healed, seen, shadow
            world.close()
    assert_ticks_equal(obs[JAX], obs[PORT])
    for pkg in PKGS:
        held = obs[pkg][fire_at]
        assert not held["served"] and held["guard"][1] == {"corruption": 1}, held["guard"]
        for i in range(4):  # the rebuild restored the host shadow bit for bit
            assert np.array_equal(cols[pkg][i], shadows[pkg][i]), (pkg, i)
    assert np.array_equal(cols[PORT][2], cols[JAX][2])
    for i, scale in ((0, WORLD_EXTENT), (1, 20.0), (3, WORLD_EXTENT)):
        # fire_at passes ran before the rot.
        np.testing.assert_allclose(cols[PORT][i], cols[JAX][i], rtol=0,
                                   atol=fire_at * tol(scale), err_msg=f"column {i}")


def test_sim_stampede_herds_equal_crossings():
    """``sim.stampede`` points every agent at the middle cell: both packages
    report the same crossings and FSM states on every tick, hold every
    agent's waypoint at that cell's centre, and move them within the ulp
    bound."""
    cs = chip_smoke()
    scn = sim_scenario()
    seen, cols = {}, {}
    for pkg in PKGS:
        P = cs.gateway_modules(pkg)
        with cs.FixedClock() as clock:
            world = sim_world(pkg, clock, scn)
            world.seed_humans()
            ticks = [world.tick(0)]
            P.chaos.arm({"seed": 5, "faults": [
                {"point": "sim.stampede", "every_n": 1, "max_fires": 1}]})
            ticks += [world.tick(1 + t) for t in range(10)]
            P.chaos.disarm()
            assert world.plane.ledgers.get("chaos_stampede") == 1
            eng = world.eng
            slots = eng.agent_slots()
            target = np.asarray(eng._sim_target)[slots]
            assert np.all(target[:, 0] == 250.0) and np.all(target[:, 2] == 50.0)
            seen[pkg], cols[pkg] = ticks, world.columns
            world.close()
    assert_ticks_equal(seen[JAX], seen[PORT])
    assert sum(len(o["handovers"]) for o in seen[PORT]) > 0
    assert_columns_close(cols[JAX], cols[PORT])


def replay_soak_wal(pkg: str, scn: dict, wal_path: str) -> dict:
    """A restarted gateway of ``pkg``: boot replay of the WAL, then the
    controller loaded from the soak's grid (the sim plane takes the staged
    census at activation). Returns ``gateway_state``."""
    fresh_runtime(pkg)
    mod(pkg, "sim.plane").reset_sim()
    mod(pkg, "models.sim").register_sim_types()
    report = mod(pkg, "core.wal").boot_replay("", wal_path)
    assert not report["torn"] and report["wal_records"] > 0, report
    s = mod(pkg, "core.settings").global_settings
    for name, value in scn["settings"].items():
        setattr(s, name, value)
    if pkg == PORT:
        s.spatial_device = "cpu"
    sc = mod(pkg, "spatial.controller")
    ctl = sc._controller_registry["TPUSpatialController"]()
    ctl.load_config(dict(scn["grid"]))
    sc.set_spatial_controller(ctl)
    state = gateway_state(pkg)
    state["sim_tick"] = ctl.engine.sim_tick
    state["replayed"] = dict(mod(pkg, "core.wal").wal.replay_counts)
    mod(pkg, "core.wal").reset_wal()
    return state


def test_jax_gateway_restores_the_ports_census_wal(tmp_path):
    """The port's gateway (``device="cpu"``) journals censuses and is
    abandoned on a census tick; the JAX gateway and the port each replay
    its WAL and restore the same channels, entity tables and placement
    ledger, and a census hash bit-identical to the last one the port
    journaled (ids, positions, velocities, FSM states, waypoints and the
    RNG cursor)."""
    cs = chip_smoke()
    scn = sim_scenario()
    wal_path = str(tmp_path / "port.wal")
    with cs.FixedClock() as clock:
        world = sim_world(PORT, clock, scn, wal_path)
        world.seed_humans()
        t = 0
        while world.plane.ledgers.get("censuses_journaled", 0) < 3 or world.plane._since_census:
            world.tick(t)
            t += 1
        assert mod(PORT, "core.wal").wal.flush()
        journaled, tick, n = cs.census_hash(world.eng), world.eng.sim_tick, world.eng.agent_count()
        world._unwrap()  # abandoned: no shutdown, no reset of the journal
    mod(PORT, "core.wal").reset_wal()
    restored = {pkg: replay_soak_wal(pkg, scn, wal_path) for pkg in PKGS}
    for pkg in PKGS:
        got = restored[pkg]
        assert got["census"] == journaled, pkg
        assert (got["agents"], got["sim_tick"]) == (n, tick), pkg
        assert got["replayed"].get("sim_census") == n, got["replayed"]
    for key in ("channels", "tables", "ledger", "census", "replayed"):
        assert restored[PORT][key] == restored[JAX][key], key


def test_sensor_soak_equal_jax_tick_for_tick():
    """The sensor soak's three scopes churning (clients closing and
    arriving, re-issued queries, every tick a tenth of the entities
    moved), a rebuild and a same-grid epoch: every tick's changed query
    rows, the plane's ledgers, every connection's outbound stream and
    subscriptions and the sensor callback equal; the soak's books on both
    sides, the superset check over every live client among them."""
    cs = chip_smoke()
    scn = cs.sensor_soak_scenario(256, ticks=45, slots=512, queries=512)
    scn["settings"]["device_step_deadline_s"] = 60.0
    seen, books = {}, {}
    for pkg in PKGS:
        with cs.FixedClock() as clock:
            world = cs.SensorSoakWorld(cs.gateway_modules(pkg), CPU, clock, scn)
            seen[pkg] = [world.tick(t) for t in range(scn["ticks"])]
            world.books(scn["ticks"], every_client=True)
            books[pkg] = (list(world.checks), world.report())
            world.close()
    assert_ticks_equal(seen[JAX], seen[PORT])
    for pkg in PKGS:
        assert not failed(books[pkg][0]), (pkg, failed(books[pkg][0]))
    (_, want), (_, got) = books[JAX], books[PORT]
    assert {k: v for k, v in got.items() if k != "pass_ms"} == {
        k: v for k, v in want.items() if k != "pass_ms"}
    churn_ticks = [t for t in range(scn["ticks"]) if t % 7 == 3]
    assert got["closed"] == len(churn_ticks) and got["ledgers"]["full_resyncs"] == 2
    assert got["ledgers"]["reaped"] == got["closed"] and got["callbacks"] > 0


@pytest.mark.cuda
def test_soaks_on_the_card_equal_the_cpu():
    """Phase 12 small on the card: the sim soak (96 agents, the kill leg's
    child on the card) and the sensor soak (256 entities), each card leg
    equal to its CPU leg tick for tick, every invariant on both, K1 and K2
    once per engine tick and exact on the live tensors."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K

    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    K.build()
    launches, entries = cs.phase_sim_soak(K, dev, cs.sim_soak_scenario(96, slots=4096,
                                                                       queries=64))
    assert launches["assign_count"] == launches["aoi"] > 0
    assert entries["nan"]["assign_count"]["nan_rows"] > 0
    launches, _ = cs.phase_sensor_soak(K, dev, cs.CpuLeg("12b", entities=256))
    assert launches["assign_count"] == launches["aoi"] == 90
