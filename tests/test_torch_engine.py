"""channeld_tpu_torch.ops.engine against channeld_tpu.ops.engine.

One seeded script of mutations drives both engines (the port on the
CPU); every tick's handovers, cell counts, due bits and interest rows
must be equal. The same with a simulated population stepping and the
standing-query diff on: handovers, counts, due bits, changed-query rows
and FSM states exact on every tick, agent floats within the tolerance
of tests/test_torch_sim.py per tick. Also: every method of the sim
plane and the recovery surface called on a JAX/port pair, loading a
ticked JAX engine's state (agents and diff baseline included) into a
port engine, and a mesh wider than the cards present raising ValueError.
"""

import numpy as np
import pytest
import torch

from channeld_tpu.ops import spatial_ops as J
from channeld_tpu.ops.engine import SpatialEngine as JaxEngine
from channeld_tpu_torch.ops import spatial_ops as T
from channeld_tpu_torch.ops.engine import SpatialEngine
from channeld_tpu_torch.ops.state import load_reference_state

GRID = J.GridSpec(-400.0, -400.0, 100.0, 100.0, 8, 8)
CAPS = dict(entity_capacity=48, query_capacity=8, sub_capacity=24, max_handovers=5)


def make_pair():
    return JaxEngine(GRID, **CAPS), SpatialEngine(GRID, device="cpu", **CAPS)


class Script:
    """Seeded mutations, applied identically to any number of engines."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.entities: list[int] = []
        self.next_entity = 0x80001
        self.conns: list[int] = []
        self.next_conn = 1
        self.subs: list[int] = []

    def point(self):
        r = self.rng
        x, z = r.uniform(-450, 450, 2)
        if r.random() < 0.2:  # on a cell boundary
            x = -400.0 + 100.0 * r.integers(-1, 10)
        if r.random() < 0.03:
            x = float(r.choice([np.nan, np.inf, -np.inf, 1e20]))
        return float(np.float32(x)), 0.0, float(np.float32(z))

    def step(self, engines, tick):
        r = self.rng
        ops = []
        for _ in range(int(r.integers(3, 9))):  # joins
            if len(self.entities) < CAPS["entity_capacity"] - 4:
                eid = self.next_entity
                self.next_entity += 1
                self.entities.append(eid)
                ops.append(("add_entity", eid, *self.point()))
        for eid in self.entities:  # most move; a burst overflows the rows
            if r.random() < (0.9 if tick == 4 else 0.5):
                ops.append(("update_entity", eid, *self.point()))
        for _ in range(int(r.integers(0, 3))):  # leaves (slots are reused)
            if self.entities:
                eid = self.entities.pop(int(r.integers(len(self.entities))))
                ops.append(("remove_entity", eid))
        if tick == 2 and self.entities:
            ops.append(("seed_cell", "slot_of", self.entities[0], 7))
        for _ in range(int(r.integers(1, 4))):  # queries
            if len(self.conns) < CAPS["query_capacity"] or r.random() < 0.5:
                conn = (self.conns[int(r.integers(len(self.conns)))]
                        if self.conns and r.random() < 0.5 else None)
                if conn is None and len(self.conns) < CAPS["query_capacity"]:
                    conn = self.next_conn
                    self.next_conn += 1
                    self.conns.append(conn)
                if conn is None:
                    continue
                if r.random() < 0.25:
                    spots = [tuple(float(v) for v in r.uniform(-450, 450, 2))
                             for _ in range(int(r.integers(1, 5)))]
                    dists = [int(d) for d in r.integers(0, 4, int(r.integers(0, 4)))]
                    ops.append(("set_spots_query", conn, spots, dists or None))
                else:
                    d = r.normal(size=2)
                    ops.append(("set_query", conn, int(r.integers(0, 4)),
                                tuple(self.point()[::2]),
                                tuple(float(v) for v in r.uniform(10, 250, 2)),
                                (float(d[0]), float(d[1])), float(r.uniform(0.1, 1.4))))
        if self.conns and r.random() < 0.3:
            conn = self.conns.pop(int(r.integers(len(self.conns))))
            ops.append(("remove_query", conn))
        for _ in range(int(r.integers(0, 4))):  # subscriptions
            if len(self.subs) < CAPS["sub_capacity"] - 2:
                ops.append(("add_subscription", int(r.integers(20, 120)),
                            int(r.integers(0, 150))))
        if self.subs and r.random() < 0.4:
            ops.append(("remove_subscription", self.subs.pop(int(r.integers(len(self.subs))))))
        if self.subs and r.random() < 0.5:
            ops.append(("set_sub_interval", self.subs[int(r.integers(len(self.subs)))],
                        int(r.integers(20, 120))))
        if self.subs and r.random() < 0.5:
            ops.append(("reset_sub_clock", self.subs[int(r.integers(len(self.subs)))],
                        100 + 33 * tick))
        for op in ops:
            results = set()
            for eng in engines:
                if op[0] == "seed_cell":
                    eng.seed_cell(eng.slot_of_entity(op[2]), op[3])
                    continue
                out = getattr(eng, op[0])(*op[1:])
                results.add(out)
            if op[0] == "add_subscription":
                assert len(results) == 1  # same slot from both free lists
                self.subs.append(results.pop())


def observe_jax(eng, result, conns):
    return (
        eng.handover_list(result),
        np.asarray(result["cell_counts"]),
        np.unpackbits(np.asarray(result["due_packed"]))[: eng.sub_capacity],
        eng.interested_cells_batch(result, conns),
        int(result["handover_count"]),
    )


def observe_port(eng, result, conns):
    count, _, counts, due = eng.consume(result)
    return eng.handover_list(result), counts, due, eng.interested_cells_batch(result, conns), count


def assert_same_tick(a, b):
    assert a[0] == b[0]
    assert np.array_equal(a[1], b[1])
    assert np.array_equal(a[2], b[2])
    assert a[3] == b[3]
    assert a[4] == b[4]


def test_engines_agree_tick_by_tick():
    jax_eng, port = make_pair()
    script = Script(seed=1)
    overflowed = False
    for tick in range(12):
        script.step([jax_eng, port], tick)
        now = 100 + 33 * tick
        a = observe_jax(jax_eng, jax_eng.tick(now), script.conns)
        b = observe_port(port, port.tick(now), script.conns)
        assert_same_tick(a, b)
        overflowed |= b[4] > CAPS["max_handovers"]
        for conn in script.conns[:2]:
            assert (jax_eng.interested_cells(jax_eng.last_result, conn)
                    == port.interested_cells(port.last_result, conn))
    assert overflowed


def export_state(eng) -> dict:
    """A JAX engine's tables, as ``load_reference_state`` takes them. The
    device holds the agent rows between censuses, so positions and the
    kinematic columns are read from it."""
    state = dict(
        positions=np.asarray(eng._d_positions), valid=eng._valid,
        entity_of_slot=eng._entity_of_slot, slot_of_entity=eng._slot_of_entity,
        free=eng._free, q_kind=eng._q_kind, q_center=eng._q_center,
        q_extent=eng._q_extent, q_dir=eng._q_dir, q_angle=eng._q_angle,
        q_free=eng._q_free, q_of_conn=eng._q_of_conn,
        q_spot_dist=eng._q_spot_dist, spot_sources=eng._spot_sources,
        sub_interval=eng._sub_interval, sub_active=eng._sub_active,
        sub_free=eng._sub_free,
        prev_cell=np.asarray(eng._d_cell),
        sub_last_fanout_ms=np.asarray(eng._d_sub_state[0]),
    )
    if eng.sim_enabled:
        state.update(
            sim_params=eng.sim_params, sim_seed=eng.sim_seed, sim_tick=eng.sim_tick,
            vel=np.asarray(eng._d_vel), sim_state=np.asarray(eng._d_sim_state),
            sim_target=np.asarray(eng._d_sim_target), agent_mask=np.asarray(eng._d_agent),
            flee_cells=eng._flee_cells,
        )
    if eng.track_query_changes:
        prev = eng._d_q_prev
        state.update(
            q_prev_interest=None if prev is None else np.asarray(prev[0]),
            q_prev_dist=None if prev is None else np.asarray(prev[1]),
            q_prev_reset_rows=set(eng._q_prev_reset_rows), query_epoch=eng.query_epoch,
        )
    return state


def test_load_reference_state_from_a_ticked_jax_engine():
    jax_eng = JaxEngine(GRID, **CAPS)
    script = Script(seed=2)
    for tick in range(4):
        script.step([jax_eng], tick)
        jax_eng.tick(100 + 33 * tick)
    port = SpatialEngine(GRID, device="cpu", **CAPS)
    load_reference_state(port, export_state(jax_eng))
    for tick in range(4, 9):
        script.step([jax_eng, port], tick)
        now = 100 + 33 * tick
        assert_same_tick(observe_jax(jax_eng, jax_eng.tick(now), script.conns),
                         observe_port(port, port.tick(now), script.conns))


def test_load_reference_state_checks_shapes():
    jax_eng = JaxEngine(GRID, **CAPS)
    jax_eng.tick(0)
    state = export_state(jax_eng)
    state["prev_cell"] = state["prev_cell"][:-1]
    with pytest.raises(ValueError, match="prev_cell"):
        load_reference_state(SpatialEngine(GRID, device="cpu", **CAPS), state)


@pytest.mark.parametrize("devices,hosts", [(2, 1), (8, 1), (8, 2)])
def test_mesh_wider_than_the_cards_present_raises(monkeypatch, devices, hosts):
    """As the JAX package's mesh_from_config raises for more devices than
    present (16 of its 8 virtual ones), the port's raises ValueError for
    more cards than present (one here), before any engine is built; on
    the CPU the same widths are shards of ``cpu``."""
    from channeld_tpu.parallel.mesh import mesh_from_config as jax_mesh_from_config
    from channeld_tpu_torch.parallel.mesh import mesh_from_config

    with pytest.raises(ValueError, match="devices"):
        jax_mesh_from_config(16, hosts)
    mesh = mesh_from_config(devices, hosts, device="cpu")
    assert mesh.shape == ((hosts, devices // hosts) if hosts > 1 else (devices,))
    eng = SpatialEngine(GRID, mesh=mesh, sharding="cells" if hosts == 1 else "entities",
                        device="cpu", **CAPS)
    assert eng.device.type == "cpu" and len(eng._d_positions) == devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=f"mesh wants {devices} devices but only 1 present"):
        mesh_from_config(devices, hosts, device="cuda")


def test_generation_fence_refuses_a_stale_tick():
    eng = SpatialEngine(GRID, device="cpu", **CAPS)
    eng.add_entity(0x80001, 0.0, 0.0, 0.0)
    stale = eng.generation
    eng.bump_generation()
    with pytest.raises(RuntimeError, match="stale"):
        eng._flush_host_state(expect_generation=stale)
    assert eng._dirty_slots  # nothing was committed
    out = eng.tick(10)
    assert eng.consume(out)[2].sum() == 1


# ---- the sim plane, the standing-query diff and the recovery surface ----------

SIM_CAPS = dict(CAPS, entity_capacity=96)
# Fast agents over the 8x8 world of 100 m cells, so they cross cells.
SIM_PARAMS = T.SimParams(dt=0.1, max_speed=200.0, accel=2000.0, separation=0.6,
                         cohesion=0.15, arrive_radius=1.5, crowd=4,
                         p_wander=0.6, p_seek=0.3, p_idle=0.05)
AGENTS = 20
# Float tolerance against the reference: ULPS ulps of the scale per
# tick stepped (tests/test_torch_sim.py; the differences add up).
ULPS = 4


def sim_pair(track=True):
    """A JAX/port engine pair with 20 agents, one human, two queries and
    the diff on."""
    rng = np.random.default_rng(5)
    entries = [(0x480000 + i, *np.float32(rng.uniform(-390, 390, 3)) * (1, 0, 1))
               for i in range(AGENTS)]
    pair = (JaxEngine(GRID, **SIM_CAPS), SpatialEngine(GRID, device="cpu", **SIM_CAPS))
    for eng in pair:
        eng.seed_agents([(e, float(x), float(y), float(z)) for e, x, y, z in entries],
                        17, SIM_PARAMS)
        eng.add_entity(0x80001, 10.0, 0.0, 10.0)
        eng.set_query(1, T.AOI_SPHERE, (0.0, 0.0), (150.0, 0.0))
        eng.set_query(2, T.AOI_BOX, (-200.0, 100.0), (120.0, 60.0))
        eng.add_subscription(50, 0)
        eng.run_sim_pass = True
        eng.track_query_changes = track
    return pair


def sim_tick(jax_eng, port, tick, scale_ticks):
    """One tick of both; ints exact, agent floats within tolerance."""
    now = 100 + 33 * tick
    a, b = jax_eng.tick(now), port.tick(now)
    assert_same_tick(observe_jax(jax_eng, a, [1, 2]), observe_port(port, b, [1, 2]))
    count_a, rows_a = jax_eng.query_changed_rows(a)
    count_b, rows_b = port.query_changed_rows(b)
    assert count_a == count_b and np.array_equal(rows_a, rows_b)
    assert np.array_equal(np.asarray(jax_eng._d_sim_state), port._d_sim_state.numpy())
    for want, got, scale in ((jax_eng._d_positions, port._d_positions, 400.0),
                             (jax_eng._d_vel, port._d_vel, SIM_PARAMS.max_speed),
                             (jax_eng._d_sim_target, port._d_sim_target, 800.0)):
        atol = ULPS * scale_ticks * float(np.spacing(np.float32(scale)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    return a, b


def test_engines_agree_with_agents_tracking_row_reuse_and_flee():
    jax_eng, port = sim_pair()
    script = Script(seed=3)
    handovers = rows = fled = 0
    for tick in range(10):
        script.step([jax_eng, port], tick)
        if tick == 2:
            for eng in (jax_eng, port):
                eng.set_flee_cells([0, 9, 18, 27, 36, 45])
        if tick == 6:
            for eng in (jax_eng, port):
                eng.set_flee_cells([7, 14])
        _, b = sim_tick(jax_eng, port, tick, tick + 1)
        handovers += len(port.handover_list(b))
        rows += port.query_changed_rows(b)[0]
        fled += int((port._d_sim_state.numpy()[port.agent_slots()] == T.SIM_FLEE).sum())
    assert handovers > 0 and rows > 0 and fled > 0


def census_both(pair):
    for eng in pair:
        eng.sim_census_due = True
    outs = [eng.tick(90) for eng in pair]
    for eng, out in zip(pair, outs):
        eng.sim_census_due = False
        cols = tuple(np.asarray(t) if not hasattr(t, "numpy") else t.numpy()
                     for t in out["sim_census"])
        eng.absorb_census(eng.agent_slots(), *cols)
    assert outs[0]["sim_tick"] == outs[1]["sim_tick"]


def seeds_of(eng, grid):
    g = grid
    seeds = {}
    for _, slot in eng.tracked_entities():
        x, _, z = eng._positions[slot]
        col = min(max(int((x - g.offset_x) / g.cell_w), 0), g.cols - 1)
        row = min(max(int((z - g.offset_z) / g.cell_h), 0), g.rows - 1)
        seeds[slot] = row * g.cols + col
    return seeds


NEW_GRID = J.GridSpec(-400.0, -400.0, 200.0, 200.0, 4, 4)
FORMER_LATER = ["seed_agents", "agent_slots", "agent_count", "agent_ids", "is_agent",
                "absorb_census", "set_flee_cells", "sim_stampede",
                "corrupt_sim_state_for_chaos", "sim_warmup", "rebuild_device_state",
                "apply_grid", "verify_device_state", "corrupt_device_state_for_chaos"]


@pytest.mark.parametrize("name", FORMER_LATER)
def test_former_later_slice_methods_match_jax(name):
    """Each method of the sim plane and the recovery surface, called on a
    JAX/port pair in the same state: equal return values, and the next
    ticks equal (ints exact, agent floats within tolerance)."""
    pair = sim_pair()
    jax_eng, port = pair
    for tick in range(3):
        sim_tick(jax_eng, port, tick, tick + 1)
    grid = GRID
    if name in ("rebuild_device_state", "apply_grid", "verify_device_state"):
        census_both(pair)
    if name == "seed_agents":
        more = [(0x490000 + i, -300.0 + 40 * i, 0.0, 250.0) for i in range(4)]
        args = (more, 99, SIM_PARAMS, [(1.0, 0.0, -2.0)] * 4, [T.SIM_WANDER] * 4,
                [(0.0, 0.0, 0.0)] * 4)
    elif name == "agent_ids":
        args = (np.array([0, 2, 4]),)
    elif name == "is_agent":
        args = None
    elif name == "absorb_census":
        for eng in pair:
            eng.sim_census_due = True
        outs = [eng.tick(90) for eng in pair]
        for eng in pair:
            eng.sim_census_due = False
        census = [tuple(np.asarray(t) for t in outs[0]["sim_census"]),
                  tuple(t.numpy() for t in outs[1]["sim_census"])]
        args = None
    elif name == "set_flee_cells":
        args = ([0, 1, 2, 8, 9, 10, 63, 99],)
    elif name == "sim_stampede":
        args = (27,)
    elif name == "rebuild_device_state":
        args = (seeds_of(port, grid), 200)
    elif name == "apply_grid":
        grid = NEW_GRID
        args = (NEW_GRID, seeds_of(port, NEW_GRID), 200)
    elif name == "verify_device_state":
        for eng in pair:
            eng.rebuild_device_state(seeds_of(port, grid), 200)
        args = (seeds_of(port, grid),)
    else:
        args = ()
    if name == "is_agent":
        results = [[eng.is_agent(e) for e in (0x480000, 0x480013, 0x80001, 12345)]
                   for eng in pair]
    elif name == "absorb_census":
        results = [eng.absorb_census(eng.agent_slots(), *cols)
                   for eng, cols in zip(pair, census)]
        assert np.array_equal(jax_eng._sim_state, port._sim_state)
        for a, b in ((jax_eng._positions, port._positions), (jax_eng._vel, port._vel),
                     (jax_eng._sim_target, port._sim_target)):
            np.testing.assert_allclose(b, a, rtol=0, atol=ULPS * 5 * np.spacing(np.float32(800)))
    else:
        results = [getattr(eng, name)(*args) for eng in pair]
    a, b = results
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b
    if name == "verify_device_state":
        assert a == [] and jax_eng.sim_rebuild_counts == port.sim_rebuild_counts
        for eng in pair:
            eng.corrupt_device_state_for_chaos()
        assert jax_eng.verify_device_state(args[0]) == port.verify_device_state(args[0]) != []
    if name in ("rebuild_device_state", "apply_grid"):
        assert jax_eng.query_epoch == port.query_epoch == 1
        assert jax_eng.verify_device_state(args[-2]) == port.verify_device_state(args[-2]) == []
    for tick in range(4, 7):
        sim_tick(jax_eng, port, tick, tick + 1)


def test_load_reference_state_mid_run_with_agents_and_tracking():
    """A JAX engine ticked with agents, tracking and a flee mask, taken
    mid-run (diff baseline and pending reset rows included): the port
    computes the same next ticks."""
    jax_eng, _ = sim_pair()
    script = Script(seed=6)
    jax_eng.set_flee_cells([9, 10, 11])
    for tick in range(4):
        script.step([jax_eng], tick)
        jax_eng.tick(100 + 33 * tick)
    jax_eng.remove_query(2)  # staged: its row's reset rides the state
    jax_eng._flush_host_state()
    port = SpatialEngine(GRID, device="cpu", **SIM_CAPS)
    load_reference_state(port, export_state(jax_eng))
    assert port._q_prev_reset_rows == jax_eng._q_prev_reset_rows != set()
    port.run_sim_pass = port.track_query_changes = True
    for tick in range(4, 9):
        script.step([jax_eng, port], tick)
        sim_tick(jax_eng, port, tick, tick - 3)
