"""The simulation plane of channeld_tpu_torch against channeld_tpu.

The same seeded numpy inputs go through the JAX function and its port
(on the CPU). The RNG and every int/bool output are exact. Float
outputs of ``sim_step`` are within a stated tolerance of the reference:
XLA:CPU contracts several of the step's product-sums into FMAs, the port
rounds each product (ROADMAP F6), so a float may differ in its last
place. The port against itself is bit-exact: replays, rebuilds and the
CPU/CUDA pair. JAX is imported inside the tests that compare with it,
so on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sim.py
"""

import numpy as np
import pytest
import torch

from channeld_tpu_torch.ops import cuda_kernels as K
from channeld_tpu_torch.ops import spatial_ops as T
from channeld_tpu_torch.ops.engine import SpatialEngine

# Power-of-two world spans (1024 x 512): a fresh SEEK waypoint,
# offset + r * span, then needs no rounding of its product and is exact
# against the reference. 8x8 of 50 m cells is not, and is held to the
# float tolerance.
POW2_GRID = T.GridSpec(-512.0, -256.0, 64.0, 32.0, 16, 16)
ODD_GRID = T.GridSpec(-200.0, -150.0, 50.0, 37.5, 8, 8)
PARAMS = T.SimParams(dt=0.1, max_speed=12.0, accel=48.0, separation=0.6,
                     cohesion=0.15, arrive_radius=1.5, crowd=8,
                     p_wander=0.6, p_seek=0.3, p_idle=0.05)
# The tolerance against the reference, in units in the last place of
# the quantity's scale: the world extent for positions and waypoints,
# the top speed for velocities. One step rounds each of ~4 product-sums
# once where XLA:CPU may round it once less.
ULPS = 4


def jax_ops():
    from channeld_tpu.ops import spatial_ops as J

    return J


def tol(scale: float) -> float:
    return ULPS * float(np.spacing(np.float32(scale)))


def world_extent(grid) -> float:
    return max(abs(grid.offset_x), abs(grid.offset_z),
               abs(grid.offset_x + grid.cols * grid.cell_w),
               abs(grid.offset_z + grid.rows * grid.cell_h))


# ---- the RNG -----------------------------------------------------------------

RNG_CASES = [(0, 0, 0, 17), (7, 3, 2, 1000), (0xFFFFFFFF, 0xFFFFFFFF, 4, 777),
             (2**31, 2**32 - 2, 1, 50), (123456789, 2**31 - 1, 3, 4096),
             (0xDEADBEEF, 0, 0, 1 << 17)]


@pytest.mark.parametrize("seed,tick,lane,n", RNG_CASES)
def test_sim_rand_u32_bit_exact(seed, tick, lane, n):
    import jax.numpy as jnp

    J = jax_ops()
    bits = J.sim_rand_u32(jnp.uint32(seed), jnp.asarray(tick, jnp.uint32), lane, n)
    want = np.asarray(bits).astype(np.int64)
    got = T.sim_rand_u32(seed, tick, lane, n)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(T._unit_f32(got).numpy(), np.asarray(J._unit_f32(bits)))


def test_rand_lanes_are_sim_rand_u32_per_lane():
    lanes = T._rand_lanes(99, 12, 0, 5, 300, None)
    for lane in range(5):
        assert torch.equal(lanes[lane], T.sim_rand_u32(99, 12, lane, 300))


def test_mul_u32_is_the_low_32_bits_of_the_product():
    """The split multiply against Python's exact integers, at the edges
    of the 32-bit range (a plain int64 product would overflow there)."""
    x = np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1,
                  0x9E3779B9, 0x12345678], np.int64)
    for k in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x7FEB352D, 0x846CA68B, 0xFFFFFFFF):
        want = np.array([(int(v) * k) % 2**32 for v in x], np.int64)
        assert np.array_equal(T._mul_u32(torch.from_numpy(x), k).numpy(), want)


def test_sqrt_rn_is_the_correctly_rounded_root():
    """The port's root against the float64 root rounded once, and
    against the reference's (XLA), on a million floats and the edges."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    x = (rng.random(1 << 20) * 10.0 ** rng.integers(-30, 30, 1 << 20)).astype(np.float32)
    x[:6] = (0.0, -0.0, 1e-45, np.inf, np.nan, -1.0)
    got = T.sqrt_rn(torch.from_numpy(x)).numpy()
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(got.view(np.int32)[~np.isnan(want)],
                          want.view(np.int32)[~np.isnan(want)])
    assert np.isnan(got[np.isnan(want)]).all()
    # XLA:CPU flushes subnormal inputs to zero; on every other input the
    # roots are the same.
    normal = ~((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))
    assert np.array_equal(got[normal], np.asarray(jnp.sqrt(jnp.asarray(x)))[normal],
                          equal_nan=True)


# ---- the ordered per-cell sums -----------------------------------------------


def sequential_fold(cell, live, values, c):
    """Each cell's live values added one at a time, in slot order, in
    float32 (what a sequential scatter-add does)."""
    sums = np.zeros((c, 2), np.float32)
    counts = np.zeros(c, np.float32)
    for i in range(len(cell)):
        w = np.float32(live[i])
        k = cell[i] if live[i] else 0
        counts[k] += w
        sums[k] += values[i] * w
    return counts, sums


@pytest.mark.parametrize("case", ["uniform", "crowd", "non_finite"])
def test_ordered_cell_sums_are_the_sequential_fold(case):
    rng = np.random.default_rng(["uniform", "crowd", "non_finite"].index(case))
    n, c = 3000, 37
    cell = rng.integers(0, c, n)
    live = rng.random(n) < 0.8
    values = (rng.normal(0, 1, (n, 2)) * 10.0 ** rng.integers(-6, 7, (n, 2))).astype(np.float32)
    if case == "crowd":
        cell[rng.random(n) < 0.6] = 5
    if case == "non_finite":
        values[7] = (np.nan, 1.0)  # a live NaN poisons its own cell
        values[11] = (np.inf, -np.inf)
        live[11] = False  # a non-live inf poisons cell 0 (inf * 0)
    with np.errstate(invalid="ignore"):
        want_counts, want_sums = sequential_fold(cell, live, values, c)
    counts, sums = T.ordered_cell_sums(torch.from_numpy(cell), torch.from_numpy(live),
                                       torch.from_numpy(values), c)
    assert np.array_equal(counts.numpy(), want_counts)
    assert np.array_equal(sums.numpy(), want_sums, equal_nan=True)


# ---- one sim_step against the reference --------------------------------------


def step_inputs(grid, n, rng, case):
    """(positions, vel, state, target, agent, flee) for one step: agents
    in every FSM state, a crowded cell, waypoints reached and not, a few
    humans and free slots, and per case a flee mask, agents racing out
    of the world, or a human at NaN."""
    lo_x, lo_z = grid.offset_x, grid.offset_z
    span_x, span_z = grid.cols * grid.cell_w, grid.rows * grid.cell_h
    pos = np.stack([rng.uniform(lo_x, lo_x + span_x, n), rng.uniform(-5, 5, n),
                    rng.uniform(lo_z, lo_z + span_z, n)], axis=1).astype(np.float32)
    crowd = rng.permutation(n)[: n // 4]  # cell (1, 1), above PARAMS.crowd
    pos[crowd, 0] = lo_x + grid.cell_w * (1 + rng.random(crowd.size))
    pos[crowd, 2] = lo_z + grid.cell_h * (1 + rng.random(crowd.size))
    vel = rng.normal(0, 4, (n, 3)).astype(np.float32)
    vel[:, 1] = 0.0
    state = rng.integers(0, 4, n).astype(np.int32)
    target = (pos + rng.normal(0, 8, (n, 3))).astype(np.float32)
    arrived = rng.random(n) < 0.3
    target[arrived] = pos[arrived] + np.float32(0.5)
    agent = rng.random(n) < 0.85
    flee = np.zeros(grid.cols * grid.rows, bool)
    if case == "flee":
        flee[rng.permutation(flee.size)[: flee.size // 4]] = True
        flee[grid.cols + 1] = True  # the crowded cell
    if case == "clamp":
        edge = rng.permutation(n)[: n // 3]
        pos[edge, 0] = lo_x + span_x - np.float32(0.01)
        pos[edge, 2] = lo_z + np.float32(0.01)
        vel[edge] = (50.0, 0.0, -50.0)
        target[edge, 0] = lo_x + 2 * span_x
        target[edge, 2] = lo_z - span_z
        state[edge] = T.SIM_SEEK
        agent[edge] = True
    if case == "nan_human":
        pos[3] = (np.nan, 0.0, np.nan)
        agent[3] = False
        pos[4] = (lo_x + 1.0, 0.0, lo_z + 1.0)  # an agent in cell 0
        agent[4] = True
    return pos, vel, state, target, agent, flee


def run_both(grid, arrays, seed=5, tick=3):
    import jax
    import jax.numpy as jnp

    J = jax_ops()
    step = jax.jit(J.sim_step, static_argnums=(0, 7))
    want = [np.asarray(a) for a in step(
        grid, *(jnp.asarray(a) for a in arrays), J.SimParams(*PARAMS),
        jnp.uint32(seed), jnp.int32(tick))]
    got = [a.numpy() for a in T.sim_step(
        grid, *(torch.from_numpy(a) for a in arrays), PARAMS, seed, tick)]
    return want, got


STEP_CASES = [("pow2", POW2_GRID, "flee"), ("pow2", POW2_GRID, "clamp"),
              ("odd", ODD_GRID, "flee"), ("odd", ODD_GRID, "nan_human")]


@pytest.mark.parametrize("label,grid,case", STEP_CASES,
                         ids=[f"{g}-{c}" for g, _, c in STEP_CASES])
def test_one_sim_step_matches_jax(label, grid, case):
    """FSM states exact; non-agent lanes bit-for-bit; positions,
    velocities and waypoints within ULPS ulps of their scale (waypoints
    exact on the power-of-two world)."""
    rng = np.random.default_rng(STEP_CASES.index((label, grid, case)))
    arrays = step_inputs(grid, 600, rng, case)
    pos, vel, state, target, agent, _ = arrays
    want, got = run_both(grid, arrays)
    assert np.array_equal(got[2], want[2])
    human = ~agent
    for g, a in zip(got, (pos, vel, state, target)):
        assert np.array_equal(g[human], a[human], equal_nan=True)
    extent = world_extent(grid)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol(extent))
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol(PARAMS.max_speed))
    if label == "pow2":
        assert np.array_equal(got[3], want[3])
    else:
        np.testing.assert_allclose(got[3], want[3], rtol=0, atol=tol(extent))
    lo = np.float32(grid.offset_x) + np.float32(min(grid.cell_w, grid.cell_h) * 1e-3)
    assert np.nanmin(got[0][agent, 0]) >= lo  # the world clamp
    if case == "clamp":
        assert (got[0][agent, 0] < grid.offset_x + grid.cols * grid.cell_w).all()
    if case == "nan_human":
        # The reference scatters the human's NaN * 0 into cell 0: its
        # agents go NaN in both.
        assert np.isnan(want[0][4, 0]) and np.isnan(got[0][4, 0])


def test_sim_step_covers_every_transition_and_writes_no_input():
    rng = np.random.default_rng(11)
    arrays = step_inputs(POW2_GRID, 2000, rng, "flee")
    before = [a.copy() for a in arrays]
    tensors = [torch.from_numpy(a) for a in arrays]
    out = T.sim_step(POW2_GRID, *tensors, PARAMS, 5, 3)
    for t, a in zip(tensors, before):
        assert np.array_equal(t.numpy(), a, equal_nan=True)
    assert all(o.data_ptr() != t.data_ptr() for o, t in zip(out, tensors))
    state, agent = arrays[2], arrays[4]
    moves = set(zip(state[agent].tolist(), out[2].numpy()[agent].tolist()))
    S = T
    for move in [(S.SIM_SEEK, S.SIM_IDLE), (S.SIM_WANDER, S.SIM_SEEK),
                 (S.SIM_WANDER, S.SIM_IDLE), (S.SIM_IDLE, S.SIM_WANDER),
                 (S.SIM_IDLE, S.SIM_FLEE), (S.SIM_FLEE, S.SIM_WANDER),
                 (S.SIM_FLEE, S.SIM_FLEE), (S.SIM_SEEK, S.SIM_SEEK),
                 (S.SIM_IDLE, S.SIM_IDLE), (S.SIM_WANDER, S.SIM_WANDER)]:
        assert move in moves, move


# ---- the port's engine on its own ----------------------------------------------

ENGINE_GRID = T.GridSpec(0.0, 0.0, 25.0, 100.0, 4, 1)


def make_engine(agents=32, seed=7, device="cpu"):
    eng = SpatialEngine(ENGINE_GRID, entity_capacity=128, query_capacity=8, device=device)
    rng = np.random.default_rng(seed)
    entries = [(0x480000 + i, float(rng.uniform(2, 98)), 0.0, float(rng.uniform(2, 98)))
               for i in range(agents)]
    eng.seed_agents(entries, seed, PARAMS)
    eng.run_sim_pass = True
    return eng


def engine_seeds(eng):
    """{slot: cell} baselines from the host-shadow positions."""
    g = eng.grid
    seeds = {}
    for _, slot in eng.tracked_entities():
        x, _, z = eng._positions[slot]
        col = min(max(int((x - g.offset_x) / g.cell_w), 0), g.cols - 1)
        row = min(max(int((z - g.offset_z) / g.cell_h), 0), g.rows - 1)
        seeds[slot] = row * g.cols + col
    return seeds


def sim_columns(eng):
    slots = torch.from_numpy(eng.agent_slots())
    return [t.cpu()[slots].numpy() for t in
            (eng._d_positions, eng._d_vel, eng._d_sim_state, eng._d_sim_target)]


def census(eng):
    eng.sim_census_due = True
    out = eng.tick()
    eng.sim_census_due = False
    cols = tuple(t.cpu().numpy() for t in out["sim_census"])
    eng.absorb_census(eng.agent_slots(), *cols)
    return out


def test_replay_is_bit_exact_and_seeds_diverge():
    a, b, c = make_engine(seed=11), make_engine(seed=11), make_engine(seed=12)
    start = a._positions[a.agent_slots()].copy()
    for _ in range(8):
        for eng in (a, b, c):
            eng.tick()
    for x, y in zip(sim_columns(a), sim_columns(b)):
        assert np.array_equal(x, y, equal_nan=True)
    assert not np.array_equal(sim_columns(a)[0], sim_columns(c)[0])
    assert np.abs(sim_columns(a)[0] - start).sum() > 1.0
    assert a.sim_tick == 8


def test_generation_fence_abandons_a_torn_sim_batch(monkeypatch):
    """A watchdog that gives up on a step after the sim pass ran and
    before the commit: the tick raises, sim_tick stays, the engine's
    columns are the ones from before the step, and a rebuild from the
    host shadow verifies and resumes."""
    import channeld_tpu_torch.ops.engine as engine_mod

    eng = make_engine(seed=13)
    for _ in range(3):
        eng.tick()
    census(eng)
    tick_before = eng.sim_tick
    columns_before = sim_columns(eng)
    real_step = engine_mod.spatial_step

    def hijacked(*args, **kwargs):
        eng.generation += 1  # the watchdog abandons this step
        return real_step(*args, **kwargs)

    monkeypatch.setattr(engine_mod, "spatial_step", hijacked)
    with pytest.raises(RuntimeError, match="abandoned"):
        eng.tick()
    monkeypatch.setattr(engine_mod, "spatial_step", real_step)
    assert eng.sim_tick == tick_before
    for x, y in zip(sim_columns(eng), columns_before):
        assert np.array_equal(x, y, equal_nan=True)
    seeds = engine_seeds(eng)
    eng.rebuild_device_state(seeds)
    assert eng.verify_device_state(seeds) == []
    eng.tick()
    assert eng.sim_tick == tick_before + 1


def test_rebuild_is_bit_identical_and_counted():
    eng = make_engine(seed=9)
    for _ in range(6):
        eng.tick()
    census(eng)
    before = sim_columns(eng)
    epoch = eng.query_epoch
    seeds = engine_seeds(eng)
    eng.rebuild_device_state(seeds)
    assert eng.verify_device_state(seeds) == []
    for x, y in zip(sim_columns(eng), before):
        assert np.array_equal(x, y, equal_nan=True)
    assert eng.sim_rebuild_counts == {"verified": 1}
    assert eng.query_epoch == epoch + 1
    # A mismatch is found and counted too.
    eng._d_vel = eng._d_vel.index_fill(0, torch.tensor([int(eng.agent_slots()[0])]), 7.0)
    assert eng.verify_device_state(seeds) == ["agent velocities differ from host shadow"]
    assert eng.sim_rebuild_counts == {"verified": 1, "mismatch": 1}
    eng.rebuild_device_state(seeds)
    eng.tick()
    assert eng.sim_tick == 8


def test_census_columns_survive_later_scatters():
    """The census is a copy: host rows flushed into the engine's columns
    in place on the next tick do not reach a census still held."""
    eng = make_engine(seed=4)
    out = census(eng)
    held = [t.clone() for t in out["sim_census"]]
    slot = int(eng.agent_slots()[0])
    eng.update_entity(int(eng.entity_id_of_slot(slot)), 1.0, 0.0, 1.0)
    eng.sim_stampede(2)
    eng.tick()
    for t, h in zip(out["sim_census"], held):
        assert torch.equal(t, h)


# ---- on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_sim_path_on_the_card_is_deterministic_and_equals_the_cpu():
    """Two runs of the sim path on the card are bit-identical in every
    sim column, and each tick's outputs equal the CPU port's, floats
    included (the per-cell sums are added in one order on both)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    K.reset_launch_counts()
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        eng = make_engine(agents=100, seed=21, device=device)
        eng.set_flee_cells([1])
        eng.set_query(1, T.AOI_SPHERE, (50.0, 50.0), (30.0, 0.0))
        eng.track_query_changes = True
        ticks = []
        for _ in range(6):
            out = eng.tick()
            ticks.append((eng.consume(out)[0], eng.handover_list(out),
                          eng.query_changed_rows(out)[1].tolist()))
        runs.append((ticks, [c.copy() for c in sim_columns(eng)]))
    assert K.launch_counts() == {"assign_count": 12, "aoi": 12}
    for ticks, columns in runs[1:]:
        assert ticks == runs[0][0]
        for x, y in zip(columns, runs[0][1]):
            assert np.array_equal(x, y, equal_nan=True)
