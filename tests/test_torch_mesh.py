"""channeld_tpu_torch.parallel.mesh and the meshed engine against the
JAX package on its 8-device virtual CPU mesh.

The port's mesh is eight shards on ``cpu`` (``spmd.Mesh`` accepts
repeated devices); the JAX package's is the 8 virtual devices that
tests/conftest.py provides. The same seeded inputs go through both:
every output of the entity-sharded step (1D, 2D, spots) is equal
exactly, and so is every tick of a meshed engine in both shardings
(handovers, counts, due bits, interest rows, changed query rows)
against the meshed JAX engine and against the port's single-device
engine. Also: the recovery surface over sharded columns, loading a
meshed JAX engine's state, the sim plane's refusal, the row budget
per shard, and ``spmd``'s collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from channeld_tpu.ops import spatial_ops as J
from channeld_tpu.ops.engine import SpatialEngine as JaxEngine
from channeld_tpu.parallel import mesh as jax_mesh
from channeld_tpu_torch.ops import spatial_ops as T
from channeld_tpu_torch.ops.engine import SpatialEngine
from channeld_tpu_torch.ops.state import load_reference_state
from channeld_tpu_torch.parallel import mesh as port_mesh
from channeld_tpu_torch.parallel import spmd

from test_torch_engine import CAPS, GRID, Script, assert_same_tick, export_state, observe_jax, observe_port

CPU8 = [torch.device("cpu")] * 8
SMALL = J.GridSpec(-150.0, -150.0, 100.0, 100.0, 3, 3)
# (JAX mesh, port mesh, sharding) of each meshed case.
MESHES = {
    "entities": (lambda: jax_mesh.make_mesh(), lambda: port_mesh.make_mesh(CPU8), "entities"),
    "entities-2d": (lambda: jax_mesh.make_mesh_2d(2), lambda: port_mesh.make_mesh_2d(2, CPU8),
                    "entities"),
    "cells": (lambda: jax_mesh.make_mesh(), lambda: port_mesh.make_mesh(CPU8), "cells"),
}


def host(x) -> np.ndarray:
    if isinstance(x, (list, tuple)):
        return torch.cat(list(x)).numpy()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_outputs_equal(jax_out: dict, port_out: dict) -> None:
    assert set(jax_out) == set(port_out)
    for key, value in jax_out.items():
        a, b = np.asarray(value), host(port_out[key])
        assert a.size == b.size, key
        np.testing.assert_array_equal(a.reshape(b.shape), b, err_msg=key)


def step_world(seed, queries_spots=False):
    """The JAX tests' 64 slots over SMALL, the first 8 pushed across
    cells, two queries and four subscriptions."""
    rng = np.random.default_rng(seed)
    n = 64
    pts = rng.uniform(-140, 140, size=(n, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::9] = False
    prev = np.asarray(J.assign_cells(SMALL, jnp.asarray(pts), jnp.asarray(valid)))
    moved = pts.copy()
    moved[:8, 0] += 120
    moved[::7, 2] += 120
    kind = np.array([T.AOI_SPOTS if queries_spots else T.AOI_SPHERE, T.AOI_CONE], np.int32)
    qs = (kind, np.zeros((2, 2), np.float32), np.array([[80, 0], [130, 40]], np.float32),
          np.array([[1, 0], [0, 1]], np.float32), np.array([0.0, 0.6], np.float32))
    spot = None
    if queries_spots:
        spot = np.full((2, SMALL.num_cells), -1, np.int32)
        spot[0, [0, 5, 7]] = [2, 1, 0]
    subs = (np.array([0, 10, 30, 60], np.int32), np.full(4, 50, np.int32),
            np.array([True, True, False, True]))
    return moved, prev, valid, qs, spot, subs


@pytest.mark.parametrize("case", ["1d", "2d", "spots"])
def test_sharded_step_equals_jax(case):
    """Ports test_ops.py's sharded-step cases (1D, 2D, spots): every output
    of the port's step equals the JAX step's, and the port's step equals
    its own single-device step on the replicated decisions."""
    moved, prev, valid, qs, spot, subs = step_world(2 if case == "1d" else 5, case == "spots")
    if case == "2d":
        jm, pm = jax_mesh.make_mesh_2d(2), port_mesh.make_mesh_2d(2, CPU8)
    else:
        jm, pm = jax_mesh.make_mesh(), port_mesh.make_mesh(CPU8)
    with_spots = spot is not None
    jq = J.QuerySet(*map(jnp.asarray, qs), None if spot is None else jnp.asarray(spot))
    pq = T.QuerySet(*map(torch.tensor, qs), None if spot is None else torch.tensor(spot))
    jax_out = jax_mesh.sharded_spatial_step(
        jax_mesh.build_sharded_step(SMALL, jm, 3, with_spots), jnp.asarray(moved),
        jnp.asarray(prev), jnp.asarray(valid), jq, tuple(map(jnp.asarray, subs)), 60)
    port_out = port_mesh.sharded_spatial_step(
        port_mesh.build_sharded_step(SMALL, pm, 3, with_spots), torch.tensor(moved),
        torch.tensor(prev), torch.tensor(valid), pq, tuple(map(torch.tensor, subs)), 60)
    assert_outputs_equal(jax_out, port_out)
    assert int(host(port_out["handover_counts"]).sum()) > 3  # some shard overflowed its 3 rows
    single = T.spatial_step(SMALL, torch.tensor(moved), torch.tensor(prev), torch.tensor(valid),
                            pq, tuple(map(torch.tensor, subs)), 24, 60)
    for key in ("cell_of", "cell_counts", "interest", "dist", "due", "new_last_fanout_ms"):
        np.testing.assert_array_equal(host(port_out[key]), single[key].numpy(), err_msg=key)
    counts, rows = port_mesh.merge_handover_shards(port_out["handover_counts"],
                                                   port_out["handovers"])
    assert (counts, rows.tolist()) == tuple(
        (c, r.tolist()) for c, r in [jax_mesh.merge_handover_shards(
            jax_out["handover_counts"], jax_out["handovers"])])[0]
    if with_spots:
        plain = port_mesh.build_sharded_step(SMALL, pm, 3)
        with pytest.raises(ValueError, match="with_spots"):
            port_mesh.sharded_spatial_step(plain, torch.tensor(moved), torch.tensor(prev),
                                           torch.tensor(valid), pq,
                                           tuple(map(torch.tensor, subs)), 60)


def test_sharded_step_takes_per_shard_parts():
    """The engine's form: lists of per-shard tensors give the same result
    as global tensors."""
    moved, prev, valid, qs, _, subs = step_world(3)
    pm = port_mesh.make_mesh(CPU8)
    step = port_mesh.build_sharded_step(SMALL, pm, 4)
    pq = T.QuerySet(*map(torch.tensor, qs))
    sub = tuple(map(torch.tensor, subs))
    a = port_mesh.sharded_spatial_step(step, torch.tensor(moved), torch.tensor(prev),
                                       torch.tensor(valid), pq, sub, 60)
    b = port_mesh.sharded_spatial_step(
        step, *(spmd.shard(pm, torch.tensor(x)) for x in (moved, prev, valid)), pq, sub, 60)
    for key in a:
        np.testing.assert_array_equal(host(a[key]), host(b[key]), err_msg=key)


def engines(case, caps=CAPS, **kwargs):
    """(JAX meshed, port meshed, port single-device) engines for a case."""
    make_jax, make_port, sharding = MESHES[case]
    return (JaxEngine(GRID, mesh=make_jax(), sharding=sharding, **caps, **kwargs),
            SpatialEngine(GRID, mesh=make_port(), sharding=sharding, device="cpu",
                          **caps, **kwargs),
            SpatialEngine(GRID, device="cpu", **caps))


def changed_rows(eng, result):
    count, rows = eng.query_changed_rows(result)
    return count, sorted(map(tuple, rows[:count].tolist()))


@pytest.mark.parametrize("case", list(MESHES))
def test_meshed_engine_equals_jax_and_single_device(case):
    """Ports test_ops.py::test_engine_mesh_matches_single_device: one
    seeded script of mutations drives the JAX meshed engine, the port's
    meshed engine and the port's single-device engine with the
    standing-query diff on, with row budgets no tick overflows. Every
    tick all three are equal: handovers (per-shard rows merged in shard
    order are in slot order), counts, due bits, interest rows, changed
    query rows."""
    caps = dict(CAPS, max_handovers=48)
    jax_eng, port, single = engines(case, caps)
    for eng in (jax_eng, port, single):
        eng.track_query_changes = True
    assert port.entity_capacity == jax_eng.entity_capacity == 48
    script = Script(seed=11)
    crossings = 0
    for tick in range(10):
        script.step([jax_eng, port, single], tick)
        now = 100 + 33 * tick
        rj, rp, rs = jax_eng.tick(now), port.tick(now), single.tick(now)
        b = observe_port(port, rp, script.conns)
        assert_same_tick(observe_jax(jax_eng, rj, script.conns), b)
        assert_same_tick(observe_port(single, rs, script.conns), b)
        assert changed_rows(jax_eng, rj) == changed_rows(port, rp) == changed_rows(single, rs)
        crossings += len(b[0])
        assert port.undelivered_slots(rp) == [] and port.last_overflow == 0
        for conn in script.conns[:2]:
            assert jax_eng.interested_cells(rj, conn) == port.interested_cells(rp, conn)
    assert crossings > 0


@pytest.mark.parametrize("case", ["entities", "cells"])
def test_meshed_row_budget_per_shard_equals_jax(case):
    """max_handovers 5 over 8 shards is one row per shard: a tick reports
    up to 8 merged rows, each shard keeps its unreported crossings'
    old cells, and every tick equals the JAX meshed engine's."""
    jax_eng, port, _ = engines(case)
    script = Script(seed=1)
    over = 0
    for tick in range(12):
        script.step([jax_eng, port], tick)
        now = 100 + 33 * tick
        b = observe_port(port, port.tick(now), script.conns)
        assert_same_tick(observe_jax(jax_eng, jax_eng.tick(now), script.conns), b)
        over += b[4] > CAPS["max_handovers"]
    assert over


@pytest.mark.parametrize("case", [None, "entities", "cells"])
def test_engine_handover_overflow_never_loses_crossings(case):
    """Ports test_ops.py::test_engine_handover_overflow_never_loses_crossings:
    with a handover budget smaller than one tick's crossings, every
    crossing is delivered across later ticks, on the mesh paths too (the
    merged rows can exceed max_handovers and must all be consumed), equal
    to the JAX engine's rows tick for tick."""
    caps = dict(entity_capacity=64, query_capacity=8, sub_capacity=8, max_handovers=10)
    if case is None:
        pair = (JaxEngine(GRID, **caps), SpatialEngine(GRID, device="cpu", **caps))
    else:
        pair = engines(case, caps)[:2]
    for eng in pair:
        for eid in range(40):
            eng.add_entity(eid, -350.0, 0.0, -350.0)
        eng.tick(now_ms=0)
        for eid in range(40):
            eng.update_entity(eid, 350.0, 0.0, 350.0)
    seen = [set(), set()]
    for tick in range(1, 8):
        lists = [eng.handover_list(eng.tick(now_ms=33 * tick)) for eng in pair]
        assert lists[0] == lists[1]
        for s, rows in zip(seen, lists):
            for e, src, dst in rows:
                assert (src, dst) == (0, 63) and e not in s
                s.add(e)
    assert seen[0] == seen[1] == set(range(40))


def test_meshed_engine_refuses_agents():
    """Ports test_sim.py::test_meshed_engine_refuses_agents."""
    eng = SpatialEngine(GRID, entity_capacity=64, query_capacity=8, device="cpu",
                        mesh=port_mesh.mesh_from_config(8, 1, device="cpu"))
    with pytest.raises(RuntimeError, match="single-device"):
        eng.seed_agents([(0x480000, 10.0, 0.0, 10.0)], 1,
                        T.SimParams(0.05, 6.0, 24.0, 0.6, 0.15, 1.5, 32, 0.2, 0.1, 0.05))


@pytest.mark.parametrize("case", ["entities", "cells"])
def test_load_reference_state_from_a_meshed_jax_engine(case):
    """A meshed JAX engine's sharded arrays arrive as numpy in global slot
    order; a meshed port engine loaded from them computes the same next
    ticks."""
    jax_eng, port, _ = engines(case)
    jax_eng.track_query_changes = True
    script = Script(seed=12)
    for tick in range(4):
        script.step([jax_eng], tick)
        jax_eng.tick(100 + 33 * tick)
    load_reference_state(port, export_state(jax_eng))
    assert isinstance(port._d_positions, list) and len(port._d_positions) == 8
    port.track_query_changes = True
    for tick in range(4, 9):
        script.step([jax_eng, port], tick)
        now = 100 + 33 * tick
        rj, rp = jax_eng.tick(now), port.tick(now)
        assert_same_tick(observe_jax(jax_eng, rj, script.conns),
                         observe_port(port, rp, script.conns))
        assert changed_rows(jax_eng, rj) == changed_rows(port, rp)


@pytest.mark.parametrize("case", ["entities", "cells"])
def test_meshed_recovery_surface_matches_jax(case):
    """rebuild/verify/corrupt/apply_grid over sharded columns, on a
    JAX/port pair of meshed engines: equal verify reports, and equal
    ticks after each."""
    jax_eng, port, _ = engines(case)
    pair = (jax_eng, port)
    script = Script(seed=13)
    for tick in range(3):
        script.step(pair, tick)
        for eng in pair:
            eng.tick(100 + 33 * tick)

    def seeds(grid):
        out = {}
        for _, slot in port.tracked_entities():
            x, _, z = port._positions[slot]
            col = min(max(int((x - grid.offset_x) / grid.cell_w), 0), grid.cols - 1) \
                if np.isfinite(x) else 0
            row = min(max(int((z - grid.offset_z) / grid.cell_h), 0), grid.rows - 1)
            out[slot] = row * grid.cols + col
        return out

    for eng in pair:
        eng.rebuild_device_state(seeds(GRID), 200)
    assert jax_eng.verify_device_state(seeds(GRID)) == port.verify_device_state(seeds(GRID)) == []
    for eng in pair:
        eng.corrupt_device_state_for_chaos()
    bad = port.verify_device_state(seeds(GRID))
    assert bad == jax_eng.verify_device_state(seeds(GRID)) != []
    new_grid = J.GridSpec(-400.0, -400.0, 200.0, 200.0, 4, 4)
    for eng in pair:
        eng.apply_grid(new_grid, seeds(new_grid), 250)
    assert port._mesh_step is None
    assert jax_eng.verify_device_state(seeds(new_grid)) == \
        port.verify_device_state(seeds(new_grid)) == []
    for tick in range(4, 7):
        script.step(pair, tick)
        now = 300 + 33 * tick
        assert_same_tick(observe_jax(jax_eng, jax_eng.tick(now), script.conns),
                         observe_port(port, port.tick(now), script.conns))


def test_mesh_consume_is_one_read_per_tick(monkeypatch):
    """A meshed tick's handovers, counts, due bits, overflow and
    undelivered slots all come from one read of its consume blob."""
    _, port, _ = engines("cells")
    script = Script(seed=14)
    reads = []
    real = torch.Tensor.numpy
    monkeypatch.setattr(torch.Tensor, "numpy", lambda t, *a, **k: reads.append(1) or real(t, *a, **k))
    for tick in range(3):
        script.step([port], tick)
        out = port.tick(100 + 33 * tick)
        before = len(reads)
        port.handover_list(out)
        port.consume(out)
        port.undelivered_slots(out)
        assert len(reads) - before == 1


def test_spmd_mesh_and_collectives():
    """spmd.Mesh accepts repeated devices; shard indices are row-major;
    the collectives move parts in shard order."""
    mesh = spmd.Mesh(CPU8, (2, 4), ("hosts", "entities"))
    assert mesh.size == 8 and mesh.replica == torch.device("cpu")
    assert [mesh.shard_index(mesh.coords(s)) for s in range(8)] == list(range(8))
    assert mesh.coords(6) == (1, 2)
    parts = [torch.full((3,), s, dtype=torch.int32) for s in range(8)]
    assert spmd.psum(parts, mesh.replica).tolist() == [28] * 3
    assert spmd.all_gather(parts, mesh.replica)[:, 0].tolist() == list(range(8))
    buckets = [torch.arange(8, dtype=torch.int32) + 10 * s for s in range(8)]
    got = spmd.all_to_all(mesh, buckets)
    assert got[3].tolist() == [10 * s + 3 for s in range(8)]
    assert [p[0].item() for p in spmd.ppermute(mesh, parts, 1)] == [7, 0, 1, 2, 3, 4, 5, 6]
    assert [p[0].item() for p in spmd.ppermute(mesh, parts, -1)] == [1, 2, 3, 4, 5, 6, 7, 0]
    assert spmd.run_shards(mesh, lambda s: s * s) == [s * s for s in range(8)]
    x = torch.arange(16)
    assert torch.equal(spmd.unshard(spmd.shard(mesh, x)), x)
    with pytest.raises(ValueError):
        spmd.Mesh(CPU8, (3, 3), ("a", "b"))
    with pytest.raises(ValueError):
        spmd.shard(mesh, torch.arange(10))
    assert port_mesh.entity_sharding(mesh, 16)[5] == range(10, 12)
    assert len(jax.devices()) == 8  # the JAX side of every case above
