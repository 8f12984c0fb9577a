"""Carry a running engine's state into a port engine.

What weights are to a model, this state is to the spatial decision
plane: the entity, query, spots and subscription tables, plus the two
columns that only the device advances. ``load_reference_state`` takes
that state as a plain dict of numpy arrays and Python containers (so it
can come from the JAX engine, or from anything else that keeps the same
tables) and installs it in a port ``SpatialEngine``; after loading, both
engines compute the same next tick.

Keys of ``state`` (capacities must match the port engine's):

- ``positions`` f32[N,3], ``valid`` bool[N], ``entity_of_slot`` u32[N],
  ``slot_of_entity`` {entity id: slot}, ``free`` [slot] (the free list,
  popped from the end);
- ``q_kind`` i32[Q], ``q_center``/``q_extent``/``q_dir`` f32[Q,2],
  ``q_angle`` f32[Q], ``q_free`` [row], ``q_of_conn`` {conn id: row},
  ``q_spot_dist`` i32[Q,C] or None, ``spot_sources``
  {conn id: (spots, dists)};
- ``sub_interval`` i32[S], ``sub_active`` bool[S], ``sub_free`` [slot];
- the device-advanced columns: ``prev_cell`` i32[N] (each slot's cell
  as of the last tick) and ``sub_last_fanout_ms`` i32[S] (each
  subscription's window start as the last tick advanced it).

Optional keys, for the simulation plane and the standing-query diff
(missing ones leave the engine's own, i.e. the plane off):

- ``sim_params`` (any 10-tuple in ``SimParams`` order, or None: no
  agents), ``sim_seed``, ``sim_tick``; the kinematic columns as the
  device holds them (the device is authoritative for agent rows between
  censuses, so they are also the host shadow after loading):
  ``positions`` above, ``vel`` f32[N,3], ``sim_state`` i32[N],
  ``sim_target`` f32[N,3], ``agent_mask`` bool[N]; ``flee_cells``
  bool[C] or None;
- ``q_prev_interest`` bool[Q,C] and ``q_prev_dist`` i32[Q,C] (the
  committed diff baseline, or None for the empty one),
  ``q_prev_reset_rows`` [row] and ``query_epoch``.

The per-tick flags (``run_sim_pass``, ``sim_census_due``,
``track_query_changes``) are the caller's to set.

The state is taken between ticks with nothing staged: every mutation
made since the last tick must have been flushed by a tick first.

A meshed engine (the JAX engine's sharded arrays arrive as numpy in
global slot order) loads into a port engine built over a mesh of the
same size: its entity columns are split into the port's per-shard
tensors.
"""

from __future__ import annotations

import numpy as np

from .engine import SpatialEngine
from .spatial_ops import SimParams, num_cells


def _array(state: dict, key: str, dtype, shape: tuple) -> np.ndarray:
    arr = np.asarray(state[key])
    if arr.shape != shape:
        raise ValueError(f"state[{key!r}] has shape {arr.shape}, expected {shape}")
    return arr.astype(dtype, copy=True)


def load_reference_state(engine: SpatialEngine, state: dict) -> None:
    """Install ``state`` (see the module docstring) in ``engine``: host
    mirrors and free lists replaced, every device table uploaded whole,
    nothing left staged."""
    n, q, s = engine.entity_capacity, engine.query_capacity, engine.sub_capacity
    c = num_cells(engine.grid)
    engine._positions = _array(state, "positions", np.float32, (n, 3))
    engine._valid = _array(state, "valid", bool, (n,))
    engine._entity_of_slot = _array(state, "entity_of_slot", np.uint32, (n,))
    engine._slot_of_entity = {int(k): int(v) for k, v in state["slot_of_entity"].items()}
    engine._free = [int(x) for x in state["free"]]
    engine._q_kind = _array(state, "q_kind", np.int32, (q,))
    engine._q_center = _array(state, "q_center", np.float32, (q, 2))
    engine._q_extent = _array(state, "q_extent", np.float32, (q, 2))
    engine._q_dir = _array(state, "q_dir", np.float32, (q, 2))
    engine._q_angle = _array(state, "q_angle", np.float32, (q,))
    engine._q_free = [int(x) for x in state["q_free"]]
    engine._q_of_conn = {int(k): int(v) for k, v in state["q_of_conn"].items()}
    engine._q_spot_dist = (
        None if state.get("q_spot_dist") is None
        else _array(state, "q_spot_dist", np.int32, (q, c))
    )
    engine._spot_sources = dict(state.get("spot_sources") or {})
    engine._sub_last = _array(state, "sub_last_fanout_ms", np.int32, (s,))
    engine._sub_interval = _array(state, "sub_interval", np.int32, (s,))
    engine._sub_active = _array(state, "sub_active", bool, (s,))
    engine._sub_free = [int(x) for x in state["sub_free"]]
    prev_cell = _array(state, "prev_cell", np.int32, (n,))
    if state.get("sim_params") is not None:
        engine.sim_enabled = True
        engine.sim_params = SimParams(*state["sim_params"])
        engine.sim_seed = int(state["sim_seed"]) & 0xFFFFFFFF
        engine.sim_tick = int(state["sim_tick"])
        engine._vel = _array(state, "vel", np.float32, (n, 3))
        engine._sim_state = _array(state, "sim_state", np.int32, (n,))
        engine._sim_target = _array(state, "sim_target", np.float32, (n, 3))
        engine._agent_mask = _array(state, "agent_mask", bool, (n,))
        engine._flee_cells = (
            None if state.get("flee_cells") is None
            else _array(state, "flee_cells", bool, (c,))
        )
    if "q_prev_interest" in state:
        engine._d_q_prev = None if state["q_prev_interest"] is None else (
            engine._upload(_array(state, "q_prev_interest", bool, (q, c))),
            engine._upload(_array(state, "q_prev_dist", np.int32, (q, c))),
        )
        engine._q_prev_reset_rows = {int(r) for r in state.get("q_prev_reset_rows", ())}
        engine.query_epoch = int(state.get("query_epoch", 0))

    engine._dirty_slots.clear()
    engine._seed_cells.clear()
    engine._spot_dirty_rows.clear()
    engine._sub_dirty_slots.clear()
    engine._sub_last_dirty.clear()
    engine._sim_dirty.clear()
    # The sim columns and the flee mask re-upload whole on the flush.
    engine._d_vel = engine._d_sim_state = engine._d_sim_target = None
    engine._d_agent = engine._d_flee = None
    engine._d_positions = engine._entity_upload(engine._positions)
    engine._d_valid = engine._entity_upload(engine._valid)
    engine._d_cell = engine._entity_upload(prev_cell)
    engine._d_spot_dist = None
    engine._d_queries = None
    engine._queries_dirty = True
    # The sub table re-uploads whole (last-fan-out from the device
    # column) on the next flush.
    engine._d_sub_state = None
    engine.last_result = None
    engine._flush_host_state()
