"""SpatialEngine: device-resident spatial decision state and its tick.

The port of ``channeld_tpu/ops/engine.py``. Host-side façade over the
step in ``spatial_ops``: fixed-capacity slot arrays with a free-list for
dynamic entity membership, a query table for client AOI interests, and
the fan-out subscription clock. One ``tick()`` performs the whole
per-frame decision pass on the engine's device (through the CUDA
kernels when it is a CUDA device) and returns the step's tensors.

With a ``mesh`` (``parallel.spmd.Mesh``) the entity columns are held per
shard, one tensor per mesh position on its device, and the tick runs the
sharded step of ``parallel/mesh.py`` (``sharding="entities"``) or the
cell-sharded serving step of ``parallel/spatial_alltoall.py``
(``sharding="cells"``); queries, subscriptions and every replicated
result live on the first shard's device (``self.device``). The serving
results are the single-device engine's whenever no redistribution
bucket overflows. A mesh tick reads the host once too: its ``consume``
blob also carries the per-shard handover counts and, on the cells
plane, the overflow and the ``undelivered`` mask.

Dirty rows are staged host-side between ticks and shipped as one row
scatter per table per tick (``index_copy_`` in place, where the JAX
engine rebuilds each array with ``.at[].set``), so the H2D traffic is
O(changed rows), not O(capacity). The host reads a tick's results
through ``consume`` (the one blob transfer of the tick) and
``interest_rows`` (only the interest rows a caller asks for).

Beyond the decision pass, the engine carries the JAX engine's other
device planes: the standing-query diff (``track_query_changes``: one
changed-rows blob per tick, ``query_changed_rows``), the simulation
plane (``seed_agents`` … ``sim_warmup``: agents in ordinary entity
slots, stepped on the device before the spatial pass), and the recovery
surface (``rebuild_device_state``, ``apply_grid``,
``verify_device_state``, ``corrupt_device_state_for_chaos``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Collection, Optional

import numpy as np
import torch

from ..utils.devices import resolve_device
from ..utils.logger import get_logger
from .spatial_ops import (
    AOI_NONE,
    AOI_SPOTS,
    SIM_IDLE,
    SIM_SEEK,
    QuerySet,
    SimParams,
    diff_query_masks,
    num_cells,
    parse_consume_blob,
    parse_query_blob,
    sim_step,
    spatial_step,
)

logger = get_logger("ops.engine")


class SpatialEngine:
    def __init__(
        self,
        grid,
        entity_capacity: int = 1 << 17,
        query_capacity: int = 1 << 12,
        sub_capacity: int = 1 << 16,
        max_handovers: int = 4096,
        mesh=None,
        sharding: str = "entities",
        cell_bucket: int = 0,
        query_rows_max: int = 8192,
        device=None,
    ):
        """``device``: where the tables live and the step runs; ``cuda``
        by default (raises without a CUDA device), ``"cpu"`` only when
        asked for. ``grid`` is any object with the six GridSpec fields.
        ``query_rows_max`` is the standing-query plane's changed-rows
        budget per tick.

        ``mesh``: a ``parallel.spmd.Mesh`` to shard the entity slot
        arrays over (``parallel.mesh.make_mesh``/``make_mesh_2d``/
        ``mesh_from_config``); None = the single-device step. With a mesh
        the tables live on its devices, the replicated ones on the first
        (``device``, if given, must be of the same kind), and capacity is
        rounded up to a multiple of the shard count. ``sharding`` picks
        the meshed step: "entities" (psum occupancy, replicated AOI) or
        "cells" (space-partitioned: all_to_all redistribution to
        per-shard cell blocks + column-block AOI). "cells" with
        ``cell_bucket`` > 0 caps the per-(source, dest) redistribution
        bucket; overflowed entities are reported undelivered and
        re-offered next tick (0 = exact delivery). Both only matter with
        a mesh."""
        if sharding not in ("entities", "cells"):
            raise ValueError(f"unknown sharding {sharding!r}")
        self._mesh = mesh
        self._sharding = sharding
        self._cell_bucket = cell_bucket
        # Engine state written from the tick loop (mutators, the unguarded
        # step) and the device guard's worker (the guarded step, the
        # rebuild): the loop blocks on the worker, so the only overlap is
        # a watchdog-abandoned worker unwedging late, which the generation
        # fence makes safe (tpulint's fence-discipline rule checks every
        # store). Each such attribute is declared shared=fence.
        self._mesh_step = None  # tpulint: shared=fence
        if mesh is not None:
            if device is not None and resolve_device(device).type != mesh.replica.type:
                raise ValueError(f"device {device} is not of the mesh's kind ({mesh.replica})")
            n_dev = mesh.size
            # Entity arrays shard evenly over every mesh axis.
            entity_capacity = ((entity_capacity + n_dev - 1) // n_dev) * n_dev
            self.device = mesh.replica
        else:
            self.device = resolve_device(device)
        self.grid = grid
        self.entity_capacity = entity_capacity
        self.query_capacity = query_capacity
        self.sub_capacity = sub_capacity
        self.max_handovers = max_handovers

        # Host mirrors (numpy) + dirty staging.
        self._positions = np.zeros((entity_capacity, 3), np.float32)
        self._valid = np.zeros(entity_capacity, bool)
        self._free = list(range(entity_capacity - 1, -1, -1))
        self._slot_of_entity: dict[int, int] = {}
        self._entity_of_slot = np.zeros(entity_capacity, np.uint32)
        self._dirty_slots: set[int] = set()  # tpulint: shared=fence
        self._seed_cells: dict[int, int] = {}  # slot -> forced prev cell  # tpulint: shared=fence

        self._q_kind = np.zeros(query_capacity, np.int32)
        self._q_center = np.zeros((query_capacity, 2), np.float32)
        self._q_extent = np.zeros((query_capacity, 2), np.float32)
        self._q_dir = np.zeros((query_capacity, 2), np.float32)
        self._q_angle = np.zeros(query_capacity, np.float32)
        self._q_free = list(range(query_capacity - 1, -1, -1))
        self._q_of_conn: dict[int, int] = {}
        # [Q,C] spots dist table (-1 = no interest), allocated on the
        # first spots query; the device copy updates by row scatter.
        self._q_spot_dist: Optional[np.ndarray] = None
        # World-space spot sources per connection (the rows above are in
        # cell space; a grid swap re-rasterizes from these).
        self._spot_sources: dict[int, tuple] = {}
        self._d_spot_dist: Optional[torch.Tensor] = None  # tpulint: shared=fence
        self._spot_dirty_rows: set[int] = set()  # tpulint: shared=fence
        self._queries_dirty = True  # tpulint: shared=fence

        # Standing-query plane (doc/query_engine.md): when enabled the
        # tick diffs this tick's interest/dist masks against the
        # committed device baseline and compacts the delta to changed
        # (query, cell, dist) rows — the plane's one D2H transfer.
        self.track_query_changes = False
        self.query_rows_max = query_rows_max
        # Committed (interest, dist) baseline pair; None = empty baseline
        # (the next diff full-emits every interested row).
        self._d_q_prev: Optional[tuple] = None  # tpulint: shared=fence
        # Rows whose baseline is zeroed before the next diff: a freshly
        # allocated (or freed) row may be reused by a new query, and a
        # stale baseline would swallow the overlap of old and new masks.
        self._q_prev_reset_rows: set[int] = set()  # tpulint: shared=fence
        # Bumped whenever the committed baseline is thrown away wholesale
        # (rebuild_device_state / apply_grid): the host plane must then
        # full-resync its mirrors.
        self.query_epoch = 0

        # Host staging for the sub table. The device's last-fan-out column
        # is authoritative after each tick (fanout_due advances it); the
        # host mirror only carries *explicit* writes (add/reset/interval),
        # applied as row scatters.
        self._sub_last = np.zeros(sub_capacity, np.int32)
        self._sub_interval = np.zeros(sub_capacity, np.int32)
        self._sub_active = np.zeros(sub_capacity, bool)
        self._sub_free = list(range(sub_capacity - 1, -1, -1))
        # Per-column dirty tracking: an interval/active write must never
        # drag the stale host `last` along.
        self._sub_dirty_slots: set[int] = set()  # interval+active cols  # tpulint: shared=fence
        self._sub_last_dirty: set[int] = set()  # last-fan-out column  # tpulint: shared=fence

        # Entity columns: one tensor, or one per shard with a mesh.
        self._d_positions = self._entity_upload(self._positions)  # tpulint: shared=fence
        self._d_valid = self._entity_upload(self._valid)
        self._d_cell = self._entity_upload(np.full(entity_capacity, -1, np.int32))  # tpulint: shared=fence
        self._d_queries: Optional[QuerySet] = None  # tpulint: shared=fence
        self._d_sub_state: Optional[tuple] = None  # tpulint: shared=fence

        # Simulation plane (doc/simulation.md): agents occupy ordinary
        # entity slots, and the sim pass advances their positions in the
        # same device arrays every later plane reads. The kinematic
        # columns (velocity, FSM state, waypoint) follow the positions
        # staging discipline: host shadows + dirty-slot scatters, whole
        # re-upload when the device copy is dropped. The device is
        # authoritative for agent rows between censuses; the host shadow
        # refreshes only at census boundaries (absorb_census), which is
        # why a rebuild reproduces the last census exactly.
        self.sim_enabled = False
        self.sim_seed = 0
        self.sim_params: Optional[SimParams] = None
        self.sim_tick = 0  # counter-based RNG cursor  # tpulint: shared=fence
        # Per-tick scheduling flags, staged by the caller before a tick.
        self.run_sim_pass = False
        self.sim_census_due = False
        self._agent_mask = np.zeros(entity_capacity, bool)
        self._vel = np.zeros((entity_capacity, 3), np.float32)
        self._sim_state = np.zeros(entity_capacity, np.int32)
        self._sim_target = np.zeros((entity_capacity, 3), np.float32)
        self._sim_dirty: set[int] = set()  # tpulint: shared=fence
        # Danger mask (bool[num_cells]) driving FLEE; uploaded only when
        # set_flee_cells changes it, never per tick.
        self._flee_cells: Optional[np.ndarray] = None
        self._flee_dirty = False  # tpulint: shared=fence
        self._d_agent: Optional[torch.Tensor] = None
        self._d_vel: Optional[torch.Tensor] = None
        self._d_sim_state: Optional[torch.Tensor] = None
        self._d_sim_target: Optional[torch.Tensor] = None
        self._d_flee: Optional[torch.Tensor] = None  # tpulint: shared=fence
        # Ledger of sim rebuild verifications by result.
        self.sim_rebuild_counts: dict[str, int] = {}

        self._start = time.monotonic()
        self.last_result: Optional[dict] = None  # tpulint: shared=fence
        # Entities the last consumed cells-plane tick could not deliver
        # (its redistribution buckets were full); set when ``consume``
        # reads the tick, always 0 otherwise.
        self.last_overflow = 0  # tpulint: shared=fence
        # Abandoned-step fence: a step abandoned by a watchdog must not
        # commit its tail state over a rebuilt engine (tick() re-checks
        # before committing).
        self.generation = 0  # tpulint: shared=fence
        # Serializes rebuild bodies (core/device_guard.py): an abandoned
        # rebuild that unwedges late never overlaps a newer one.
        self._rebuild_lock = threading.Lock()

    # ---- entity slots ----------------------------------------------------

    def now_ms(self) -> int:
        return int((time.monotonic() - self._start) * 1000)

    def add_entity(self, entity_id: int, x: float, y: float, z: float) -> int:
        slot = self._slot_of_entity.get(entity_id)
        if slot is None:
            if not self._free:
                raise RuntimeError("entity capacity exhausted")
            slot = self._free.pop()
            self._slot_of_entity[entity_id] = slot
            self._entity_of_slot[slot] = entity_id
            # Fresh slot: clear any previous occupant's cell so reuse can't
            # fabricate a crossing on the first tick.
            self._seed_cells[slot] = -1
        self._positions[slot] = (x, y, z)
        self._valid[slot] = True
        self._dirty_slots.add(slot)
        return slot

    def seed_cell(self, slot: int, cell: int) -> None:
        """Set the device-side previous cell for a slot before its first
        tick (used to seed a just-sighted entity's old position)."""
        self._seed_cells[slot] = cell

    def update_entity(self, entity_id: int, x: float, y: float, z: float) -> None:
        slot = self._slot_of_entity.get(entity_id)
        if slot is None:
            self.add_entity(entity_id, x, y, z)
            return
        self._positions[slot] = (x, y, z)
        self._dirty_slots.add(slot)

    def remove_entity(self, entity_id: int) -> None:
        slot = self._slot_of_entity.pop(entity_id, None)
        if slot is None:
            return
        self._valid[slot] = False
        self._dirty_slots.add(slot)
        if self._agent_mask[slot]:
            # A departed agent's slot stops stepping at once: a reused
            # slot must not inherit the sim pass.
            self._agent_mask[slot] = False
            self._sim_dirty.add(slot)
        self._free.append(slot)

    def entity_count(self) -> int:
        return len(self._slot_of_entity)

    def slot_of_entity(self, entity_id: int) -> Optional[int]:
        return self._slot_of_entity.get(entity_id)

    def entity_id_of_slot(self, slot: int) -> int:
        return int(self._entity_of_slot[slot])

    # ---- queries ---------------------------------------------------------

    def _query_slot(self, conn_id: int) -> int:
        q = self._q_of_conn.get(conn_id)
        if q is None:
            if not self._q_free:
                raise RuntimeError("query capacity exhausted")
            q = self._q_free.pop()
            self._q_of_conn[conn_id] = q
            # Fresh owner for this row: zero its diff baseline before the
            # next tick (see _q_prev_reset_rows).
            self._q_prev_reset_rows.add(q)
        return q

    def set_query(
        self,
        conn_id: int,
        kind: int,
        center_xz: tuple[float, float],
        extent_xz: tuple[float, float] = (0.0, 0.0),
        direction_xz: tuple[float, float] = (1.0, 0.0),
        angle: float = 0.0,
    ) -> None:
        q = self._query_slot(conn_id)
        self._spot_sources.pop(conn_id, None)  # no longer a spots query
        self._q_kind[q] = kind
        self._q_center[q] = center_xz
        self._q_extent[q] = extent_xz
        norm = float(np.hypot(*direction_xz)) or 1.0
        self._q_dir[q] = (direction_xz[0] / norm, direction_xz[1] / norm)
        self._q_angle[q] = angle
        self._queries_dirty = True

    def set_spots_query(
        self,
        conn_id: int,
        spots_xz: list[tuple[float, float]],
        dists: Optional[list[int]] = None,
    ) -> None:
        """Spots AOI on the device plane: rasterize the spot list to a
        per-cell interest row (ref: spatial.go spots loop — each spot's
        cell, dist = dists[i] when given else 0; out-of-world spots
        skipped). Where several spots land in one cell the last spot's
        dist wins. The row is a dist table with -1 = no interest."""
        q = self._query_slot(conn_id)
        self._spot_sources[conn_id] = (
            [tuple(s) for s in spots_xz],
            list(dists) if dists is not None else None,
        )
        g = self.grid
        n_cells = num_cells(g)
        if self._q_spot_dist is None:
            self._q_spot_dist = np.full((self.query_capacity, n_cells), -1, np.int32)
        self._q_kind[q] = AOI_SPOTS
        dist_row = np.full(n_cells, -1, np.int32)
        for i, (x, z) in enumerate(spots_xz):
            # Divide-then-floor, exactly like assign_cells — float
            # floor-division disagrees on boundaries.
            col = math.floor((x - g.offset_x) / g.cell_w)
            row = math.floor((z - g.offset_z) / g.cell_h)
            if not (0 <= col < g.cols and 0 <= row < g.rows):
                continue
            cell = row * g.cols + col
            # Clamp to int32 max: wire dists are uint32, and 0xFFFFFFFF
            # must not alias the -1 sentinel.
            dist_row[cell] = (
                min(int(dists[i]), 2**31 - 1)
                if dists is not None and i < len(dists) else 0
            )
        self._q_spot_dist[q] = dist_row
        self._spot_dirty_rows.add(q)
        self._queries_dirty = True

    def remove_query(self, conn_id: int) -> None:
        q = self._q_of_conn.pop(conn_id, None)
        self._spot_sources.pop(conn_id, None)
        if q is not None:
            self._q_kind[q] = AOI_NONE
            if self._q_spot_dist is not None:
                self._q_spot_dist[q] = -1
                self._spot_dirty_rows.add(q)
            self._q_free.append(q)
            # A freed row emits no removal rows and hands its next owner
            # a clean diff baseline.
            self._q_prev_reset_rows.add(q)
            self._queries_dirty = True

    def query_row_of_conn(self, conn_id: int) -> Optional[int]:
        return self._q_of_conn.get(conn_id)

    # ---- subscriptions ---------------------------------------------------

    def add_subscription(self, interval_ms: int, first_due_ms: int = 0) -> int:
        if not self._sub_free:
            raise RuntimeError("subscription capacity exhausted")
        s = self._sub_free.pop()
        self._sub_last[s] = first_due_ms
        self._sub_interval[s] = interval_ms
        self._sub_active[s] = True
        self._sub_dirty_slots.add(s)
        self._sub_last_dirty.add(s)
        return s

    def remove_subscription(self, s: int) -> None:
        self._sub_active[s] = False
        self._sub_free.append(s)
        self._sub_dirty_slots.add(s)

    def set_sub_interval(self, s: int, interval_ms: int) -> None:
        """Re-subscription merged new options (ref: subscription.go:34-60)."""
        self._sub_interval[s] = interval_ms
        self._sub_dirty_slots.add(s)

    def reset_sub_clock(self, s: int, now_ms: int) -> None:
        """Snap the sub's window start to ``now`` — mirrors the host path's
        first-fan-out behavior (tick_data sets latest_fanout_time = now)."""
        self._sub_last[s] = now_ms
        self._sub_last_dirty.add(s)

    # ---- simulation plane (doc/simulation.md) ----------------------------

    def seed_agents(self, entries, seed: int, params: SimParams,
                    vels=None, states=None, targets=None) -> list[int]:
        """Register a simulated population into ordinary entity slots.

        ``entries`` is [(entity_id, x, y, z)]. ``vels``/``states``/
        ``targets`` restore a census (WAL replay, federation adoption);
        a fresh spawn starts IDLE at rest, targeting its own position.
        Mesh-sharded engines don't run the sim pass (the step is
        single-device, as in the JAX package). Returns the slots used."""
        if self._mesh is not None:
            raise RuntimeError("sim plane requires a single-device engine")
        slots = []
        for i, (eid, x, y, z) in enumerate(entries):
            slot = self.add_entity(eid, float(x), float(y), float(z))
            self._agent_mask[slot] = True
            self._vel[slot] = vels[i] if vels is not None else (0.0, 0.0, 0.0)
            self._sim_state[slot] = int(states[i]) if states is not None else SIM_IDLE
            self._sim_target[slot] = targets[i] if targets is not None else (x, y, z)
            self._sim_dirty.add(slot)
            slots.append(slot)
        self.sim_seed = int(seed) & 0xFFFFFFFF
        self.sim_params = SimParams(*params)
        self.sim_enabled = True
        return slots

    def agent_slots(self) -> np.ndarray:
        """Live agent slot indices, ascending (host-shadow truth)."""
        return np.nonzero(self._agent_mask & self._valid)[0]

    def agent_count(self) -> int:
        return int(np.count_nonzero(self._agent_mask & self._valid))

    def agent_ids(self, slots: Optional[np.ndarray] = None) -> np.ndarray:
        """Entity ids for ``slots`` (default: all live agent slots)."""
        if slots is None:
            slots = self.agent_slots()
        return self._entity_of_slot[slots]

    def is_agent(self, entity_id: int) -> bool:
        slot = self._slot_of_entity.get(entity_id)
        return slot is not None and bool(self._agent_mask[slot])

    def absorb_census(self, slots: np.ndarray, positions, vel, state, target) -> None:
        """Fold a fetched census (full-capacity columns, already numpy)
        back into the host shadows without marking anything dirty: the
        values came from the device, so re-uploading them would be waste
        and re-staging them could clobber a newer device tick. After
        this call the host shadow is bit-identical to the device for
        every agent row, which is what makes the next rebuild/verify
        exact."""
        self._positions[slots] = positions[slots]
        self._vel[slots] = vel[slots]
        self._sim_state[slots] = state[slots]
        self._sim_target[slots] = target[slots]

    def set_flee_cells(self, cells) -> None:
        """Install the danger mask driving FLEE: an iterable of cell
        indices (sensor hits). Uploaded on the next flush — only when
        this is called, never per tick."""
        n_cells = num_cells(self.grid)
        mask = np.zeros(n_cells, bool)
        for c in cells:
            if 0 <= c < n_cells:
                mask[c] = True
        self._flee_cells = mask
        self._flee_dirty = True

    def sim_stampede(self, cell: int) -> None:
        """CHAOS ONLY (``sim.stampede``): herd every agent toward one
        cell — a deterministic handover/density burst. Host-staged like
        any other mutation, so it rides the ordinary fenced scatter into
        the next tick."""
        g = self.grid
        cx = g.offset_x + (cell % g.cols + 0.5) * g.cell_w
        cz = g.offset_z + (cell // g.cols + 0.5) * g.cell_h
        slots = self.agent_slots()
        self._sim_state[slots] = SIM_SEEK
        self._sim_target[slots, 0] = cx
        self._sim_target[slots, 2] = cz
        self._vel[slots] = 0.0
        self._sim_dirty.update(int(s) for s in slots)

    def corrupt_sim_state_for_chaos(self) -> None:
        """CHAOS ONLY (``sim.step_nan``): rot the agent rows the way a
        bad kernel output would — NaN positions/velocities on a quarter
        of the agents, plus garbage prev-cell baselines on the same rows
        (the impossible-src-cell signature a readback sentinel detects).
        New tensors, like the reference's functional updates: nothing a
        caller holds from an earlier tick changes."""
        live = self.agent_slots()
        n = max(1, len(live) // 4)
        rows = live[:n].astype(np.int64)
        self._d_cell = self._entity_fill(self._d_cell, rows, 1 << 24)
        self._d_positions = self._entity_fill(self._d_positions, rows, float("nan"))
        if self._d_vel is not None:
            self._d_vel = self._d_vel.index_fill(
                0, torch.from_numpy(rows).to(self.device), float("nan"))

    def _count_sim_rebuild(self, result: str) -> None:
        """Double-entry sim rebuild accounting: the Python ledger and the
        Prometheus counter move together on every verification of the
        agent arrays."""
        self.sim_rebuild_counts[result] = self.sim_rebuild_counts.get(result, 0) + 1
        from ..core import metrics

        metrics.sim_device_rebuilds.labels(result=result).inc()

    # ---- the tick --------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array. torch.tensor copies, so later
        host writes never reach it (on the CPU, from_numpy would share
        the buffer)."""
        return torch.tensor(arr, device=self.device)

    def _stage_rows(self, rows: Collection[int]) -> tuple[np.ndarray, torch.Tensor]:
        """The dirty ``rows`` as a host index and its device copy, for
        ``index_copy_`` row scatters."""
        idx = np.fromiter(rows, np.int64, len(rows))
        return idx, torch.from_numpy(idx).to(self.device)

    # Entity columns are one tensor, or with a mesh one tensor per shard
    # (shard s holds slots [s * size, (s + 1) * size) on its device):
    # these helpers route host rows to where they live.

    def _entity_upload(self, arr: np.ndarray):
        """A device copy of a whole host entity column."""
        if self._mesh is None:
            return self._upload(arr)
        size = arr.shape[0] // self._mesh.size
        return [torch.tensor(arr[s * size:(s + 1) * size], device=d)
                for s, d in enumerate(self._mesh.devices)]

    def _stage_entity_rows(self, idx: np.ndarray, values) -> list:
        """Rows for the entity slots ``idx`` (``values``: one host array
        per column, aligned with ``idx``), uploaded where they will be
        stored: [(shard or None, device index, [rows])]."""
        if self._mesh is None:
            d_idx = torch.from_numpy(idx).to(self.device)
            return [(None, d_idx, [self._upload(v) for v in values])]
        # One upload per column, rows ordered by shard, then split on the
        # device (a view, or a device-to-device copy to another card).
        size = self.entity_capacity // self._mesh.size
        order = np.argsort(idx // size, kind="stable")
        shard_of = idx[order] // size
        counts = np.bincount(shard_of, minlength=self._mesh.size).tolist()
        local = torch.from_numpy(idx[order] - shard_of * size).to(self.device)
        columns = [self._upload(v[order]) for v in values]
        staged = []
        for s, parts in enumerate(zip(local.split(counts), *(c.split(counts) for c in columns))):
            if counts[s]:
                dev = self._mesh.devices[s]
                staged.append((s, parts[0].to(dev), [p.to(dev) for p in parts[1:]]))
        return staged

    @staticmethod
    def _store_entity_rows(targets, staged) -> None:
        """Scatter staged rows into the entity columns ``targets``, in place."""
        for shard, d_idx, rows in staged:
            for dst, src in zip(targets, rows):
                (dst if shard is None else dst[shard]).index_copy_(0, d_idx, src)

    def _entity_fill(self, column, slots: np.ndarray, value):
        """A new entity column with the rows ``slots`` set to ``value``."""
        if self._mesh is None:
            return column.index_fill(0, torch.from_numpy(slots).to(self.device), value)
        size = self.entity_capacity // self._mesh.size
        out = []
        for s, part in enumerate(column):
            rows = slots[(slots // size) == s] - s * size
            out.append(part.index_fill(0, torch.from_numpy(rows).to(part.device), value))
        return out

    def _entity_host(self, column) -> np.ndarray:
        """A whole entity column on the host (recovery path only)."""
        if self._mesh is None:
            return column.cpu().numpy()
        return np.concatenate([part.cpu().numpy() for part in column])

    def _flush_host_state(self, expect_generation: Optional[int] = None) -> None:
        def _fence() -> None:
            # Stale-tick fence: a watchdog-abandoned worker that unwedges
            # mid-flush must not commit staged rows over a rebuilt engine.
            # Each block stages its rows on the device first and re-checks
            # the generation immediately before the in-place store.
            if (expect_generation is not None
                    and expect_generation != self.generation):
                raise RuntimeError("stale device tick abandoned by watchdog")

        _fence()
        if self._dirty_slots:
            idx = np.fromiter(self._dirty_slots, np.int64, len(self._dirty_slots))
            staged = self._stage_entity_rows(idx, (self._positions[idx], self._valid[idx]))
            _fence()
            self._store_entity_rows((self._d_positions, self._d_valid), staged)
            self._dirty_slots.clear()
        if self._seed_cells:
            idx = np.fromiter(self._seed_cells.keys(), np.int64, len(self._seed_cells))
            cells = np.fromiter(self._seed_cells.values(), np.int32, len(self._seed_cells))
            staged = self._stage_entity_rows(idx, (cells,))
            _fence()
            self._store_entity_rows((self._d_cell,), staged)
            self._seed_cells.clear()
        if self.sim_enabled:
            sim_host = (self._vel, self._sim_state, self._sim_target, self._agent_mask)
            if self._d_vel is None:
                # First upload (or post-rebuild re-upload) of the whole
                # kinematic column set.
                d_sim = [self._upload(a) for a in sim_host]
                _fence()
                self._d_vel, self._d_sim_state, self._d_sim_target, self._d_agent = d_sim
                self._sim_dirty.clear()
            elif self._sim_dirty:
                idx, d_idx = self._stage_rows(self._sim_dirty)
                rows = [self._upload(a[idx]) for a in sim_host]
                _fence()
                for dst, src in zip((self._d_vel, self._d_sim_state,
                                     self._d_sim_target, self._d_agent), rows):
                    dst.index_copy_(0, d_idx, src)
                self._sim_dirty.clear()
            if self._flee_cells is not None and (self._d_flee is None or self._flee_dirty):
                d_flee = self._upload(self._flee_cells)
                _fence()
                self._d_flee = d_flee
                self._flee_dirty = False
        spots_changed = False
        if self._q_spot_dist is not None:
            if self._d_spot_dist is None:
                d_spot = self._upload(self._q_spot_dist)
                _fence()
                self._d_spot_dist = d_spot
                self._spot_dirty_rows.clear()
                spots_changed = True
            elif self._spot_dirty_rows:
                idx, d_idx = self._stage_rows(self._spot_dirty_rows)
                rows = self._upload(self._q_spot_dist[idx])
                _fence()
                self._d_spot_dist.index_copy_(0, d_idx, rows)
                self._spot_dirty_rows.clear()
                spots_changed = True
        if self._d_queries is None or self._queries_dirty or spots_changed:
            d_queries = QuerySet(
                self._upload(self._q_kind),
                self._upload(self._q_center),
                self._upload(self._q_extent),
                self._upload(self._q_dir),
                self._upload(self._q_angle),
                self._d_spot_dist,
            )
            _fence()
            self._d_queries = d_queries
            self._queries_dirty = False
        if self._d_sub_state is None:
            d_sub = (
                self._upload(self._sub_last),
                self._upload(self._sub_interval),
                self._upload(self._sub_active),
            )
            _fence()
            self._d_sub_state = d_sub
            self._sub_dirty_slots.clear()
            self._sub_last_dirty.clear()
        elif self._sub_dirty_slots or self._sub_last_dirty:
            # Per-column row scatters of explicit host writes only — the
            # device's last-fan-out values for untouched slots stay
            # authoritative (fanout_due advances them device-side).
            last, interval, active = self._d_sub_state
            staged = []
            if self._sub_last_dirty:
                idx, d_idx = self._stage_rows(self._sub_last_dirty)
                staged.append((last, d_idx, self._upload(self._sub_last[idx])))
            if self._sub_dirty_slots:
                idx, d_idx = self._stage_rows(self._sub_dirty_slots)
                staged.append((interval, d_idx, self._upload(self._sub_interval[idx])))
                staged.append((active, d_idx, self._upload(self._sub_active[idx])))
            _fence()
            for dst, idx, rows in staged:
                dst.index_copy_(0, idx, rows)
            self._sub_last_dirty.clear()
            self._sub_dirty_slots.clear()

    def warmup(self) -> None:
        """Run one tick on the empty tables before serving: on CUDA this
        builds and loads the kernels, so the first live tick does not pay
        for nvcc. The warmup tick mutates nothing the serving path reads:
        tables are empty and inactive."""
        self.tick(now_ms=0)
        self.last_result = None

    def sim_warmup(self) -> None:
        """Run the sim step once at plane activation on throwaway arrays
        of the live shapes, so the first live sim tick does not pay the
        device's first-use costs. The live arrays are never touched."""
        if self.sim_params is None:
            return
        n, dev = self.entity_capacity, self.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        sim_step(self.grid, zeros(n, 3), zeros(n, 3), zeros(n, dtype=torch.int32),
                 zeros(n, 3), zeros(n, dtype=torch.bool),
                 zeros(num_cells(self.grid), dtype=torch.bool),
                 self.sim_params, self.sim_seed, 0)

    def tick(self, now_ms: Optional[int] = None) -> dict:
        """Run one device decision pass; returns the step's tensors (on
        the engine's device) under the JAX step's keys."""
        if now_ms is None:
            now_ms = self.now_ms()
        gen = self.generation
        # The flush carries the fence too (see _flush_host_state).
        self._flush_host_state(expect_generation=gen)
        # Sim pass first (device to device): agents advance, then the
        # spatial pass reads the moved positions — crossings, AOI,
        # standing queries and fan-out all see them this very tick, with
        # zero extra transfers.
        sim_committed = None
        census_due = False
        positions = self._d_positions
        if (self.sim_enabled and self.run_sim_pass and self._mesh is None
                and self._d_vel is not None):
            flee = self._d_flee
            if flee is None:
                flee = torch.zeros(num_cells(self.grid), dtype=torch.bool, device=self.device)
            sim_committed = sim_step(
                self.grid, positions, self._d_vel, self._d_sim_state,
                self._d_sim_target, self._d_agent, flee, self.sim_params,
                self.sim_seed, self.sim_tick,
            )
            positions = sim_committed[0]
            census_due = self.sim_census_due
        if self._mesh is not None:
            out = self._mesh_tick(now_ms)
        else:
            out = spatial_step(
                self.grid,
                positions,
                self._d_cell,
                self._d_valid,
                self._d_queries,
                self._d_sub_state,
                self.max_handovers,
                int(now_ms),
            )
        q_prev = None
        if self.track_query_changes:
            prev = self._d_q_prev
            if prev is None:
                prev = (torch.zeros_like(out["interest"]), torch.zeros_like(out["dist"]))
            elif self._q_prev_reset_rows:
                # Reused rows start from an empty baseline (new tensors;
                # committed only after the generation check).
                _, d_idx = self._stage_rows(self._q_prev_reset_rows)
                prev = (prev[0].index_fill(0, d_idx, False), prev[1].index_fill(0, d_idx, 0))
            q_blob, q_prev_i, q_prev_d = diff_query_masks(
                prev[0], prev[1], out["interest"], out["dist"], self.query_rows_max,
            )
            out["query_blob"] = q_blob
            out["query_epoch"] = self.query_epoch
            q_prev = (q_prev_i, q_prev_d)
        else:
            # No baseline while tracking is off — when it turns on, the
            # None baseline full-emits anyway, so pending resets are moot.
            self._q_prev_reset_rows.clear()
        census = None
        if sim_committed is not None and census_due:
            # The census columns, copied on the device before the fence
            # (nothing runs between the fence and the stores): later
            # flushes scatter host rows into the engine's columns in place.
            census = tuple(t.clone() for t in sim_committed)
        if gen != self.generation:
            # The watchdog abandoned this step: committing this tick's
            # tail state would corrupt the fresh baseline.
            raise RuntimeError("stale device tick abandoned by watchdog")
        if sim_committed is not None:
            # The sim batch commits with the spatial commit and only past
            # the fence above: an abandoned step never leaves a torn
            # population (positions advanced but kinematics not).
            (self._d_positions, self._d_vel, self._d_sim_state,
             self._d_sim_target) = sim_committed
            self.sim_tick += 1
            if census is not None:
                out["sim_census"] = census
                out["sim_tick"] = self.sim_tick
        # Baseline for the next tick: crossings that overflowed the handover
        # row budget keep their old cell so they are re-detected, not lost.
        # (The JAX step donates prev_cell; here the step's output replaces
        # it after the fence.)
        self._d_cell = out["committed_prev"]
        self._d_sub_state = (
            out["new_last_fanout_ms"],
            self._d_sub_state[1],
            self._d_sub_state[2],
        )
        if q_prev is not None:
            self._d_q_prev = q_prev
            self._q_prev_reset_rows.clear()
        self.last_result = out
        return out

    def _mesh_step_fn(self):
        """The sharded step, built once per (grid, with_spots)."""
        with_spots = self._d_queries.spot_dist is not None
        if self._mesh_step is None or self._mesh_step.with_spots != with_spots:
            n_shards = self._mesh.size
            per_shard = max(1, -(-self.max_handovers // n_shards))
            if self._sharding == "cells":
                from ..parallel.spatial_alltoall import build_cell_serving_step

                bucket = self._cell_bucket or (self.entity_capacity // n_shards)
                self._mesh_step = build_cell_serving_step(
                    self.grid, self._mesh, bucket, per_shard, with_spots)
            else:
                from ..parallel.mesh import build_sharded_step

                self._mesh_step = build_sharded_step(
                    self.grid, self._mesh, per_shard, with_spots)
        return self._mesh_step

    def _mesh_tick(self, now_ms: int) -> dict:
        """The sharded decision pass, normalized to the single-device
        result contract, with its ``consume`` blob. Reads nothing back:
        the merge of the per-shard rows and the overflow happen when the
        blob is consumed."""
        from ..parallel.mesh import mesh_consume_blob

        step = self._mesh_step_fn()
        args = (step, self._d_positions, self._d_cell, self._d_valid,
                self._d_queries, self._d_sub_state, now_ms)
        if self._sharding == "cells":
            from ..parallel.spatial_alltoall import cell_serving_spatial_step

            out = cell_serving_spatial_step(*args)
        else:
            from ..parallel.mesh import sharded_spatial_step

            out = sharded_spatial_step(*args)
        out["consume"] = mesh_consume_blob(out, self._mesh)
        # Rows per shard as the step was built (the budget, clamped to a
        # shard's slots), for parsing the blob.
        out["rows_per_shard"] = int(out["handovers"].shape[1])
        return out

    def undelivered_slots(self, result: dict) -> list[int]:
        """Slots whose cells-plane redistribution bucket was full this
        tick (empty for exact delivery / other shardings), read with the
        tick's consume blob. They remain in the ingest arrays and are
        re-offered automatically next tick; the controller sheds visibly
        (metric + security log)."""
        if result.get("undelivered") is None:
            return []
        self.consume(result)
        return np.nonzero(result["undelivered_host"])[0].tolist()

    # ---- reading a tick's results on the host ----------------------------

    def consume(self, result: dict) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
        """(handover_count, handover rows i32[K,3], cell counts i32[C],
        due u8[S]) of a tick, from ONE device->host copy of the step's
        ``consume`` blob. The parsed blob is cached on the result dict,
        so every reader of the tick shares that one transfer.

        A mesh tick's rows are every shard's reported rows merged in
        shard order, and its count is theirs (``merge_handover_shards``,
        as the JAX engine reports it: it can exceed ``max_handovers``,
        since per-shard budgets round up). On the cells plane the same
        read sets ``last_overflow`` and caches the ``undelivered`` mask
        for ``undelivered_slots``."""
        parsed = result.get("consume_host")
        if parsed is None:
            blob = result["consume"].cpu().numpy()
            if self._mesh is None:
                parsed = parse_consume_blob(
                    blob, min(self.max_handovers, self.entity_capacity),
                    num_cells(self.grid), self.sub_capacity,
                )
            else:
                from ..parallel.mesh import parse_mesh_consume_blob

                parsed, overflow, undelivered = parse_mesh_consume_blob(
                    blob, self._mesh.size, result["rows_per_shard"],
                    num_cells(self.grid), self.sub_capacity,
                    self.entity_capacity if "undelivered" in result else 0,
                )
                if undelivered is not None:
                    result["undelivered_host"] = undelivered
                    self.last_overflow = overflow
            result["consume_host"] = parsed
        return parsed

    def handover_list(self, result: dict) -> list[tuple[int, int, int]]:
        """[(entity_id, src_cell, dst_cell)] from a tick result.

        Every row present must be consumed: the device already committed
        these crossings (committed_prev), so a clamped row would be a
        permanently lost handover. Counts beyond the row budget
        re-detect next tick."""
        count, rows, _, _ = self.consume(result)
        rows = rows[: min(count, len(rows))]
        return [
            (int(self._entity_of_slot[slot]), int(src), int(dst))
            for slot, src, dst in rows
            if slot >= 0
        ]

    def interest_rows(self, result: dict, q_rows) -> np.ndarray:
        """i32[len(q_rows), C]: each query row's damping distance where
        it is interested, -1 where it is not. The rows are gathered on
        the device and copied to the host in one transfer."""
        idx = torch.as_tensor(np.asarray(q_rows, np.int64), device=self.device)
        interest = result["interest"].index_select(0, idx)
        dist = result["dist"].index_select(0, idx)
        return torch.where(interest, dist, -1).cpu().numpy()

    def interested_cells(self, result: dict, conn_id: int) -> dict[int, int]:
        """{cell_index: grid_distance} for one connection's query."""
        return self.interested_cells_batch(result, [conn_id]).get(conn_id, {})

    def interested_cells_batch(
        self, result: dict, conn_ids
    ) -> dict[int, dict[int, int]]:
        """{conn_id: {cell_index: grid_distance}} for MANY queries in one
        device->host transfer of just their rows."""
        rows = [
            (cid, q) for cid in conn_ids
            if (q := self._q_of_conn.get(cid)) is not None
        ]
        if not rows:
            return {}
        table = self.interest_rows(result, [q for _, q in rows])
        out: dict[int, dict[int, int]] = {}
        for (cid, _), drow in zip(rows, table):
            cells = np.nonzero(drow >= 0)[0]
            out[cid] = {int(c): int(drow[c]) for c in cells}
        return out

    def query_changed_rows(self, result: dict) -> tuple[int, np.ndarray]:
        """(total_changed, rows i32[R, 3]) of a tick — the standing-query
        plane's one device->host transfer per tick. The fetched blob is
        cached back onto the result dict, so however many consumers ask,
        the transfer happens once. Row layout: (query_row, cell,
        new_dist), dist == -1 meaning interest removed; rows beyond
        min(total, R) are -1 padding. (0, empty) when tracking was off
        for this tick."""
        blob = result.get("query_blob")
        if blob is None:
            return 0, np.zeros((0, 3), np.int32)
        if isinstance(blob, torch.Tensor):
            blob = blob.cpu().numpy()
            result["query_blob"] = blob
        return parse_query_blob(blob)

    # ---- supervision -----------------------------------------------------

    def tracked_entities(self) -> list[tuple[int, int]]:
        """[(entity_id, slot)] for every live registration."""
        return list(self._slot_of_entity.items())

    def bump_generation(self) -> None:
        """Fence off an abandoned (hung) step: a zombie worker finishing
        the old tick later raises instead of committing its tail state."""
        self.generation += 1

    # ---- recovery (doc/device_recovery.md) -------------------------------

    def _cell_baselines(self, slot_cells: dict[int, int]) -> np.ndarray:
        cells = np.full(self.entity_capacity, -1, np.int32)
        if slot_cells:
            cells[np.fromiter(slot_cells.keys(), np.int64, len(slot_cells))] = np.fromiter(
                slot_cells.values(), np.int32, len(slot_cells))
        return cells

    def rebuild_device_state(self, slot_cells: dict[int, int],
                             now_ms: Optional[int] = None,
                             expect_generation: Optional[int] = None) -> None:
        """Rebuild every device table from the host shadow. The host
        mirrors are authoritative for everything except two
        device-advanced columns:

        - the per-slot *previous cell* baseline, which the caller passes
          in as ``slot_cells`` (where each entity's data is bound; the
          next tick re-detects any move since);
        - the sub table's last-fan-out column, which is snapped to
          ``now``: every sub's window restarts one full interval from
          the rebuild.

        Nothing the old device tensors held survives. The standing-query
        baseline is dropped and ``query_epoch`` moves, so the host plane
        full-resyncs. ``expect_generation``: the fresh tensors are built
        first, and nothing engine-visible changes unless the generation
        still matches (a rebuild abandoned by a watchdog raises)."""
        if now_ms is None:
            now_ms = self.now_ms()
        if expect_generation is None:
            expect_generation = self.generation
        d_positions = self._entity_upload(self._positions)
        d_valid = self._entity_upload(self._valid)
        d_cell = self._entity_upload(self._cell_baselines(slot_cells))
        if expect_generation != self.generation:
            raise RuntimeError("stale rebuild abandoned by watchdog")
        self.generation += 1
        self._d_positions = d_positions
        self._d_valid = d_valid
        self._d_cell = d_cell
        self._dirty_slots.clear()
        self._seed_cells.clear()
        # Query tables: host staging is authoritative; re-upload whole.
        self._d_queries = None
        self._d_spot_dist = None
        self._spot_dirty_rows.clear()
        self._queries_dirty = True
        # Sim columns: the host shadow (last census + explicit stages) is
        # authoritative; dropping the device copies forces the
        # whole-column upload on the flush below.
        self._d_vel = None
        self._d_sim_state = None
        self._d_sim_target = None
        self._d_agent = None
        self._d_flee = None
        self._flee_dirty = self._flee_cells is not None
        self._sim_dirty.clear()
        self._d_q_prev = None
        self._q_prev_reset_rows.clear()
        self.query_epoch += 1
        # Sub table: intervals/active from the host mirror; the
        # device-authoritative last-fan-out column restarts at now.
        self._sub_last[self._sub_active] = now_ms
        self._d_sub_state = None
        self._sub_dirty_slots.clear()
        self._sub_last_dirty.clear()
        self._flush_host_state()
        self.last_result = None

    def apply_grid(self, grid, slot_cells: dict[int, int],
                   now_ms: Optional[int] = None,
                   expect_generation: Optional[int] = None) -> None:
        """Swap the cell grid and rebuild every grid-shaped device table
        (adaptive partitioning, doc/partitioning.md). ``slot_cells`` are
        the cell baselines in NEW-grid indices. Grid-shaped state that
        cannot be carried over is rebuilt from world-space sources: the
        spots table re-rasterizes from each query's spots; the flee mask
        is dropped (its owner re-rasterizes it for the new geometry)."""
        self.grid = grid
        # The grid is baked into the mesh step: rebuilt on the next tick.
        self._mesh_step = None
        self._q_spot_dist = None
        self._d_spot_dist = None
        self._spot_dirty_rows.clear()
        self._flee_cells = None
        for conn_id, (spots, dists) in list(self._spot_sources.items()):
            self.set_spots_query(conn_id, spots, dists)
        self.rebuild_device_state(slot_cells, now_ms=now_ms,
                                  expect_generation=expect_generation)

    def verify_device_state(self, slot_cells: dict[int, int]) -> list[str]:
        """Bit-identical rebuild verification: fetch the device tables
        and compare them against the host shadow (and the seeded cell
        baselines). Returns mismatch descriptions (empty == verified).
        Recovery path only, never called from the tick: these transfers
        are the designed one-off cost. Floats compare with NaN equal to
        NaN (a NaN position round-trips the device bit for bit)."""

        def same(dev: torch.Tensor, host: np.ndarray, equal_nan: bool = False) -> bool:
            return np.array_equal(dev.cpu().numpy(), host, equal_nan=equal_nan)

        def same_entity(column, host: np.ndarray, equal_nan: bool = False) -> bool:
            return np.array_equal(self._entity_host(column), host, equal_nan=equal_nan)

        errors: list[str] = []
        if not same_entity(self._d_positions, self._positions, True):
            errors.append("positions differ from host shadow")
        if not same_entity(self._d_valid, self._valid):
            errors.append("valid mask differs from host shadow")
        if not same_entity(self._d_cell, self._cell_baselines(slot_cells)):
            errors.append("cell baselines differ from placement seeds")
        if self._d_queries is not None:
            for name, dev, host, has_nan in (
                ("query kinds", self._d_queries.kind, self._q_kind, False),
                ("query centers", self._d_queries.center, self._q_center, True),
                ("query extents", self._d_queries.extent, self._q_extent, True),
            ):
                if not same(dev, host, has_nan):
                    errors.append(f"{name} differ from host shadow")
        if self._d_sub_state is not None:
            last, interval, active = self._d_sub_state
            if not same(interval, self._sub_interval):
                errors.append("sub intervals differ from host shadow")
            if not same(active, self._sub_active):
                errors.append("sub active mask differs from host shadow")
            if not same(last, self._sub_last):
                errors.append("sub clock differs from rebuild seed")
        if self.sim_enabled and self._d_vel is not None:
            sim_errors: list[str] = []
            for name, dev, host, has_nan in (
                ("agent velocities", self._d_vel, self._vel, True),
                ("agent FSM states", self._d_sim_state, self._sim_state, False),
                ("agent waypoints", self._d_sim_target, self._sim_target, True),
                ("agent mask", self._d_agent, self._agent_mask, False),
            ):
                if not same(dev, host, has_nan):
                    sim_errors.append(f"{name} differ from host shadow")
            if self._flee_cells is not None and self._d_flee is not None:
                if not same(self._d_flee, self._flee_cells):
                    sim_errors.append("flee mask differs from host shadow")
            errors.extend(sim_errors)
            self._count_sim_rebuild("verified" if not sim_errors else "mismatch")
        return errors

    def corrupt_device_state_for_chaos(self) -> None:
        """CHAOS ONLY (``device.nan``): rot the device state the way a bad
        DMA or a bit-flipped HBM page would — garbage prev-cell baselines
        on a quarter of the live slots (they surface as impossible src
        cells in the next tick's handover rows, the readback sentinel's
        signature) and NaN positions on a disjoint quarter. New tensors,
        like the reference's functional updates."""
        live = np.fromiter(self._slot_of_entity.values(), np.int64, len(self._slot_of_entity))
        n = max(1, len(live) // 4)
        self._d_cell = self._entity_fill(self._d_cell, live[:n], 1 << 24)
        if len(live[n:2 * n]):
            self._d_positions = self._entity_fill(self._d_positions, live[n:2 * n], float("nan"))
