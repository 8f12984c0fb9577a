"""The sidecar's decision pass, worked out again in plain NumPy.

``SidecarRef.apply(step)`` takes one step of generated traffic (the content
of a StepRequest) and returns the decision a StepResponse must carry. It
keeps the state the pass defines: entity slots (a fresh entity takes the
most recently freed slot, the lowest never-used one otherwise; a reused slot
starts with no previous cell), query rows and subscription slots allocated
the same way, each slot's committed cell (a crossing beyond the row budget
keeps its old cell, so it is found again), each subscription's window.

A request is applied in the order the service states: updates, entity
removals, queries (a spots query rasterised to a cell table; a direction
normalised in double precision, a zero one taken as +x), query removals,
subscriptions added, subscriptions removed; then the tick at ``nowMs``.
Interest is reported for every query on a full sync, else for the queries
set by this step and not removed by it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import geometry as g


class RefDecision(NamedTuple):
    handover_count: int
    handovers: np.ndarray  # int64[k, 3]: entity, src, dst
    cell_counts: np.ndarray
    interests: dict  # conn -> (strict bool[C], loose bool[C], dist i32[C])
    due_sub_ids: np.ndarray  # sorted


class SidecarRef:
    def __init__(self, grid: dict, entity_capacity: int, query_capacity: int,
                 sub_capacity: int, max_handovers: int = 4096, precision: str = "f32"):
        self.grid = grid
        self.cells = int(grid["cols"]) * int(grid["rows"])
        self.max_rows = max_handovers
        self.bf16 = precision == "bf16"
        n = entity_capacity
        self.pos = np.zeros((n, 3), np.float32)
        self.valid = np.zeros(n, bool)
        self.prev = np.full(n, -1, np.int32)
        self.entity_of_slot = np.zeros(n, np.int64)
        self.free = list(range(n - 1, -1, -1))
        self.slot_of_id = np.full(1 << 20, -1, np.int64)
        q = query_capacity
        self.q_kind = np.zeros(q, np.int32)
        self.q_geo = np.zeros((q, 7), np.float32)  # cx cz ex ez dx dz angle
        self.q_spots: dict[int, np.ndarray] = {}
        self.q_free = list(range(q - 1, -1, -1))
        self.q_of_conn: dict[int, int] = {}
        s = sub_capacity
        self.sub_last = np.zeros(s, np.int32)
        self.sub_interval = np.zeros(s, np.int32)
        self.sub_active = np.zeros(s, bool)
        self.sub_free = list(range(s - 1, -1, -1))
        self.sub_slot: dict[int, int] = {}

    def _slots(self, ids: np.ndarray) -> np.ndarray:
        top = int(ids.max()) + 1 if ids.size else 0
        if top > self.slot_of_id.size:
            grown = np.full(max(top, 2 * self.slot_of_id.size), -1, np.int64)
            grown[: self.slot_of_id.size] = self.slot_of_id
            self.slot_of_id = grown
        return self.slot_of_id[ids]

    def _ingest(self, step) -> None:
        ids = step.upd_ids.astype(np.int64)
        slots = self._slots(ids)
        for i in np.nonzero(slots < 0)[0]:  # new entities, in update order
            slot = self.free.pop()
            slots[i] = slot
            self.slot_of_id[ids[i]] = slot
            self.entity_of_slot[slot] = ids[i]
            self.prev[slot] = -1
        self.pos[slots] = step.upd_pos
        self.valid[slots] = True
        for eid in step.removed_entities.astype(np.int64):
            slot = int(self._slots(np.array([eid]))[0])
            if slot < 0:
                continue
            self.slot_of_id[eid] = -1
            self.valid[slot] = False
            self.free.append(slot)

    def _set_queries(self, step) -> list:
        dirty = []
        for q in step.queries:
            row = self.q_of_conn.get(q.conn)
            if row is None:
                row = self.q_free.pop()
                self.q_of_conn[q.conn] = row
            if q.kind == g.AOI_SPOTS:
                self.q_kind[row] = g.AOI_SPOTS
                self.q_spots[row] = g.spots_row(self.grid, q.spot_x, q.spot_z, q.spot_dists)
            else:
                self.q_spots.pop(row, None)
                dx, dz = (q.dx, q.dz) if (q.dx, q.dz) != (0.0, 0.0) else (1.0, 0.0)
                norm = float(np.hypot(dx, dz)) or 1.0
                self.q_kind[row] = q.kind
                self.q_geo[row] = (q.cx, q.cz, q.ex, q.ez, dx / norm, dz / norm, q.angle)
            dirty.append(q.conn)
        for conn in step.removed_conns.tolist():
            row = self.q_of_conn.pop(conn, None)
            if row is not None:
                self.q_kind[row] = g.AOI_NONE
                self.q_spots.pop(row, None)
                self.q_free.append(row)
        return dirty

    def _subscriptions(self, step) -> None:
        for sid, interval, first in zip(step.add_sub_ids.tolist(),
                                        step.add_sub_interval.tolist(),
                                        step.add_sub_first.tolist()):
            slot = self.sub_free.pop()
            self.sub_last[slot] = first
            self.sub_interval[slot] = interval
            self.sub_active[slot] = True
            self.sub_slot[sid] = slot
        for sid in step.remove_subs.tolist():
            slot = self.sub_slot.pop(sid, None)
            if slot is not None:
                self.sub_active[slot] = False
                self.sub_free.append(slot)

    def interest_rows(self, conns: list) -> dict:
        rows = [self.q_of_conn[c] for c in conns]
        if not rows:
            return {}
        idx = np.asarray(rows)
        geo = self.q_geo[idx]
        kind = self.q_kind[idx]
        spot = None
        if any(r in self.q_spots for r in rows):
            spot = np.stack([self.q_spots.get(r, np.full(self.cells, -1, np.int32))
                             for r in rows])
        strict, loose, dist = g.interest(
            self.grid, kind, geo[:, 0], geo[:, 1], geo[:, 2], geo[:, 3], geo[:, 4],
            geo[:, 5], g.cos_threshold(geo[:, 6]), spot)
        return {c: (strict[i], loose[i], dist[i]) for i, c in enumerate(conns)}

    def apply(self, step) -> RefDecision:
        self._ingest(step)
        dirty = self._set_queries(step)
        self._subscriptions(step)
        pos = g.bf16(self.pos) if self.bf16 else self.pos
        cell = g.assign_cells(self.grid, pos, self.valid)
        count, rows, self.prev = g.handovers(self.prev, cell, self.max_rows)
        rows[:, 0] = self.entity_of_slot[rows[:, 0]]
        due, self.sub_last = g.fanout_due(step.now_ms, self.sub_last, self.sub_interval,
                                          self.sub_active)
        if step.full:
            report = list(self.q_of_conn)
        else:
            report = [c for c in dict.fromkeys(dirty) if c in self.q_of_conn]
        due_slots = set(np.nonzero(due)[0].tolist())
        due_ids = sorted(sid for sid, slot in self.sub_slot.items() if slot in due_slots)
        return RefDecision(count, rows, g.cell_counts(cell, self.cells),
                           self.interest_rows(report), np.asarray(due_ids, np.int64))


def compare(got, want: RefDecision) -> tuple[list, int]:
    """(what differs, cone pairs inside the threshold's band) between a
    decoded StepResponse (``core.wire.Decision``) and the reference."""
    diffs = []
    if got.error:
        diffs.append(f"error {got.error!r}")
    if got.handover_count != want.handover_count:
        diffs.append(f"handover count {got.handover_count} != {want.handover_count}")
    if not np.array_equal(got.handovers, want.handovers):
        diffs.append(f"handover rows differ ({len(got.handovers)} vs {len(want.handovers)})")
    if not np.array_equal(got.cell_counts, want.cell_counts):
        diffs.append("cell counts differ")
    if not np.array_equal(np.sort(got.due_sub_ids), want.due_sub_ids):
        diffs.append(f"due ids differ ({len(got.due_sub_ids)} vs {len(want.due_sub_ids)})")
    if set(got.interests) != set(want.interests):
        diffs.append(f"interest conns differ ({len(got.interests)} vs {len(want.interests)})")
    band = 0
    for conn, (strict, loose, dist) in want.interests.items():
        if conn not in got.interests:
            continue
        cells, dists = got.interests[conn]
        hit = np.zeros(strict.shape[0], bool)
        ok = cells.size == np.unique(cells).size and (cells.size == 0 or (
            cells.min() >= 0 and cells.max() < strict.shape[0]))
        if ok:
            hit[cells] = True
            ok = (not (strict & ~hit).any() and not (hit & ~loose).any()
                  and np.array_equal(dists, dist[cells]))
        if not ok:
            diffs.append(f"interest of conn {conn} differs")
        band += int((loose & ~strict).sum())
    return diffs, band
