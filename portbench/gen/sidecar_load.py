"""Seeded sidecar traffic, one StepRequest's content a step.

A frozen copy of ``chip_smoke.py``'s ``Load`` (lines 904-1008 of the tree
this benchmark was written against), made steady over a window and driven by
a mix's parameters:

- every mover ships its position each step (``movers``: "all", or that many
  seeded entities; the others send nothing, as channeld ships deltas only);
- churn each step after the first: ``entity_churn`` entities leave and as
  many join (slot reuse), ``query_changes`` queries change and
  ``conn_churn`` connections are replaced, ``sub_churn`` subscriptions are
  removed and as many added;
- every ``burst_every`` steps (from step ``burst_phase``) a burst moves
  ``burst_entities`` entities by one cell column (a respawn wave), which
  overflows the handover rows;
- the pinned NaN / ±inf / 1e20 / cell-boundary rows stay and ship every step.

Every draw comes from one ``numpy.random.Generator`` seeded from the run's
seed, in a fixed order, so the same seed gives the same steps. The
generator knows nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.wire import Query


class Step(NamedTuple):
    """One step of traffic: what a StepRequest carries."""

    now_ms: int
    upd_ids: np.ndarray  # u32[k]
    upd_pos: np.ndarray  # f32[k, 3]
    removed_entities: np.ndarray  # u32
    queries: list  # [Query]
    removed_conns: np.ndarray
    add_sub_ids: np.ndarray
    add_sub_interval: np.ndarray
    add_sub_first: np.ndarray
    remove_subs: np.ndarray
    full: bool
    live_entities: int  # entities registered once this step is applied


class Load:
    """Seeded traffic of one sidecar mix on one world."""

    def __init__(self, seed: int, grid: dict, mix: dict):
        self.rng = np.random.default_rng(seed)
        rng = self.rng
        self.grid = grid
        self.mix = mix
        n = int(mix["entities"])
        self.lo = float(grid["offset_x"])
        self.world = float(grid["cell_w"]) * int(grid["cols"])
        self.cell = float(grid["cell_w"])
        self.ids = np.arange(1, n + 1, dtype=np.int64) + int(mix["first_entity_id"])
        self.pos = rng.uniform(self.lo, self.lo + self.world, (n, 3)).astype(np.float32)
        self.pos[:, 1] = 0.0
        speed = rng.uniform(0, float(mix["max_speed"]), n)
        heading = rng.uniform(0, 2 * np.pi, n)
        self.vel = np.stack([speed * np.cos(heading), np.zeros(n),
                             speed * np.sin(heading)], axis=1).astype(np.float32)
        # Pinned hazards: NaN, ±inf, 1e20 and exact cell boundaries.
        self.pos[:6, 0] = [np.nan, np.inf, -np.inf, 1e20, self.lo, self.lo + 8 * self.cell]
        self.pos[:6, 2] = [0.0, 0.0, 0.0, 0.0, self.lo + self.cell, np.nan]
        self.vel[:6] = 0.0
        movers = mix["movers"]
        if movers == "all":
            self.movers = np.arange(6, n)
        else:
            self.movers = np.sort(6 + rng.choice(n - 6, int(movers), replace=False))
        self.next_id = int(self.ids[-1]) + 1
        nq = int(mix["queries"])
        self.conns = list(range(1, nq + 1))
        self.next_conn = nq + 1
        self.removed_conns: list[int] = []
        ns = int(mix["subscriptions"])
        self.subs = np.arange(1, ns + 1)
        self.next_sub = ns + 1
        self.fresh = np.zeros(0, np.int64)  # rows whose entity joined last step
        self.live = n

    KINDS = np.array([0, 1, 1, 1, 2, 2, 3, 3, 4])  # none, sphere, box, cone, spots

    def query(self, conn: int) -> Query:
        r = self.rng
        lo, world = self.lo, self.world
        u = r.random(7)
        kind = int(self.KINDS[int(u[0] * 9)])
        c = (lo - 2000 + u[1:3] * (world + 4000)).astype(np.float32)
        if u[3] < 0.25:  # centre on a cell corner
            c = (lo + r.integers(0, int(self.grid["cols"]) + 1, 2) * self.cell).astype(np.float32)
        d = r.normal(size=2).astype(np.float32)
        ext = (100 + u[4:6] * 7900).astype(np.float32)
        angle = np.float32(0.05 + u[6] * 1.45)
        spot_x = spot_z = spot_d = ()
        if kind == 4:
            k = int(r.integers(1, 8))
            xz = (lo - 1000 + r.random((2, k)) * (world + 1000)).astype(np.float32)
            spot_x, spot_z = tuple(xz[0].tolist()), tuple(xz[1].tolist())
            spot_d = tuple(r.integers(0, 6, int(r.integers(0, k + 1))).tolist())
        return Query(conn, kind, float(c[0]), float(c[1]), float(ext[0]), float(ext[1]),
                     float(d[0]), float(d[1]), float(angle), spot_x, spot_z, spot_d)

    def _subs(self, ids, now_ms: int):
        k = len(ids)
        interval = self.rng.integers(33, 201, k)
        first = now_ms + self.rng.integers(0, 200, k)
        return (np.asarray(ids, np.int64), interval.astype(np.int64), first.astype(np.int64))

    def step(self, step: int) -> Step:
        r, mix = self.rng, self.mix
        now = 1000 + 33 * step
        lo, world = self.lo, self.world
        n = len(self.pos)
        moved = self.pos.copy()
        m = self.pos[self.movers] + self.vel[self.movers]
        m[:, 0] = (m[:, 0] - lo) % world + lo
        m[:, 2] = (m[:, 2] - lo) % world + lo
        moved[self.movers] = m
        ship = np.zeros(n, bool)
        ship[:6] = True  # the pinned hazards ship every step
        ship[self.movers] = True
        ship[self.fresh] = True  # a new entity ships its first position
        every, phase = int(mix["burst_every"]), int(mix["burst_phase"])
        if every and step % every == phase:  # a respawn wave
            burst = 6 + r.choice(n - 6, int(mix["burst_entities"]), replace=False)
            moved[burst, 0] = (moved[burst, 0] - lo + self.cell) % world + lo
            ship[burst] = True
        self.pos = moved.astype(np.float32)
        if step == 0:
            ship[:] = True  # the first step registers every entity
        rows = np.nonzero(ship)[0]
        upd_ids = self.ids[rows].astype(np.uint32)
        upd_pos = self.pos[rows]
        removed = np.zeros(0, np.int64)
        self.fresh = np.zeros(0, np.int64)
        churn = int(mix["entity_churn"])
        if step > 0 and churn:  # churn: entities leave, as many join (slot reuse)
            gone = 6 + r.choice(n - 6, churn, replace=False)
            removed = self.ids[gone].copy()
            self.ids[gone] = np.arange(self.next_id, self.next_id + churn)
            self.next_id += churn
            self.fresh = np.sort(gone)
        queries, removed_conns = [], []
        if step == 0:
            queries = [self.query(c) for c in self.conns]
        else:
            for c in r.choice(self.conns, int(mix["query_changes"]), replace=False):
                queries.append(self.query(int(c)))
            # Rows freed last step are taken by new connections now.
            for _ in self.removed_conns:
                self.conns.append(self.next_conn)
                queries.append(self.query(self.next_conn))
                self.next_conn += 1
            touched = {q.conn for q in queries}
            keep = [c for c in self.conns if c not in touched]
            removed_conns = [int(c) for c in r.choice(keep, int(mix["conn_churn"]), replace=False)]
            gone_conns = set(removed_conns)
            self.conns = [c for c in self.conns if c not in gone_conns]
        self.removed_conns = removed_conns
        if step == 0:
            add = self._subs(self.subs, now)
            remove_subs = np.zeros(0, np.int64)
        else:
            k = int(mix["sub_churn"])
            remove_subs = self.subs[r.choice(self.subs.size, k, replace=False)].astype(np.int64)
            self.subs = self.subs[~np.isin(self.subs, remove_subs)]
            fresh_subs = np.arange(self.next_sub, self.next_sub + k)
            add = self._subs(fresh_subs, now)
            self.subs = np.concatenate([self.subs, fresh_subs])
            self.next_sub += k
        self.live = n - len(removed)
        return Step(now, upd_ids, upd_pos, removed.astype(np.uint32), queries,
                    np.asarray(removed_conns, np.int64), add[0], add[1], add[2],
                    remove_subs, step == 0, self.live)
