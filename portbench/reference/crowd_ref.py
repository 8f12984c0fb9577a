"""The device crowd's tick, worked out again in plain NumPy from the seed.

``CrowdRef.tick(t)`` steps the population (flocking from per-cell sums,
waypoints, the four-state machine, the counter-based dice) and then decides
the tick: crossings, occupancy, due subscriptions and the standing queries'
changed rows. Every float op is a float32 op in the order the sim pass
states (each product and sum rounded on its own; a cell's sum adds its
agents one at a time in ascending slot order from 0), so the columns are
compared bit for bit.

The state it keeps is what the engine defines: agents in slots 0.. in spawn
order; each slot's committed cell; each subscription's window; the standing
queries' committed (interest, distance) baseline, of which at most
``rows_max`` changed entries a tick are reported in row-major order and the
rest stay pending; the host's shadow of the agents' positions, refreshed by
each census, on which the followers re-centre.
"""

from __future__ import annotations

import numpy as np

from ..gen import crowd_world as cw
from . import geometry as g

F32 = np.float32
IDLE, WANDER, SEEK, FLEE = 0, 1, 2, 3
_U32 = np.uint32


def rand_lanes(seed: int, tick: int, slots: np.ndarray, lanes: int) -> np.ndarray:
    """The sim's counter-based dice: u32[lanes, n] hashes of (seed, tick,
    lane, slot): a Weyl sequence through murmur3's fmix32."""
    idx = slots.astype(_U32)
    lane = np.arange(lanes, dtype=_U32)[:, None]
    x = idx * _U32(0x9E3779B9) + _U32(int(seed) & 0xFFFFFFFF)
    x = x ^ _U32(((int(tick) & 0xFFFFFFFF) * 0x85EBCA6B) & 0xFFFFFFFF)
    x = x[None, :] + lane * _U32(0xC2B2AE35)
    x = x ^ (x >> _U32(16))
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> _U32(15))
    x = x * _U32(0x846CA68B)
    return x ^ (x >> _U32(16))


def _cols(a):
    return [np.ascontiguousarray(a[:, k]) for k in range(3)]


def sim_step(grid: dict, p: dict, pos, vel, state, target, slots, flee, seed: int, tick: int):
    """One step of the agents in ``slots`` (ascending): new (pos, vel,
    state, target) rows. Worked column by column; each op is the float32
    op of the sim pass on that component."""
    c = int(grid["cols"]) * int(grid["rows"])
    cols = int(grid["cols"])
    px, py, pz = _cols(pos)
    vx, vy, vz = _cols(vel)
    tx, ty, tz = _cols(target)
    gx, in_x = g.coord(px, grid["offset_x"], grid["cell_w"], grid["cols"])
    gz, in_z = g.coord(pz, grid["offset_z"], grid["cell_h"], grid["rows"])
    live = in_x & in_z
    safe = np.where(live, gx + gz * np.int32(cols), np.int32(0))
    ls = safe[live]
    counts = np.bincount(ls, minlength=c).astype(np.float32)
    sum_x = np.zeros(c, np.float32)
    sum_z = np.zeros(c, np.float32)
    np.add.at(sum_x, ls, px[live])
    np.add.at(sum_z, ls, pz[live])
    dead = ~live
    if (dead & ~np.isfinite(px)).any():
        sum_x[0] = F32(np.nan)
    if (dead & ~np.isfinite(pz)).any():
        sum_z[0] = F32(np.nan)
    den = np.maximum(counts, F32(1))
    my_count = counts[safe]
    ax = px - (sum_x / den)[safe]
    az = pz - (sum_z / den)[safe]
    alen = np.sqrt(ax * ax + az * az)
    aden = np.maximum(alen, F32(1e-6))
    adx, adz = ax / aden, az / aden
    crowded = my_count > p["crowd"]
    near = np.minimum(alen, F32(1.0))
    sep, coh = F32(p["separation"]), F32(p["cohesion"])
    sx = np.where(crowded, adx * sep, (-adx) * near * coh)
    sz = np.where(crowded, adz * sep, (-adz) * near * coh)

    r = (rand_lanes(seed, tick, slots, 5) >> _U32(8)).astype(np.float32) * F32(1.0 / (1 << 24))
    r_trans = r[0]
    dtx, dtz = tx - px, tz - pz
    arrived = np.sqrt(dtx * dtx + dtz * dtz) <= F32(p["arrive_radius"])
    danger = live & flee[safe]
    st = state
    p_seek = F32(p["p_seek"])
    new = np.where((st == SEEK) & arrived, IDLE, st)
    wander = st == WANDER
    new = np.where(wander & (r_trans < p_seek), SEEK, new)
    new = np.where(wander & (r_trans >= p_seek) & (r_trans < F32(p["p_seek"] + p["p_idle"])),
                   IDLE, new)
    new = np.where((st == IDLE) & (r_trans < F32(p["p_wander"])), WANDER, new)
    new = np.where(danger, FLEE, np.where((st == FLEE) & ~danger, WANDER, new)).astype(np.int32)

    ox, oz = F32(grid["offset_x"]), F32(grid["offset_z"])
    rtx = r[1] * F32(grid["cols"] * grid["cell_w"]) + ox
    rtz = r[2] * F32(grid["rows"] * grid["cell_h"]) + oz
    ccx = ((safe % cols).astype(np.float32) + F32(0.5)) * F32(grid["cell_w"]) + ox
    ccz = ((safe // cols).astype(np.float32) + F32(0.5)) * F32(grid["cell_h"]) + oz
    ftx = px * F32(2.0) - ccx
    ftz = pz * F32(2.0) - ccz
    es = (new == SEEK) & (st != SEEK)
    ef = (new == FLEE) & (st != FLEE)
    ntx = np.where(ef, ftx, np.where(es, rtx, tx))
    nty = np.where(ef, py, np.where(es, py, ty))
    ntz = np.where(ef, ftz, np.where(es, rtz, tz))

    ms = F32(p["max_speed"])
    dx, dy, dz = ntx - px, nty - py, ntz - pz
    nden = np.maximum(np.sqrt(dx * dx + dz * dz), F32(1e-6))
    seeking = (new == SEEK) | (new == FLEE)
    wanders = new == WANDER
    zero = np.zeros_like(px)
    jitter = (r[3] * F32(2.0) - F32(1.0), zero, r[4] * F32(2.0) - F32(1.0))
    des = []
    for d, v, j in zip((dx, dy, dz), (vx, vy, vz), jitter):
        des.append(np.where(seeking, (d / nden) * ms,
                            np.where(wanders, v * F32(0.9) + j * ms * F32(0.5), zero)))
    des[0] = des[0] + sx * ms
    des[2] = des[2] + sz * ms
    dvx, dvy, dvz = des[0] - vx, des[1] - vy, des[2] - vz
    dvlen = np.sqrt((dvx * dvx + dvy * dvy) + dvz * dvz)
    stp = np.minimum(dvlen, F32(p["accel"] * p["dt"]))
    vden = np.maximum(dvlen, F32(1e-6))
    nvx = vx + dvx / vden * stp
    nvy = vy + dvy / vden * stp
    nvz = vz + dvz / vden * stp
    speed = np.sqrt((nvx * nvx + nvy * nvy) + nvz * nvz)
    scale = np.minimum(np.full_like(speed, ms) / np.maximum(speed, F32(1e-6)), F32(1.0))
    nvx, nvz = nvx * scale, nvz * scale
    nvy = zero
    dt = F32(p["dt"])
    margin = F32(min(grid["cell_w"], grid["cell_h"]) * 1e-3)
    lo_x = F32(grid["offset_x"]) + margin
    hi_x = F32(grid["offset_x"] + grid["cols"] * grid["cell_w"]) - margin
    lo_z = F32(grid["offset_z"]) + margin
    hi_z = F32(grid["offset_z"] + grid["rows"] * grid["cell_h"]) - margin
    npx = np.clip(px + nvx * dt, lo_x, hi_x)
    npy = py + nvy * dt
    npz = np.clip(pz + nvz * dt, lo_z, hi_z)
    stack = lambda a, b, c: np.stack([a, b, c], axis=1).astype(np.float32)  # noqa: E731
    return stack(npx, npy, npz), stack(nvx, nvy, nvz), new, stack(ntx, nty, ntz)


class CrowdRef:
    """The crowd of one config and mix from one seed, tick by tick."""

    BLOCK = 256  # query rows per interest block

    def __init__(self, seed: int, config: dict, mix: dict, precision: str = "f32"):
        self.config = config
        self.grid = grid = config["grid"]
        self.mix = mix
        self.params = config["sim_params"]
        self.bf16 = precision == "bf16"
        self.cells = int(grid["cols"]) * int(grid["rows"])
        cap = int(config["entity_capacity"])
        world = cw.build(seed, grid, mix)
        self.world = world
        n = len(world.ids)
        self.pos = np.zeros((cap, 3), np.float32)
        self.pos[:n, 0] = world.xs
        self.pos[:n, 2] = world.zs
        self.vel = np.zeros((cap, 3), np.float32)
        self.state = np.zeros(cap, np.int32)
        self.target = self.pos.copy()
        self.shadow = self.pos.copy()
        self.agent = np.zeros(cap, bool)
        self.agent[:n] = True
        self.slots = np.arange(n)
        self.id_of_slot = np.zeros(cap, np.int64)
        self.id_of_slot[:n] = world.ids
        self.sim_seed = int(seed) & 0xFFFFFFFF
        self.prev = np.full(cap, -1, np.int32)
        ns = len(world.sub_interval)
        self.sub_last = world.sub_first.astype(np.int32)
        self.sub_interval = world.sub_interval.astype(np.int32)
        self.sub_active = np.ones(ns, bool)
        self.flee = np.zeros(self.cells, bool)
        q = int(config["query_capacity"])
        self.rows_max = min(int(config["query_rows_max"]), q * self.cells)
        self.cur_i = np.zeros((q, self.cells), bool)
        self.cur_d = np.zeros((q, self.cells), np.int32)
        self.prev_i = np.zeros_like(self.cur_i)
        self.prev_d = np.zeros_like(self.cur_d)
        self.nf = len(world.followed)
        self.cone_band_pairs = 0
        self._sensors()
        self.follow_at = None
        self.pending = set(range(self.nf + len(world.sensors)))
        self.max_handovers = int(config["max_handovers"])

    def _rows(self, first: int, kind, cx, cz, ex, ez, spot=None) -> None:
        k = len(kind)
        for b in range(0, k, self.BLOCK):
            s = slice(b, b + self.BLOCK)
            nb = len(kind[s])
            one = np.ones(nb, np.float32)
            strict, loose, dist = g.interest(
                self.grid, np.asarray(kind[s]), cx[s], cz[s], ex[s], ez[s], one, 0 * one,
                g.cos_threshold(np.full(nb, self.mix["sensor_angle"] if spot is not None
                                        else 0.0, np.float32)),
                None if spot is None else spot[s])
            self.cone_band_pairs += int((loose & ~strict).sum())
            self.cur_i[first + b: first + b + nb] = strict
            self.cur_d[first + b: first + b + nb] = dist

    def _sensors(self) -> None:
        sensors = self.world.sensors
        kind = np.array([s.kind for s in sensors])
        f = lambda a: np.asarray(a, np.float32)  # noqa: E731
        spot = np.stack([g.spots_row(self.grid, [s.x], [s.z], [1]) if s.kind == cw.SPOTS
                         else np.full(self.cells, -1, np.int32) for s in sensors])
        self._rows(self.nf, kind, f([s.x for s in sensors]), f([s.z for s in sensors]),
                   f([s.ex for s in sensors]), f([s.ez for s in sensors]), spot)

    def _follow(self) -> None:
        at = self.shadow[self.world.followed][:, [0, 2]]
        if self.follow_at is not None and np.array_equal(at, self.follow_at):
            return
        self.follow_at = at.copy()
        kind = np.full(self.nf, g.AOI_SPHERE)
        r = np.full(self.nf, self.mix["follower_radius"], np.float32)
        self._rows(0, kind, at[:, 0], at[:, 1], r, np.zeros(self.nf, np.float32))
        self.pending.update(range(self.nf))

    def _diff(self) -> tuple[int, np.ndarray]:
        rows = np.array(sorted(self.pending), np.int64)
        ci, cd = self.cur_i[rows], self.cur_d[rows]
        pi, pd = self.prev_i[rows], self.prev_d[rows]
        changed = (ci != pi) | (ci & (cd != pd))
        flat = np.nonzero(changed.reshape(-1))[0]
        count = flat.size
        shown = flat[: self.rows_max]
        r_loc, c = shown // self.cells, shown % self.cells
        out = np.stack([rows[r_loc], c, np.where(ci[r_loc, c], cd[r_loc, c], -1)], axis=1)
        reported = np.zeros_like(changed)
        reported.reshape(-1)[shown] = True
        keep = changed & ~reported
        self.prev_i[rows] = np.where(keep, pi, ci)
        self.prev_d[rows] = np.where(keep, pd, cd)
        still = keep.any(axis=1)
        self.pending = set(rows[still].tolist())
        return count, out.astype(np.int64)

    def tick(self, t: int) -> dict:
        which = cw.flee_set(self.mix, t)
        if which is not None:
            self.flee[:] = False
            self.flee[self.world.flee[which]] = True
        self._follow()
        idx = self.slots  # the agents fill slots 0..n-1, the whole run
        rows = slice(0, idx.size)
        cols = sim_step(self.grid, self.params, self.pos[rows], self.vel[rows],
                        self.state[rows], self.target[rows], idx, self.flee, self.sim_seed, t)
        pos, vel, state, target = cols
        if self.bf16:
            pos, vel, target = g.bf16(pos), g.bf16(vel), g.bf16(target)
        self.pos[rows], self.vel[rows], self.state[rows], self.target[rows] = (
            pos, vel, state, target)
        cell = g.assign_cells(self.grid, self.pos, self.agent)
        count, rows, self.prev = g.handovers(self.prev, cell, self.max_handovers)
        rows[:, 0] = self.id_of_slot[rows[:, 0]]
        due, self.sub_last = g.fanout_due(cw.now_ms(t), self.sub_last, self.sub_interval,
                                          self.sub_active)
        q_count, q_rows = self._diff()
        out = dict(handover_count=count, handovers=rows,
                   counts=g.cell_counts(cell, self.cells), due=np.nonzero(due)[0],
                   q_count=q_count, q_rows=q_rows)
        if cw.census_due(self.config, t):
            self.shadow[idx] = pos
            out["census"] = (pos, vel, state, target)
        return out


def compare_tick(got: dict, want: dict) -> list:
    diffs = []
    for key in ("handover_count", "q_count"):
        if got[key] != want[key]:
            diffs.append(f"{key} {got[key]} != {want[key]}")
    for key in ("handovers", "counts", "due", "q_rows"):
        if not np.array_equal(np.asarray(got[key], np.int64), np.asarray(want[key], np.int64)):
            diffs.append(f"{key} differ")
    if ("census" in got) != ("census" in want):
        diffs.append("census on one side only")
    return diffs


def census_bits_wrong(got: tuple, want: tuple) -> int:
    """Elements of the four sim columns whose bits differ."""
    wrong = 0
    for a, b in zip(got, want):
        a = np.ascontiguousarray(a)
        b = np.ascontiguousarray(b)
        if a.shape != b.shape or a.itemsize != 4 or b.itemsize != 4:
            return max(a.size, b.size)
        wrong += int(np.count_nonzero(a.view(np.uint32) != b.view(np.uint32)))
    return wrong
