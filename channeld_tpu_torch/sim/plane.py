"""Simulation plane orchestration (doc/simulation.md).

One :class:`SimPlane` per spatial controller. The plane owns the HOST
side of the simulated population: spawn/restore at activation, per-tick
cadence decisions (including the overload ladder's L2 cadence halving),
chaos injection, the census-cadence absorb/journal/commit pass, and the
danger-zone sensor that drives the FLEE behavior from the standing-query
plane. The DEVICE side — steering, behavior FSM, integration — lives in
:func:`channeld_tpu.ops.spatial_ops.sim_step` and runs inside the
engine's guarded tick; the plane never reads device arrays outside the
census cadence.

Threading (doc/concurrency.md): every method except the module-level
WAL-replay rendezvous runs on the GLOBAL tick loop, the same domain as
the controller that calls it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..chaos.injector import chaos as _chaos
from ..core import metrics
from ..core.overload import governor as _governor
from ..core.settings import global_settings
from ..core.wal import wal as _wal
from ..ops.spatial_ops import SimParams
from ..spatial.controller import SpatialInfo
from ..utils.logger import get_logger
from .authority import SimAuthority

logger = get_logger("sim.plane")

# Agent entity ids live far above the interactive entity range so a
# spawned population can never collide with client-created entities
# (ids are uint32 channel ids; 4M of headroom each way).
AGENT_ID_OFFSET = 1 << 22

# WAL-replay rendezvous: boot replay runs BEFORE the spatial controller
# loads, so a replayed census is staged here and consumed by
# ``SimPlane.activate()``. Written by the boot thread before the tick
# loop exists, read once at controller load — never concurrent.
_pending_census: Optional[dict] = None


def restore_census(rec, source: str = "wal replay") -> int:
    """Stage a journaled census (a ``sim_census`` WalRecord) for the
    plane to consume at activation. Returns the agent count staged (0 =
    empty record, nothing staged). Last record wins — replay calls this
    once with the final census."""
    global _pending_census
    n = len(rec.simAgentIds)
    if n == 0:
        return 0
    _pending_census = {
        "tick": int(rec.simTick),
        "seed": int(rec.simSeed),
        "ids": np.asarray(rec.simAgentIds, np.uint32),
        "pos": np.asarray(rec.simAgentPos, np.float32).reshape(n, 3),
        "vel": np.asarray(rec.simAgentVel, np.float32).reshape(n, 3),
        "state": np.asarray(rec.simAgentState, np.int32),
        "target": np.asarray(rec.simAgentTarget, np.float32).reshape(n, 3),
        "source": source,
    }
    logger.info(
        "sim census staged from %s: %d agents at sim tick %d",
        source, n, _pending_census["tick"],
    )
    return n


def consume_pending_census() -> Optional[dict]:
    global _pending_census
    c = _pending_census
    _pending_census = None
    return c


def reset_sim() -> None:
    """Test isolation hook (tests/conftest.py): drop any staged census."""
    global _pending_census
    _pending_census = None


def _params_from_settings() -> SimParams:
    s = global_settings
    return SimParams(
        dt=float(s.sim_step_dt),
        max_speed=float(s.sim_max_speed),
        accel=float(s.sim_accel),
        separation=float(s.sim_separation),
        cohesion=float(s.sim_cohesion),
        arrive_radius=float(s.sim_arrive_radius),
        crowd=int(s.sim_crowd),
        p_wander=float(s.sim_p_wander),
        p_seek=float(s.sim_p_seek),
        p_idle=float(s.sim_p_idle),
    )


class SimPlane:
    """Host orchestration for the on-device agent population."""

    def __init__(self, controller, engine):
        self.controller = controller
        self.engine = engine
        self.authority = SimAuthority(controller)
        self._tick = 0            # controller ticks seen (cadence base)
        self._since_census = 0    # scheduled sim passes since last census
        self._sim_skip = False    # L2+ cadence-halving flip-flop
        self._last_sim_tick = 0   # for the committed-pass counter
        self._danger_key: Optional[int] = None
        # Double-entry ledgers (scripts/sim_soak.py asserts these match
        # the prometheus side exactly).
        self.ledgers: dict[str, int] = {}

    # ---- lifecycle -------------------------------------------------------

    def activate(self) -> None:
        """Spawn the population (or restore a WAL-replayed census) and
        pre-compile the sim kernel. Called once from the controller's
        ``load_config``, after the engine exists, before listeners open."""
        eng = self.engine
        params = _params_from_settings()
        pending = consume_pending_census()
        if pending is not None:
            entries = [
                (int(eid), float(p[0]), float(p[1]), float(p[2]))
                for eid, p in zip(pending["ids"], pending["pos"])
            ]
            eng.seed_agents(
                entries, pending["seed"], params,
                vels=pending["vel"], states=pending["state"],
                targets=pending["target"],
            )
            eng.sim_tick = pending["tick"]
            self._last_sim_tick = pending["tick"]
            self._count("agents_restored", len(entries))
            logger.info(
                "sim population restored from %s: %d agents, resuming at "
                "sim tick %d (seed %d)", pending["source"], len(entries),
                pending["tick"], pending["seed"],
            )
        else:
            entries = self._fresh_entries()
            eng.seed_agents(entries, global_settings.sim_seed, params)
            self._count("agents_spawned", len(entries))
            logger.info(
                "sim population spawned: %d agents (seed %d)",
                len(entries), global_settings.sim_seed,
            )
        # Controller bookkeeping: placement ledger + last-position rows
        # so rebuild seeding and partition-split sorting see agents like
        # any tracked entity. (track_entity's add_entity is an upsert
        # onto the slot seed_agents already claimed.)
        for eid, x, y, z in entries:
            self.controller.track_entity(eid, SpatialInfo(x, y, z))
        self.authority.adopt(eid for eid, *_ in entries)
        eng.sim_warmup()  # compile OUTSIDE the guarded window (watchdog)
        metrics.sim_agents_num.set(eng.agent_count())

    def _fresh_entries(self) -> list[tuple[int, float, float, float]]:
        """Seeded-uniform spawn positions over the world interior. Host
        numpy RNG, distinct from the device's counter-based stream —
        spawn layout replays from sim_seed alone."""
        ctl = self.controller
        rng = np.random.default_rng(global_settings.sim_seed)
        n = int(global_settings.sim_agents)
        x0 = ctl.world_offset_x + 1.0
        z0 = ctl.world_offset_z + 1.0
        x1 = ctl.world_offset_x + ctl.grid_width * ctl.grid_cols - 1.0
        z1 = ctl.world_offset_z + ctl.grid_height * ctl.grid_rows - 1.0
        xs = rng.uniform(x0, x1, n)
        zs = rng.uniform(z0, z1, n)
        base = global_settings.entity_channel_id_start + AGENT_ID_OFFSET
        return [
            (base + i, float(xs[i]), 0.0, float(zs[i])) for i in range(n)
        ]

    # ---- per-tick hooks (GLOBAL tick loop) -------------------------------

    def pre_step(self) -> None:
        """Cadence + chaos decisions for the tick about to run. Sets the
        engine's ``run_sim_pass`` / ``sim_census_due`` flags; the device
        work itself happens inside the guarded step."""
        eng = self.engine
        if not eng.sim_enabled:
            return
        if _chaos.armed:
            if _chaos.fire("sim.step_nan"):
                eng.corrupt_sim_state_for_chaos()
                self._count("chaos_nan", 1)
            if _chaos.fire("sim.stampede"):
                g = eng.grid
                cell = (g.rows // 2) * g.cols + g.cols // 2
                eng.sim_stampede(cell)
                self._count("chaos_stampede", 1)
        self.authority.pump()
        self._tick += 1
        run = self._tick % max(1, global_settings.sim_step_every_ticks) == 0
        if run and _governor.level >= 2:
            # L2+: the population holds still every other scheduled pass
            # — sim cadence halves BEFORE human traffic degrades
            # (doc/overload.md ladder; same alternating-flag shape as
            # the query plane's apply deferral).
            if not self._sim_skip:
                self._sim_skip = True
                n = eng.agent_count()
                if n:
                    # An empty population sheds nothing — a zero count
                    # would still create the ledger key and break the
                    # soaks' exact shed accounting.
                    _governor.count_shed("sim_cadence_defer", n)
                run = False
            else:
                self._sim_skip = False
        elif _governor.level < 2:
            self._sim_skip = False
        if run:
            self._since_census += 1
        eng.run_sim_pass = run
        eng.sim_census_due = (
            run and self._since_census
            >= max(1, global_settings.sim_census_every_ticks)
        )

    def on_result(self, result: dict) -> None:
        """Post-step absorb: count committed passes; on a census tick,
        fold the fetched kinematic columns into the host shadow, journal
        them, and commit through the authority's channel path. The
        census arrays arrive as numpy under the device guard (prefetched
        inside the supervised window) or as tensors from a bare
        ``engine.tick()``, read here with one copy per column."""
        eng = self.engine
        if not eng.sim_enabled:
            return
        advanced = eng.sim_tick - self._last_sim_tick
        if advanced > 0:
            metrics.sim_ticks.inc(advanced)
            self._count("sim_passes", advanced)
        self._last_sim_tick = eng.sim_tick
        census = result.get("sim_census")
        if census is None:
            return
        t0 = time.monotonic()
        pos, vel, state, target = (
            # tpulint: disable=hot-readback -- census-cadence batched fetch (the sim plane's ONLY readback, doc/simulation.md); a no-op under the guard, which pre-fetched the columns
            a if isinstance(a, np.ndarray) else a.cpu().numpy()
            for a in census
        )
        slots = eng.agent_slots()
        eng.absorb_census(slots, pos, vel, state, target)
        ids = eng.agent_ids(slots)
        self._since_census = 0
        metrics.sim_census_transfers.inc()
        self._count("census_transfers", 1)
        sim_tick = int(result.get("sim_tick", eng.sim_tick))
        if _wal.enabled:
            _wal.log_sim_census(
                sim_tick, eng.sim_seed, ids, pos[slots], vel[slots],
                state[slots], target[slots],
            )
            self._count("censuses_journaled", 1)
        # Refresh last-known positions for EVERY agent (engine-only
        # agents have no channel path to do it); the authority commit
        # below re-walks channel-backed ones through the ordinary
        # update path, which keeps the same rows authoritative. The
        # arrays are host numpy at this point — tolist() shapes, it
        # does not transfer.
        ctl = self.controller
        agent_pos = pos[slots].tolist()
        for i, eid in enumerate(ids):
            px, py, pz = agent_pos[i]
            ctl._last_positions[int(eid)] = SpatialInfo(px, py, pz)
        committed = self.authority.commit(ids, agent_pos)
        self._count("census_commits", committed)
        metrics.sim_agents_num.set(eng.agent_count())
        metrics.sim_pass_ms.observe((time.monotonic() - t0) * 1000.0)

    # ---- federation ride-along (federation/plane.py) ---------------------

    def on_agents_adopted(self, ids) -> int:
        """Agents adopted from a peer shard rejoin THIS gateway's
        population: ids in the reserved agent range are re-flagged as
        agents on their already-tracked slots. Kinematics are not
        shipped in the handover payload — adopted agents restart IDLE
        at their adopted position and the local counter-based stream
        takes over (doc/simulation.md)."""
        eng = self.engine
        if not eng.sim_enabled or eng.sim_params is None:
            return 0
        base = global_settings.entity_channel_id_start + AGENT_ID_OFFSET
        entries = []
        for eid in ids:
            eid = int(eid)
            if eid < base or eng.is_agent(eid):
                continue
            info = self.controller._last_positions.get(eid)
            if info is None:
                continue
            entries.append((eid, float(info.x), float(info.y),
                            float(info.z)))
        if not entries:
            return 0
        eng.seed_agents(entries, eng.sim_seed, eng.sim_params)
        for eid, *_ in entries:
            self.authority._backed.add(eid)
        self._count("agents_adopted", len(entries))
        metrics.sim_agents_num.set(eng.agent_count())
        return len(entries)

    def on_agents_departed(self, ids) -> int:
        """Agents committed to a peer shard leave the population (the
        channel teardown untracks them; the agent flag clears with the
        slot) — this hook only keeps the double-entry census ledgers
        and the population gauge exact."""
        eng = self.engine
        n = sum(1 for eid in ids if eng.is_agent(int(eid)))
        if n:
            self._count("agents_departed", n)
            for eid in ids:
                self.authority._backed.discard(int(eid))
        metrics.sim_agents_num.set(max(0, eng.agent_count() - n))
        return n

    # ---- danger zone: FLEE driven by the standing-query plane ------------

    def set_danger_zone(self, center, radius: float) -> Optional[int]:
        """Register a standing danger sensor; agents FLEE any cell the
        sensor's interest set covers. Returns the sensor key, or None
        when the query plane is off/full (no danger = no fleeing)."""
        if self._danger_key is not None:
            self.clear_danger_zone()
        key = self.controller.register_sensor(
            "sim.danger", center=tuple(center),
            extent=(float(radius), float(radius)),
            callback=self._on_danger_cells,
        )
        self._danger_key = key
        if key is not None:
            self._count("danger_zones", 1)
        return key

    def clear_danger_zone(self) -> None:
        qp = self.controller.queryplane
        if self._danger_key is not None and qp is not None:
            qp.deregister(self._danger_key)
        self._danger_key = None
        self.engine.set_flee_cells(())

    def _on_danger_cells(self, key: int, cells: dict) -> None:
        """Sensor callback ({leaf_channel: dist}): rasterize the hit
        leaves to micro cells and install the FLEE mask."""
        self.engine.set_flee_cells(self._micro_cells(cells))

    def _micro_cells(self, cells: dict) -> list[int]:
        ctl = self.controller
        hit = set(cells)
        if ctl._micro_leaf is None:
            start = global_settings.spatial_channel_id_start
            return [ch - start for ch in hit]
        return [m for m, leaf in enumerate(ctl._micro_leaf) if leaf in hit]

    def on_geometry(self) -> None:
        """A geometry epoch committed: the leaf->micro mapping changed
        (even at unchanged micro dims), so the FLEE mask must be
        re-rasterized from the sensor's current interest set."""
        if self._danger_key is None:
            return
        qp = self.controller.queryplane
        cells = qp.sensor_cells(self._danger_key) if qp is not None else {}
        self.engine.set_flee_cells(self._micro_cells(cells))

    # ---- accounting ------------------------------------------------------

    def _count(self, key: str, n: int) -> None:
        self.ledgers[key] = self.ledgers.get(key, 0) + n

    def report(self) -> dict:
        """Soak/bench artifact block (double-entry vs prometheus)."""
        return {
            "ledgers": dict(self.ledgers),
            "agents": self.engine.agent_count(),
            "sim_tick": self.engine.sim_tick,
            "rebuilds": dict(self.engine.sim_rebuild_counts),
            "authority": self.authority.report(),
        }
