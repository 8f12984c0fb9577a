"""Live spatial load balancer: planned, zero-loss cell migration.

The grid assignment used to be static for a server's whole lifetime:
cells moved only when their owner DIED (core/failover.py re-host), and
the overload governor (core/overload.py) could only shed a hot server's
load, never move it to an idle peer — one crowded cell pinned one
server at L2/L3 while its neighbors idled. This plane makes the
multi-server grid *elastic*, in the continuous-repartitioning tradition
of streaming spatial systems (PAPERS.md: CheetahGIS's load-aware
partition re-balancing) using the planned, transactional state-movement
discipline of live-replica migration (Spider): cells migrate between
LIVE servers, on purpose, with zero entity loss.

Runs inside the GLOBAL channel tick (the same single-writer context as
handover orchestration and failover), once per tick:

1. **Load fold** — per server: resident entities per owned cell
   (authoritative channel data), crossing rate (fed by
   ``grid._orchestrate_pair``), fan-out bytes (fed by
   ``data.fan_out_data_update``) and the server's exported overload
   pressure (``governor.server_pressure_of``). Imbalance = max/mean.
2. **Hysteresis + budget + cooldown** — a migration is planned only
   after the imbalance held above the enter threshold for
   ``balancer_hold_ticks`` consecutive updates, at most
   ``balancer_budget_per_epoch`` commits per epoch, never for a cell
   inside its post-migration cooldown, and NEVER while the overload
   ladder sits at L2+ (shedding outranks rebalancing).
3. **The migration transaction** — hottest cell on the most loaded
   server, destination by the same entity-weighted
   ``placement_score()`` failover uses:

   * *prepare* — freeze crossings into/out of the cell (detected
     crossings defer, chains collapse to one pending move per entity);
   * *drain* — wait until no handover-journal record touches the cell
     (the journal serializes migration against in-flight handovers),
     bounded by ``balancer_drain_deadline_ticks``;
   * *flip* — atomically (within the GLOBAL tick) re-own the cell and
     its resident entity channels to the destination, bootstrap the new
     owner with packed authoritative state in a ``CellMigratedMessage``
     (msgType 26), re-seed the ``_data_cell`` placement ledger, force a
     full-state resync for every other subscriber;
   * *commit/abort* — commit unfreezes and replays deferred crossings;
     any failure before the flip (destination died, drain timeout,
     overload escalation, ownership changed under us) aborts with a
     deterministic rollback: the old owner simply keeps the cell,
     nothing moved, crossings unfreeze and replay.

Every terminal result is counted twice on purpose — the
``balancer_migrations_total{result}`` counter AND a python-side ledger
— so the skew soak (``scripts/balance_soak.py``) proves the accounting
exact. Operator knobs + the interaction matrix with overload/failover:
doc/balancer.md.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ..core.overload import OverloadLevel, governor as _governor
from ..core.settings import global_settings
from ..core.types import ChannelDataAccess, ConnectionType, MessageType
from ..utils.logger import get_logger

logger = get_logger("balancer")

# Migration phases.
DRAINING = "draining"
COMMITTED = "committed"
ABORTED = "aborted"


@dataclass
class CellMigration:
    migration_id: int
    cell_id: int
    src_conn: object
    dst_conn: object
    planned_tick: int
    epoch: int
    state: str = DRAINING
    t0: float = field(default_factory=time.monotonic)


class BalancerPlane:
    """One instance (``balancer``); (re-)installed by ``init_channels``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._tick = 0
        self._epoch = 0
        self._epoch_started = 0
        self._epoch_committed = 0
        self._hold = 0  # consecutive over-enter-threshold updates
        self._armed = False  # hysteresis latch (enter/exit are apart)
        self._migration: Optional[CellMigration] = None
        self._migration_seq = 0
        self.frozen_cells: frozenset = frozenset()
        # entity id -> (old_info, new_info, provider): crossings deferred
        # while their src/dst cell is frozen (host-notify path; the TPU
        # tick keeps frozen crossings in its own deferred map).
        self._frozen_crossings: dict[int, tuple] = {}
        # cell id -> tick until which it may not migrate again.
        self._cooldown: dict[int, int] = {}
        # Crossing/byte accumulators since the last update (cleared each
        # fold into the EWMAs below).
        self._crossings_acc: dict[int, int] = {}
        self._bytes_acc: dict[int, int] = {}
        self._cell_crossing_rate: dict[int, float] = {}
        self._cell_byte_rate: dict[int, float] = {}
        self.imbalance = 0.0
        # Python-side result ledger; must match balancer_migrations_total.
        self.ledger: dict[str, int] = {}
        self.events: list[dict] = []  # one record per terminal migration
        self._gauge_cells: set[int] = set()  # cells with a published gauge

    # ---- install ---------------------------------------------------------

    def install(self) -> None:
        """Listen for server registrations: a new spatial server adopts
        any permanently-ownerless cells (the cells_unrehostable orphans
        a total loss left behind) through the placement path."""
        from ..core import events

        events.auth_complete.unlisten_for(self)
        events.auth_complete.listen_for(self, self._on_server_registered)

    # ---- signal intake (hot paths; keep them cheap) ----------------------

    def note_crossing(self, src_channel_id: int, dst_channel_id: int,
                      n: int) -> None:
        if not global_settings.balancer_enabled:
            return  # nothing drains the accumulators while disabled
        acc = self._crossings_acc
        acc[src_channel_id] = acc.get(src_channel_id, 0) + n
        acc[dst_channel_id] = acc.get(dst_channel_id, 0) + n

    def note_fanout_bytes(self, channel_id: int, nbytes: int) -> None:
        if not global_settings.balancer_enabled:
            return
        acc = self._bytes_acc
        acc[channel_id] = acc.get(channel_id, 0) + nbytes

    # ---- crossing freeze (consulted by grid.notify / the TPU tick) -------

    def defer_crossing(self, entity_id: int, old_info, new_info,
                       provider) -> bool:
        """Host-notify path: park a crossing touching a frozen cell.
        Chained moves collapse to one pending entry per entity (old_info
        stays pinned to where the data lives; new_info follows)."""
        prev = self._frozen_crossings.get(entity_id)
        if prev is not None:
            self._frozen_crossings[entity_id] = (prev[0], new_info, provider)
        else:
            self._frozen_crossings[entity_id] = (old_info, new_info, provider)
        return True

    def _unfreeze(self, ctl) -> None:
        self.frozen_cells = frozenset()
        backlog = list(self._frozen_crossings.values())
        self._frozen_crossings.clear()
        if not backlog or ctl is None:
            return
        # Replay through the batched orchestration (chains already
        # collapsed per entity; the TPU tick's own deferred map replays
        # itself next tick once the freeze is lifted).
        from .grid import StaticGrid2DSpatialController

        StaticGrid2DSpatialController.notify_crossings(ctl, backlog)

    # ---- the per-GLOBAL-tick update --------------------------------------

    def update(self, ctl) -> None:
        self._tick += 1
        st = global_settings
        if self._tick - self._epoch_started >= st.balancer_epoch_ticks:
            self._epoch += 1
            self._epoch_started = self._tick
            self._epoch_committed = 0
        if self._migration is not None:
            self._advance(ctl)
            return
        if not st.balancer_enabled:
            # Drop any signal accumulated before the disable landed —
            # re-enabling must start from a clean fold, not replay a
            # backlog as one tick's "rate".
            if self._crossings_acc or self._bytes_acc:
                self._crossings_acc.clear()
                self._bytes_acc.clear()
            return
        loads, cell_stats = self._collect(ctl)
        if len(loads) < 2:
            self._hold = 0
            return
        entity_loads = [row[1] for row in loads.values()]
        if max(entity_loads) - min(entity_loads) < st.balancer_min_entity_delta:
            # World too small/even to be worth moving authority around.
            self._hold = 0
            self._armed = False
            return
        scores = {c: row[3] for c, row in loads.items()}
        mean = sum(scores.values()) / len(scores)
        self.imbalance = (max(scores.values()) / mean) if mean > 0 else 0.0
        from ..core import metrics

        metrics.balancer_imbalance.set(self.imbalance)
        if self._armed:
            if self.imbalance < st.balancer_imbalance_exit:
                self._armed = False
                self._hold = 0
                return
        elif self.imbalance >= st.balancer_imbalance_enter:
            self._hold += 1
            if self._hold >= st.balancer_hold_ticks:
                self._armed = True
        else:
            self._hold = 0
            return
        if not self._armed:
            return
        if self._epoch_committed >= st.balancer_budget_per_epoch:
            return  # budget spent; re-plan next epoch
        self._plan(ctl, loads, cell_stats)

    # ---- load fold -------------------------------------------------------

    def _collect(self, ctl):
        """(loads, cell_stats): loads = conn -> [cells, entities,
        pressure, score]; cell_stats = cell id -> (owner, entities,
        crossing_rate). Also publishes the per-cell entity gauge and
        folds the crossing/byte accumulators into their EWMAs."""
        from ..core import metrics
        from ..core.channel import all_channels
        from ..core.failover import entity_count_of

        st = global_settings
        alpha = st.overload_alpha
        cross_rate = self._cell_crossing_rate
        byte_rate = self._cell_byte_rate
        cacc, bacc = self._crossings_acc, self._bytes_acc
        lo = st.spatial_channel_id_start
        hi = st.entity_channel_id_start

        loads: dict = {}
        cell_stats: dict[int, tuple] = {}
        seen_cells: set[int] = set()
        for cid, ch in all_channels().items():
            if not (lo <= cid < hi) or ch.is_removing():
                continue
            seen_cells.add(cid)
            ents = entity_count_of(ch)
            cr = alpha * cacc.pop(cid, 0) + (1 - alpha) * cross_rate.get(cid, 0.0)
            br = alpha * bacc.pop(cid, 0) + (1 - alpha) * byte_rate.get(cid, 0.0)
            if cr > 1e-3:
                cross_rate[cid] = cr
            else:
                cross_rate.pop(cid, None)
            if br > 1.0:
                byte_rate[cid] = br
            else:
                byte_rate.pop(cid, None)
            metrics.spatial_cell_entities.labels(cell=str(cid)).set(ents)
            self._gauge_cells.add(cid)
            if not ch.has_owner():
                continue
            owner = ch.get_owner()
            cell_stats[cid] = (owner, ents, cr)
            row = loads.setdefault(owner, [0, 0, 0.0, 0.0])
            row[0] += 1
            row[1] += ents
            row[3] += (
                ents
                + cr * st.balancer_crossing_weight
                + (br / 1024.0) * st.balancer_bytes_weight
            )
        # Accumulator keys for vanished cells must not leak.
        cacc.clear()
        bacc.clear()
        for cid in self._gauge_cells - seen_cells:
            metrics.spatial_cell_entities.labels(cell=str(cid)).set(0)
        self._gauge_cells &= seen_cells
        for owner, row in loads.items():
            row[2] = _governor.server_pressure_of(owner.id)
            row[3] += row[2] * st.balancer_pressure_weight
        return loads, cell_stats

    # ---- planning --------------------------------------------------------

    def _plan(self, ctl, loads, cell_stats) -> None:
        st = global_settings
        if self.frozen_cells:
            # Another plane (the adaptive-partitioning transaction,
            # doc/partitioning.md) holds the crossing freeze: planning a
            # migration now would clobber its frozen set on commit.
            # Transient — re-plan once the geometry op resolves.
            return
        if _governor.level >= OverloadLevel.L2:
            # Never fight the overload ladder: shedding outranks
            # rebalancing, and a migration is extra load by definition.
            self._count("vetoed")
            self._hold = 0
            logger.warning(
                "migration vetoed: overload ladder at L%d", _governor.level
            )
            return
        hottest = max(loads, key=lambda c: loads[c][3])
        candidates = []
        for cid, (owner, ents, cr) in cell_stats.items():
            if owner is not hottest or ents <= 0:
                continue
            if self._cooldown.get(cid, 0) > self._tick:
                continue
            if loads[hottest][0] <= 1:
                continue  # never strip a server of its last cell
            candidates.append((ents + cr * st.balancer_crossing_weight, cid))
        if not candidates:
            return
        cell_score, cell_id = max(candidates)

        from ..core.failover import pick_placement

        dest_loads = {
            c: row[:2]
            for c, row in loads.items()
            if c is not hottest
            and not c.is_closing()
            and row[2] < st.balancer_dest_pressure_max
        }
        if not dest_loads:
            self._count("vetoed")
            self._hold = 0
            logger.warning(
                "migration of cell %d vetoed: every destination at/above "
                "pressure %.2f", cell_id, st.balancer_dest_pressure_max,
            )
            return
        dst = pick_placement(dest_loads)
        # The move must actually flatten the fold: if the post-move
        # worst of (shrunken src, grown dst) is no better than the src
        # today, migrating just relocates the hotspot (the classic
        # one-giant-cell case — no destination can absorb it).
        src_score = loads[hottest][3]
        if max(src_score - cell_score, loads[dst][3] + cell_score) >= src_score:
            return
        self._migration_seq += 1
        self._migration = CellMigration(
            migration_id=self._migration_seq,
            cell_id=cell_id,
            src_conn=hottest,
            dst_conn=dst,
            planned_tick=self._tick,
            epoch=self._epoch,
        )
        self.frozen_cells = frozenset((cell_id,))
        self._count("planned")
        logger.info(
            "migration %d planned: cell %d, server %d -> %d (imbalance "
            "%.2f); crossings frozen, draining journal",
            self._migration_seq, cell_id, hottest.id, dst.id, self.imbalance,
        )

    def plan_directed(self, cell_id: int, dst_conn, reason: str = "") -> bool:
        """Directed migration on behalf of another control plane — the
        adaptive-partitioning governor reuniting a cold sibling group's
        diverged owners before a merge (doc/partitioning.md). The SAME
        transaction (freeze -> drain -> flip, same ledger/metric) with
        the candidate/hysteresis/cooldown policy left to the caller;
        only the hard safety guards stay: one migration at a time, no
        clobbering a held crossing freeze, never at overload L2+, never
        to a dead or identical destination. Advances even while
        autonomous balancing is disabled (``update`` drains an in-flight
        migration before consulting ``balancer_enabled``)."""
        from ..core.channel import get_channel

        if self._migration is not None or self.frozen_cells:
            return False
        if _governor.level >= OverloadLevel.L2:
            return False
        ch = get_channel(cell_id)
        if ch is None or ch.is_removing() or not ch.has_owner():
            return False
        src = ch.get_owner()
        if dst_conn is None or dst_conn is src or dst_conn.is_closing():
            return False
        self._migration_seq += 1
        self._migration = CellMigration(
            migration_id=self._migration_seq,
            cell_id=cell_id,
            src_conn=src,
            dst_conn=dst_conn,
            planned_tick=self._tick,
            epoch=self._epoch,
        )
        self.frozen_cells = frozenset((cell_id,))
        self._count("planned")
        logger.info(
            "migration %d planned (directed%s): cell %d, server %d -> %d; "
            "crossings frozen, draining journal",
            self._migration_seq, f": {reason}" if reason else "",
            cell_id, src.id, dst_conn.id,
        )
        return True

    # ---- the in-flight transaction ---------------------------------------

    def _advance(self, ctl) -> None:
        from ..core.channel import get_channel
        from ..core.failover import journal

        st = global_settings
        mig = self._migration
        ch = get_channel(mig.cell_id)
        if ch is None or ch.is_removing():
            self._abort(ctl, mig, "cell_removed")
            return
        if ch.get_owner() is not mig.src_conn:
            # Failover (or anything else) re-owned the cell under us:
            # the world changed, the plan is void.
            self._abort(ctl, mig, "owner_changed")
            return
        if mig.dst_conn.is_closing():
            self._abort(ctl, mig, "dst_dead")
            return
        if _governor.level >= OverloadLevel.L2:
            self._abort(ctl, mig, "overload")
            return
        age = self._tick - mig.planned_tick
        if journal.in_flight_touching(mig.cell_id):
            if age > st.balancer_drain_deadline_ticks:
                self._abort(ctl, mig, "drain_timeout")
            return  # keep draining
        if age < st.balancer_freeze_min_ticks:
            return  # queued entity hops on the cell channel still run
        self._execute(ctl, mig, ch)

    def _abort(self, ctl, mig: CellMigration, reason: str) -> None:
        """Deterministic rollback: nothing has moved before the flip, so
        the old owner simply keeps the cell; unfreeze and replay."""
        mig.state = ABORTED
        self._migration = None
        self._unfreeze(ctl)
        # A short lockout so the same plan doesn't re-arm next tick into
        # the same failure.
        self._cooldown[mig.cell_id] = (
            self._tick + global_settings.balancer_hold_ticks * 4
        )
        self._count("aborted")
        elapsed_ms = (time.monotonic() - mig.t0) * 1000.0
        from ..core import metrics
        from ..core.channel import get_channel

        metrics.balancer_migration_ms.observe(elapsed_ms)
        ev = self._event(mig, reason, elapsed_ms)
        # The rollback property, captured AT resolution (the cell may
        # legitimately re-plan and move moments later — soaks must not
        # race that): the old owner still holds the cell.
        ch = get_channel(mig.cell_id)
        ev["owner_rolled_back"] = (
            ch is not None and ch.get_owner() is mig.src_conn
        )
        self.events.append(ev)
        from ..core.tracing import recorder as _trace

        if _trace.enabled:
            _trace.note_anomaly(
                "migration_abort",
                f"migration {mig.migration_id} cell {mig.cell_id}: {reason}",
            )
        logger.warning(
            "migration %d aborted (%s): cell %d stays with server %d",
            mig.migration_id, reason, mig.cell_id, mig.src_conn.id,
        )

    def _execute(self, ctl, mig: CellMigration, ch) -> None:
        """The flip: runs start-to-finish inside this GLOBAL tick."""
        from ..core import metrics
        from ..core.channel import get_channel
        from ..core.failover import plane as _failover_plane
        from ..core.subscription import subscribe_to_channel
        from ..core.subscription_messages import send_subscribed
        from ..protocol import control_pb2, spatial_pb2

        src, dst = mig.src_conn, mig.dst_conn
        prev_owner_id = src.id

        # New owner: WRITE subscription; the authoritative bootstrap
        # rides the CellMigratedMessage, so the usual first full-state
        # fan-out would be redundant bytes.
        ch.set_owner(dst)
        opts = control_pb2.ChannelSubscriptionOptions(
            dataAccess=ChannelDataAccess.WRITE_ACCESS,
            skipSelfUpdateFanOut=True,
            skipFirstFanOut=True,
        )
        cs, should_send = subscribe_to_channel(dst, ch, opts)
        if should_send and cs is not None:
            send_subscribed(dst, ch, dst, 0, cs.options)
        # Old owner: downgrade to observer (it usually keeps border
        # interest in the cell); authority checks key off get_owner().
        old_sub = ch.subscribed_connections.get(src)
        if old_sub is not None:
            old_sub.options.dataAccess = ChannelDataAccess.READ_ACCESS

        # Resident entity channels move authority with the cell.
        entity_ids = []
        ents = getattr(ch.get_data_message(), "entities", None)
        if ents is not None:
            for eid in sorted(ents):
                ech = get_channel(eid)
                if ech is None or ech.is_removing():
                    continue
                if ech.get_owner() is src or not ech.has_owner():
                    _failover_plane._repoint_entity(ech, dst)
                    entity_ids.append(eid)

        from ..core.failover import announce_authority_change

        announce_authority_change(
            ch, dst, MessageType.CELL_MIGRATED,
            lambda c, eids=list(entity_ids), mid=mig.migration_id:
                spatial_pb2.CellMigratedMessage(
                    channelId=c.id,
                    prevOwnerConnId=prev_owner_id,
                    newOwnerConnId=dst.id,
                    entityIds=eids,
                    migrationId=mid,
                ),
        )
        # Placement-ledger re-seed (same hook failover uses): entities
        # resident in the cell keep exactly one authoritative row.
        hook = getattr(ctl, "on_cell_rehosted", None)
        if hook is not None:
            hook(ch.id, dst)

        mig.state = COMMITTED
        self._migration = None
        self._unfreeze(ctl)
        self._cooldown[mig.cell_id] = (
            self._tick + global_settings.balancer_cooldown_ticks
        )
        self._epoch_committed += 1
        self._count("committed")
        elapsed_ms = (time.monotonic() - mig.t0) * 1000.0
        metrics.balancer_migration_ms.observe(elapsed_ms)
        ev = self._event(mig, "committed", elapsed_ms)
        ev["entities_repointed"] = len(entity_ids)
        self.events.append(ev)
        logger.info(
            "migration %d committed: cell %d, server %d -> %d (%d entity "
            "channels re-pointed, %.1fms)",
            mig.migration_id, mig.cell_id, prev_owner_id, dst.id,
            len(entity_ids), elapsed_ms,
        )

    # ---- orphan adoption on server registration --------------------------

    def _on_server_registered(self, data) -> None:
        """cells_unrehostable fix: a server registering AFTER a total
        loss adopts the permanently-ownerless cells through the same
        placement path migrations use."""
        conn = data.connection
        if conn.connection_type != ConnectionType.SERVER:
            return
        # auth_complete fires for every auth RESULT; only a connection
        # that actually authenticated may adopt authority (a failed-auth
        # server conn would otherwise own cells it can never serve).
        from ..core.types import ConnectionState

        if getattr(conn, "state", None) != ConnectionState.AUTHENTICATED:
            return
        if not global_settings.failover_enabled:
            return
        from ..core.channel import get_global_channel

        if not self._ownerless_cells():
            return
        gch = get_global_channel()
        if gch is None or gch.is_removing():
            self._adopt_orphans(conn)
        else:
            gch.execute(lambda _ch, c=conn: self._adopt_orphans(c))

    def _ownerless_cells(self) -> list[int]:
        """PERMANENTLY ownerless spatial cells: no live owner AND no
        stashed recoverable owner subscription (a cell whose owner is
        merely inside its recovery window must never be adopted out from
        under it — recovery restores that ownership)."""
        from ..core.channel import all_channels

        lo = global_settings.spatial_channel_id_start
        hi = global_settings.entity_channel_id_start
        out = []
        for cid, ch in all_channels().items():
            if not (lo <= cid < hi) or ch.is_removing() or ch.has_owner():
                continue
            if any(
                rs.is_owner for rs in ch.recoverable_subs.values()
            ):
                continue
            out.append(cid)
        return sorted(out)

    def _adopt_orphans(self, new_conn) -> None:
        from ..core.channel import all_channels, get_channel
        from ..core.failover import (
            collect_spatial_loads,
            entity_count_of,
            pick_placement,
            plane as _failover_plane,
        )

        if new_conn.is_closing():
            return
        orphans = self._ownerless_cells()
        if not orphans:
            return
        t0 = time.monotonic()
        loads = collect_spatial_loads()
        loads.setdefault(new_conn, [0, 0])
        st = global_settings
        hi = st.entity_channel_id_start
        assignments: dict[int, object] = {}
        for cid in orphans:
            target = pick_placement(loads)
            loads[target][0] += 1
            loads[target][1] += entity_count_of(get_channel(cid))
            assignments[cid] = target
        # Ownerless resident entity channels re-point with their cell.
        repointed: dict[int, list[int]] = {}
        for cid, target in assignments.items():
            ch = get_channel(cid)
            ents = getattr(ch.get_data_message(), "entities", None) or ()
            for eid in sorted(ents):
                ech = get_channel(eid)
                if ech is None or ech.is_removing() or ech.has_owner():
                    continue
                _failover_plane._repoint_entity(ech, target)
                _failover_plane.ledger["entities_repointed"] += 1
                repointed.setdefault(cid, []).append(eid)
        for cid, target in assignments.items():
            _failover_plane._rehost_cell(
                get_channel(cid), target, 0, repointed.get(cid, [])
            )
        elapsed_ms = (time.monotonic() - t0) * 1000.0
        # Keep the failover event stream's accounting exact (soaks check
        # rehost totals against the per-event sums).
        _failover_plane.events.append({
            "pit": getattr(new_conn, "pit", ""),
            "prev_conn_id": 0,
            "reason": "registration_adoption",
            "orphan_cells": orphans,
            "rehosted": {str(c): t.id for c, t in assignments.items()},
            "entities_repointed": sum(len(v) for v in repointed.values()),
            "handovers_aborted": 0,
            "duration_ms": round(elapsed_ms, 3),
        })
        logger.warning(
            "server %d registered with %d ownerless cells pending: "
            "adopted %s (%.1fms)",
            new_conn.id, len(orphans),
            {c: t.id for c, t in assignments.items()}, elapsed_ms,
        )

    # ---- accounting ------------------------------------------------------

    def _count(self, result: str) -> None:
        self.ledger[result] = self.ledger.get(result, 0) + 1
        from ..core import metrics

        metrics.balancer_migrations.labels(result=result).inc()

    def _event(self, mig: CellMigration, result: str,
               elapsed_ms: float) -> dict:
        return {
            "migration_id": mig.migration_id,
            "cell": mig.cell_id,
            "from": mig.src_conn.id,
            "to": mig.dst_conn.id,
            "result": result,
            "epoch": mig.epoch,
            "planned_tick": mig.planned_tick,
            "resolved_tick": self._tick,
            "imbalance": round(self.imbalance, 4),
            "duration_ms": round(elapsed_ms, 3),
        }

    def migration_in_flight(self) -> Optional[CellMigration]:
        return self._migration

    def report(self) -> dict:
        return {
            "ledger": dict(self.ledger),
            "events": list(self.events),
            "imbalance": round(self.imbalance, 4),
            "in_flight": self._migration is not None,
            "frozen_cells": sorted(self.frozen_cells),
            "cooldowns": dict(self._cooldown),
            "epoch": self._epoch,
        }


balancer = BalancerPlane()


def reset_balancer() -> None:
    """Test hook (also run by init_channels at world boot)."""
    balancer.reset()
