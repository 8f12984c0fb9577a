"""Adaptive partitioning plane (doc/partitioning.md).

Live quadtree cell split/merge so extreme density degrades gracefully
instead of melting one server: a density governor — fed by the same
per-cell resident counts the balancer folds — plans splits of hot cells
and merges of cold sibling groups, executed as transactional geometry
epochs riding the existing machinery:

  freeze  -> crossings touching the cell park with the balancer's
             frozen-crossing map (grid.notify / the TPU tick defer);
  drain   -> the handover journal must stop touching the cell
             (``in_flight_touching``), bounded by a drain deadline;
  commit  -> one WAL geometry record (the commit point), the new
             geometry applied (device arrays rebuild generation-fenced),
             child/parent channels created with the same owner, resident
             entities repartitioned through the transactional handover
             journal, authority announced per new cell
             (CellGeometryUpdateMessage: packed-state bootstrap for the
             owner, identifier-only + forced resync for everyone else),
             and the stale cells removed;
  abort   -> nothing has mutated before the WAL record, so the old
             geometry simply stays; unfreeze and replay.

Guard discipline matches the balancer plane: two-sided density
hysteresis (split/merge thresholds kept apart), hold ticks, a per-epoch
budget, per-cell cooldown, a hard veto at overload L2+ (with a forced
``density_hotspot`` flight-recorder dump when a cell is hot but the
split is vetoed), never split past the depth bound, never merge a group
with in-flight residents. Every terminal result is double-entried:
``partition_ops_total{op,result}`` must equal the python ledger here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ..core.overload import OverloadLevel, governor as _governor
from ..core.settings import global_settings
from ..utils.logger import get_logger
from .balancer import balancer as _balancer

logger = get_logger("spatial.partition")

# GeometryOp.state values.
DRAINING = "draining"       # frozen; waiting for the journal to clear
COMMITTING = "committing"   # geometry written; moves/removals queued
COMMITTED = "committed"
ABORTED = "aborted"


@dataclass
class GeometryOp:
    """One in-flight split/merge transaction."""

    op_id: int
    op: str                  # "split" | "merge"
    target: int              # split: the leaf to split; merge: the parent
    cells: tuple             # channels frozen for the op's duration
    planned_tick: int
    epoch: int               # governor epoch the op charges its budget to
    state: str = DRAINING
    t0: float = field(default_factory=time.monotonic)
    committed_tick: int = 0
    moved: int = 0           # entities repartitioned at commit


class PartitionPlane:
    """One instance (``partition``); driven from the grid tick."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._tick = 0
        self._epoch = 0
        self._epoch_started = 0
        self._epoch_committed = 0
        self._op: Optional[GeometryOp] = None
        self._op_seq = 0
        # cell id -> consecutive hot/cold evaluations (two counters so a
        # cell oscillating across one threshold never arms the other).
        self._split_hold: dict[int, int] = {}
        self._merge_hold: dict[int, int] = {}
        # cell id -> tick until which it may not be re-operated on.
        self._cooldown: dict[int, int] = {}
        # Python-side result ledger; must match partition_ops_total.
        self.ledger: dict[str, int] = {}
        self.events: list[dict] = []  # one record per terminal op

    # ---- the per-GLOBAL-tick update --------------------------------------

    def update(self, ctl) -> None:
        self._tick += 1
        st = global_settings
        if self._tick - self._epoch_started >= st.partition_epoch_ticks:
            self._epoch += 1
            self._epoch_started = self._tick
            self._epoch_committed = 0
        if self._op is not None:
            self._advance(ctl)
            return
        if not st.partition_enabled:
            if self._split_hold or self._merge_hold:
                self._split_hold.clear()
                self._merge_hold.clear()
            return
        if getattr(ctl, "tree", None) is None:
            return
        if self._tick % max(1, st.partition_eval_ticks) != 0:
            return
        self._evaluate(ctl)

    # ---- governor evaluation ---------------------------------------------

    def _cell_counts(self, ctl) -> dict[int, int]:
        """Resident entities per live spatial channel (one sweep)."""
        from ..core.channel import all_channels
        from ..core.failover import entity_count_of

        st = global_settings
        lo = st.spatial_channel_id_start
        hi = st.entity_channel_id_start
        return {
            cid: entity_count_of(ch)
            for cid, ch in all_channels().items()
            if lo <= cid < hi and not ch.is_removing()
        }

    def _evaluate(self, ctl) -> None:
        from ..core import metrics
        from ..core.failover import journal as _journal
        from ..federation.directory import directory as _directory

        st = global_settings
        tree = ctl.tree
        counts = self._cell_counts(ctl)
        for cell in counts:
            if tree.is_leaf(cell):
                metrics.spatial_cell_depth.labels(cell=str(cell)).set(
                    tree.depth_of(cell)
                )

        # ---- split arming (hottest first) ----
        hot = sorted(
            (
                (n, cell) for cell, n in counts.items()
                if n >= st.partition_split_entities
                and tree.is_leaf(cell)
                and _directory.is_local_cell(cell)
            ),
            reverse=True,
        )
        armed_split: Optional[int] = None
        hot_cells = {cell for _, cell in hot}
        for cell in list(self._split_hold):
            if cell not in hot_cells:
                del self._split_hold[cell]
        for n, cell in hot:
            held = self._split_hold.get(cell, 0) + 1
            self._split_hold[cell] = held
            if held < st.partition_hold_ticks or armed_split is not None:
                continue
            veto = None
            if tree.depth_of(cell) >= st.partition_max_depth:
                veto = f"depth bound {st.partition_max_depth}"
            elif _governor.level >= OverloadLevel.L2:
                veto = f"overload ladder at L{_governor.level}"
            elif any(not _directory.is_local_cell(c)
                     for c in tree.children(cell)):
                # A directory override redirects the parent but not its
                # would-be children (overrides are per-cell-id): a split
                # would scatter the cell across gateways.
                veto = "children not locally mapped"
            if veto is not None:
                self._split_hold[cell] = 0
                self._count("split", "vetoed")
                self._hotspot(cell, n, veto)
                continue
            if self._cooldown.get(cell, 0) > self._tick:
                continue
            armed_split = cell

        if armed_split is not None and self._may_transact():
            self._plan_split(ctl, armed_split)
            return

        # ---- merge arming (coldest sibling group first) ----
        cold: list[tuple[int, int]] = []
        for parent in tree.splits:
            children = tree.children(parent)
            if any(c in tree.splits for c in children):
                continue  # only a fully-leaf sibling group merges
            if not all(_directory.is_local_cell(c) for c in children):
                continue
            if not _directory.is_local_cell(parent):
                continue
            total = sum(counts.get(c, 0) for c in children)
            if total <= st.partition_merge_entities:
                cold.append((total, parent))
        cold_parents = {p for _, p in cold}
        for parent in list(self._merge_hold):
            if parent not in cold_parents:
                del self._merge_hold[parent]
        armed_merge: Optional[int] = None
        for total, parent in sorted(cold):
            held = self._merge_hold.get(parent, 0) + 1
            self._merge_hold[parent] = held
            if held < st.partition_hold_ticks or armed_merge is not None:
                continue
            if _governor.level >= OverloadLevel.L2:
                self._merge_hold[parent] = 0
                self._count("merge", "vetoed")
                continue
            children = tree.children(parent)
            if any(self._cooldown.get(c, 0) > self._tick for c in children):
                continue
            if any(_journal.in_flight_touching(c) for c in children):
                # Never merge a group with in-flight residents: the
                # drain phase would begin with the group already dirty.
                continue
            by_owner: dict = {}
            for c in children:
                by_owner.setdefault(self._owner_of(c), []).append(c)
            if None in by_owner:
                continue  # a child is mid-rehost; failover owns this
            if len(by_owner) > 1:
                # Authority diverged (the balancer placed split granules
                # on different servers): the merge needs ONE owner, so
                # reunite the group first through the balancer's own
                # migration transaction — directed, one child per
                # evaluation, toward the group's majority owner. The
                # group stays cold and held, so evaluation re-arrives
                # here until authority converges and the merge arms.
                self._consolidate(parent, by_owner)
                continue
            armed_merge = parent

        if armed_merge is not None and self._may_transact():
            self._plan_merge(ctl, armed_merge)

    def _consolidate(self, parent: int, by_owner: dict) -> None:
        """Plan ONE directed migration moving an outlier child back to
        the cold sibling group's majority owner (ties break on the
        lowest conn id, so every gateway converges on the same home).
        Rides the balancer's full transaction + accounting; this plane
        only supplies the policy."""
        if _balancer.migration_in_flight() is not None:
            return
        if _balancer.frozen_cells:
            return
        home = max(by_owner, key=lambda o: (len(by_owner[o]), -o.id))
        if home is None or home.is_closing():
            return
        outliers = sorted(
            c for o, cs in by_owner.items() if o is not home for c in cs
        )
        for cell in outliers:
            if _balancer.plan_directed(
                cell, home, reason=f"reunite sibling group of {parent}"
            ):
                return

    def _may_transact(self) -> bool:
        """One geometry op at a time, never concurrent with a balancer
        migration (the two planes share the crossing freeze), and only
        within the epoch budget."""
        st = global_settings
        if self._epoch_committed >= st.partition_budget_per_epoch:
            return False
        if _balancer.migration_in_flight() is not None:
            return False
        if _balancer.frozen_cells:
            return False
        return True

    def _owner_of(self, cell_id: int):
        from ..core.channel import get_channel

        ch = get_channel(cell_id)
        return ch.get_owner() if ch is not None else None

    def _hotspot(self, cell: int, n: int, veto: str) -> None:
        """Flight-recorder anomaly: a cell is past the split threshold
        but the split is vetoed — the exact moment an operator needs a
        timeline (the density has no remedy until the veto lifts)."""
        from ..core.tracing import recorder as _trace

        if _trace.enabled:
            _trace.note_anomaly(
                "density_hotspot",
                f"cell {cell} at {n} entities >= split threshold "
                f"{global_settings.partition_split_entities} but split "
                f"vetoed ({veto})",
                force=True,
            )

    # ---- planning --------------------------------------------------------

    def _plan_split(self, ctl, cell: int) -> None:
        self._op_seq += 1
        self._op = GeometryOp(
            op_id=self._op_seq, op="split", target=cell,
            cells=(cell,), planned_tick=self._tick, epoch=self._epoch,
        )
        _balancer.frozen_cells = frozenset((cell,))
        self._count("split", "planned")
        self._split_hold.pop(cell, None)
        logger.info(
            "geometry op %d planned: split cell %d (depth %d); crossings "
            "frozen, draining journal",
            self._op_seq, cell, ctl.tree.depth_of(cell),
        )

    def _plan_merge(self, ctl, parent: int) -> None:
        children = tuple(ctl.tree.children(parent))
        self._op_seq += 1
        self._op = GeometryOp(
            op_id=self._op_seq, op="merge", target=parent,
            cells=children, planned_tick=self._tick, epoch=self._epoch,
        )
        _balancer.frozen_cells = frozenset(children)
        self._count("merge", "planned")
        self._merge_hold.pop(parent, None)
        logger.info(
            "geometry op %d planned: merge cells %s back into %d; "
            "crossings frozen, draining journal",
            self._op_seq, list(children), parent,
        )

    # ---- the in-flight transaction ---------------------------------------

    def _advance(self, ctl) -> None:
        from ..core.channel import get_channel
        from ..core.failover import journal as _journal

        st = global_settings
        op = self._op
        if op.state == COMMITTING:
            self._advance_commit(ctl, op)
            return
        # ---- draining ----
        live = [get_channel(c) for c in op.cells]
        if any(ch is None or ch.is_removing() for ch in live):
            self._abort(ctl, op, "cell_removed")
            return
        owners = {ch.get_owner() for ch in live}
        if len(owners) != 1:
            self._abort(ctl, op, "owner_diverged")
            return
        owner = next(iter(owners))
        if owner is not None and owner.is_closing():
            # The server that would own the new cells died mid-drain:
            # the packed-state bootstrap has no recipient. Failover will
            # re-host; re-plan against the new world.
            self._abort(ctl, op, "dst_dead")
            return
        if _governor.level >= OverloadLevel.L2:
            self._abort(ctl, op, "overload")
            return
        age = self._tick - op.planned_tick
        if any(_journal.in_flight_touching(c) for c in op.cells):
            if age > st.partition_drain_deadline_ticks:
                self._abort(ctl, op, "drain_timeout")
            return  # keep draining
        if age < st.partition_freeze_min_ticks:
            return  # queued entity hops on the frozen cells still run
        if op.op == "split":
            self._execute_split(ctl, op)
        else:
            self._execute_merge(ctl, op)

    def _advance_commit(self, ctl, op: GeometryOp) -> None:
        """Post-commit settling: the geometry IS committed (WAL record
        written, tree applied) — this only waits for the queued data
        moves and channel removals to run before unfreezing."""
        from ..core.channel import get_channel
        from ..core.failover import journal as _journal

        stale = op.cells if op.op == "split" else tuple(
            c for c in op.cells
        )
        settling = any(
            get_channel(c) is not None for c in stale
        ) or any(_journal.in_flight_touching(c) for c in op.cells)
        if settling and self._tick - op.committed_tick < 64:
            return
        if settling:
            logger.warning(
                "geometry op %d: stale cells still settling %d ticks "
                "after commit; unfreezing anyway",
                op.op_id, self._tick - op.committed_tick,
            )
        self._finalize(ctl, op, COMMITTED, "committed")

    def _abort(self, ctl, op: GeometryOp, reason: str) -> None:
        """Deterministic rollback: nothing has mutated before the WAL
        geometry record, so the old geometry simply stays."""
        self._finalize(ctl, op, ABORTED, reason)

    def _finalize(self, ctl, op: GeometryOp, state: str,
                  reason: str) -> None:
        op.state = state if state in (COMMITTED, ABORTED) else op.state
        self._op = None
        _balancer._unfreeze(ctl)
        st = global_settings
        lockout = (
            st.partition_cooldown_ticks if state == COMMITTED
            else st.partition_hold_ticks * 4
        )
        for c in (op.target,) + op.cells:
            self._cooldown[c] = self._tick + lockout
        if state == COMMITTED:
            self._epoch_committed += 1
        result = "committed" if state == COMMITTED else "aborted"
        self._count(op.op, result)
        elapsed_ms = (time.monotonic() - op.t0) * 1000.0
        ev = {
            "op_id": op.op_id, "op": op.op, "target": op.target,
            "cells": list(op.cells), "result": result, "reason": reason,
            "elapsed_ms": round(elapsed_ms, 3), "moved": op.moved,
            "epoch": ctl.geometry_epoch,
            "governor_epoch": op.epoch,
            "planned_tick": op.planned_tick,
            "resolved_tick": self._tick,
        }
        self.events.append(ev)
        if state == ABORTED:
            from ..core.tracing import recorder as _trace

            if _trace.enabled:
                _trace.note_anomaly(
                    "partition_abort",
                    f"geometry op {op.op_id} {op.op} {op.target}: {reason}",
                )
            logger.warning(
                "geometry op %d aborted (%s): %s of %d rolled back, "
                "geometry unchanged at epoch %d",
                op.op_id, reason, op.op, op.target, ctl.geometry_epoch,
            )
        else:
            logger.info(
                "geometry op %d committed: %s of %d -> epoch %d (%d "
                "entities repartitioned, %.1fms)",
                op.op_id, op.op, op.target, ctl.geometry_epoch,
                op.moved, elapsed_ms,
            )

    # ---- commit execution ------------------------------------------------

    def _execute_split(self, ctl, op: GeometryOp) -> None:
        from ..core.channel import get_channel
        from ..core.wal import wal as _wal

        tree = ctl.tree
        cell = op.target
        parent_ch = get_channel(cell)
        if parent_ch is None:
            self._abort(ctl, op, "cell_removed")
            return
        try:
            new_splits = tree.split_result(cell)
        except ValueError as e:
            self._abort(ctl, op, f"geometry_invalid:{e}")
            return
        children = tree.children(cell)
        epoch_next = tree.epoch + 1

        # Partition residents by last known position; unknown positions
        # bootstrap into the child containing the parent's center (the
        # same deterministic fallback WAL replay re-homes with) and
        # re-sort on their next movement.
        ents = getattr(parent_ch.get_data_message(), "entities", None) or {}
        cx, cz = tree.center(cell)
        per_child: dict[int, dict] = {c: {} for c in children}
        for eid, data in dict(ents).items():
            pos = ctl.entity_position(eid)
            if pos is None:
                idx = 3
            else:
                idx = (1 if pos[0] >= cx else 0) + (
                    2 if pos[1] >= cz else 0
                )
            per_child[children[idx]][eid] = data
        op.moved = sum(len(v) for v in per_child.values())

        # THE COMMIT POINT: the geometry record hits the WAL before any
        # mutation it implies — a torn tail either has the record (and
        # replay lands on the new geometry, re-homing whatever the lost
        # mutations left behind) or doesn't (and replay lands on the old
        # geometry with nothing moved): deterministic either way.
        if _wal.enabled:
            _wal.log_geometry(epoch_next, new_splits)
        ctl.apply_geometry(epoch_next, new_splits)

        owner = parent_ch.get_owner()
        for child in children:
            child_ch = self._create_cell_channel(child, parent_ch, owner)
            moved = per_child[child]
            if moved:
                self._move_entities(ctl, cell, child, moved)
            self._announce(ctl, child_ch, owner, op="split",
                           parent=cell, entity_ids=sorted(moved))
        self._retire_cell(parent_ch)
        op.state = COMMITTING
        op.committed_tick = self._tick
        logger.info(
            "geometry op %d: split of cell %d committed at epoch %d "
            "(%d residents -> %s)",
            op.op_id, cell, epoch_next, op.moved,
            {c: len(v) for c, v in per_child.items()},
        )

    def _execute_merge(self, ctl, op: GeometryOp) -> None:
        from ..core.channel import get_channel
        from ..core.wal import wal as _wal

        tree = ctl.tree
        parent = op.target
        child_chs = []
        for c in op.cells:
            ch = get_channel(c)
            if ch is None:
                self._abort(ctl, op, "cell_removed")
                return
            child_chs.append(ch)
        try:
            new_splits = tree.merge_result(parent)
        except ValueError as e:
            self._abort(ctl, op, f"geometry_invalid:{e}")
            return
        epoch_next = tree.epoch + 1
        owner = child_chs[0].get_owner()

        if _wal.enabled:
            _wal.log_geometry(epoch_next, new_splits)
        ctl.apply_geometry(epoch_next, new_splits)

        parent_ch = self._create_cell_channel(parent, child_chs[0], owner)
        moved_ids: list[int] = []
        for ch in child_chs:
            # Merge every child's subscriber set onto the parent (the
            # union is what border interest looked like pre-split).
            self._copy_subscriptions(ch, parent_ch)
            ents = dict(
                getattr(ch.get_data_message(), "entities", None) or {}
            )
            if ents:
                self._move_entities(ctl, ch.id, parent, ents)
                moved_ids.extend(ents)
        op.moved = len(moved_ids)
        self._announce(ctl, parent_ch, owner, op="merge",
                       parent=parent, entity_ids=sorted(moved_ids))
        for ch in child_chs:
            self._retire_cell(ch)
        op.state = COMMITTING
        op.committed_tick = self._tick
        logger.info(
            "geometry op %d: merge into cell %d committed at epoch %d "
            "(%d residents)",
            op.op_id, parent, epoch_next, op.moved,
        )

    # ---- commit plumbing -------------------------------------------------

    def _create_cell_channel(self, cell_id: int, template_ch, owner):
        """A new leaf channel cloned structurally from ``template_ch``
        (same data type + merge options, same subscribers), owned by the
        same server — geometry ops never move authority by themselves."""
        from ..core.channel import create_channel_with_id, get_channel
        from ..core.types import ChannelType

        ch = get_channel(cell_id)
        if ch is not None and not ch.is_removing():
            return ch  # settled already (replayed geometry)
        ch = create_channel_with_id(cell_id, ChannelType.SPATIAL, owner)
        template_data = template_ch.get_data_message()
        merge_options = getattr(template_ch.data, "merge_options", None)
        ch.init_data(
            type(template_data)() if template_data is not None else None,
            merge_options,
        )
        self._copy_subscriptions(template_ch, ch)
        return ch

    def _copy_subscriptions(self, src_ch, dst_ch) -> None:
        from ..core.subscription import subscribe_to_channel

        for conn, cs in list(src_ch.subscribed_connections.items()):
            if conn is None or conn.is_closing():
                continue
            subscribe_to_channel(conn, dst_ch, cs.options)

    def _move_entities(self, ctl, src_id: int, dst_id: int,
                       ents: dict) -> None:
        """The transactional repartition hop — the same journal
        discipline as grid._orchestrate_pair step 2: prepare -> the src
        remove marks, the dst add commits, the placement ledger flips
        only on commit. A crash between the hops replays to exactly one
        owning cell."""
        from ..core.channel import get_channel
        from ..core.failover import journal as _journal

        src_ch, dst_ch = get_channel(src_id), get_channel(dst_id)
        if src_ch is None or dst_ch is None:
            return
        records = _journal.prepare(ents, src_id, dst_id)
        moved_hook = getattr(ctl, "_note_entity_data_moved", None)

        def _remove(ch):
            remover = getattr(ch.get_data_message(), "remove_entity", None)
            if remover is None:
                ch.logger.warning("spatial data can't remove entities")
                return
            for eid in ents:
                remover(eid)
            _journal.note_removed(records)

        def _add(ch):
            adder = getattr(ch.get_data_message(), "add_entity", None)
            if adder is None:
                ch.logger.warning("spatial data can't add entities")
                for rec in records:
                    _journal.abort(rec)
                return
            for eid, data in ents.items():
                if data is not None:
                    adder(eid, data)
            flips = _journal.commit(records)
            if moved_hook is not None and flips:
                moved_hook(flips, dst_id)

        src_ch.execute(_remove)
        dst_ch.execute(_add)

    def _announce(self, ctl, ch, owner, op: str, parent: int,
                  entity_ids: list) -> None:
        """Authority announcement per new cell: the owner's copy carries
        the packed authoritative bootstrap, everyone else gets the
        identifier-only form + a forced full resync — the same fan-out
        discipline as failover re-hosts and balancer migrations."""
        if owner is None:
            return
        from ..core.failover import announce_authority_change
        from ..core.types import MessageType
        from ..protocol import spatial_pb2

        tree = ctl.tree
        build = (
            lambda c, eids=list(entity_ids), o=op, p=parent,
            epoch=tree.epoch, splits=sorted(tree.splits),
            oid=owner.id:
                spatial_pb2.CellGeometryUpdateMessage(
                    geometryEpoch=epoch,
                    splitCells=splits,
                    channelId=c.id,
                    parentChannelId=p,
                    prevOwnerConnId=oid,
                    newOwnerConnId=oid,
                    entityIds=eids,
                    op=o,
                )
        )
        # Queued on the new cell's OWN FIFO: the repartition adds were
        # queued there first, so the owner's packed-state bootstrap packs
        # the post-move data, not the empty just-created channel.
        ch.execute(
            lambda c: announce_authority_change(
                c, owner, MessageType.CELL_GEOMETRY_UPDATE, build
            )
        )

    def _retire_cell(self, ch) -> None:
        """Queue the stale cell's teardown behind its pending removes:
        unsubscribe every connection, then remove the channel (the WAL
        tombstone rides remove_channel)."""
        from ..core.channel import remove_channel
        from ..core.subscription import unsubscribe_from_channel
        from ..core.subscription_messages import send_unsubscribed

        def _teardown(c):
            for conn in list(c.subscribed_connections):
                if conn is None or conn.is_closing():
                    continue
                try:
                    unsubscribe_from_channel(conn, c)
                    send_unsubscribed(conn, c, None, 0)
                except KeyError:
                    pass
            remove_channel(c)

        ch.execute(_teardown)

    # ---- bookkeeping -----------------------------------------------------

    def _count(self, op: str, result: str) -> None:
        key = f"{op}_{result}"
        self.ledger[key] = self.ledger.get(key, 0) + 1
        from ..core import metrics

        metrics.partition_ops.labels(op=op, result=result).inc()

    def op_in_flight(self) -> Optional[GeometryOp]:
        return self._op

    def report(self) -> dict:
        """Ops/soak surface."""
        return {
            "tick": self._tick,
            "epoch": self._epoch,
            "in_flight": (
                {
                    "op_id": self._op.op_id, "op": self._op.op,
                    "target": self._op.target, "state": self._op.state,
                }
                if self._op is not None else None
            ),
            "ledger": dict(self.ledger),
            "events": list(self.events),
        }


partition = PartitionPlane()


def reset_partition() -> None:
    """Test hook."""
    partition.reset()
