"""Spatial authority failover: cell re-hosting + transactional handover.

Beyond-reference capability (the reference pkg/channeld has recovery for
servers that COME BACK, but a server that dies for good leaves its
spatial and entity channels ownerless forever — every update to them is
dropped). This module closes that gap, in the authority-re-assignment
tradition of geo-replicated service architectures (PAPERS.md: Spider's
replicated-authoritative-state failover): the gateway already holds the
authoritative ChannelData for every cell, so when a recoverable server's
recovery window expires (``ServerLostEvent``), the orphaned cells are
re-hosted onto surviving spatial servers instead of going dark.

Two cooperating pieces (doc/failover.md):

- :class:`HandoverJournal` — a per-entity prepare -> commit/abort ledger
  wrapped around the cross-cell handover orchestration
  (``spatial/grid.py _orchestrate_pair``). The data move runs as two
  queued ``Channel.execute`` hops (remove in the src tick, add in the
  dst tick); the journal records the transaction so a server crash (or
  channel removal) between the hops deterministically resolves to
  exactly ONE owning cell — never a duplicated or lost entity. The
  authoritative ``_data_cell`` placement ledger only flips on COMMIT
  (the add actually ran); aborted handovers re-add the data to the src
  cell through the same FIFO queue and are re-offered after failover.

- :class:`FailoverPlane` — listens for ``ServerLostEvent``, then (inside
  the GLOBAL channel tick, the same execution context as handover
  orchestration): resolves in-flight journal records, picks surviving
  spatial servers by load (fewest owned cells, tie-break lowest conn
  id), re-hosts each orphaned cell (owner + WRITE subscription +
  authoritative-state bootstrap reusing the snapshot pack path),
  re-points orphaned entity channels to their cell's new owner, forces a
  full-state resync for every remaining subscriber, and emits structured
  ``CellRehostedMessage`` notifications (msgType 25) so engine SDKs can
  respawn authority.

Every re-host/abort is counted twice on purpose — prometheus counters
AND python-side ledgers — so the failover soak
(``scripts/failover_soak.py``) proves the accounting exact.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ..utils.logger import get_logger
from .settings import global_settings
from .types import ChannelDataAccess, MessageType

logger = get_logger("failover")

# Handover-journal record states. PREPARED -> REMOVED happens in the src
# cell's tick, -> COMMITTED in the dst cell's tick; ABORTED is the
# failover resolution when the dst can never run its add.
PREPARED = "prepared"
REMOVED = "removed"
COMMITTED = "committed"
ABORTED = "aborted"


def placement_score(cells_owned: int, entities_hosted: int) -> float:
    """Entity-weighted placement load of one candidate server — the ONE
    scoring function shared by failover re-host and the live balancer
    (spatial/balancer.py). Lower is better. Owned-cell count alone (the
    old failover rule) mis-ranks a server with few but HUGE cells as
    idle; entities are the actual per-tick cost driver, so they weigh
    in at ``failover_placement_entity_weight`` cells each."""
    return (
        cells_owned
        + entities_hosted * global_settings.failover_placement_entity_weight
    )


def entity_count_of(ch) -> int:
    """Entities resident in one channel's authoritative data (0 when the
    data type has no entity table)."""
    if ch is None or ch.data is None:
        return 0
    ents = getattr(ch.data.msg, "entities", None)
    return len(ents) if ents is not None else 0


def collect_spatial_loads() -> dict:
    """conn -> [cells_owned, entities_hosted] over every live-owned
    spatial cell — the candidate table both placement consumers feed
    into :func:`placement_score`."""
    from .channel import all_channels

    lo = global_settings.spatial_channel_id_start
    hi = global_settings.entity_channel_id_start
    loads: dict = {}
    for cid, ch in all_channels().items():
        if lo <= cid < hi and ch.has_owner():
            row = loads.setdefault(ch.get_owner(), [0, 0])
            row[0] += 1
            row[1] += entity_count_of(ch)
    return loads


def pick_placement(loads: dict):
    """The candidate with the lowest entity-weighted placement score,
    tie-break lowest conn id; None when there are no candidates. The
    caller mutates ``loads`` between picks so one loss/migration wave
    spreads evenly."""
    if not loads:
        return None
    return min(
        loads,
        key=lambda c: (placement_score(loads[c][0], loads[c][1]), c.id),
    )


def announce_authority_change(ch, new_owner, msg_type, build_msg) -> None:
    """The ONE announce path for a cell authority change, shared by
    failover re-host (CellRehostedMessage) and planned migration
    (CellMigratedMessage). Serialized through the cell's own queue so
    any queued entity remove/add lands before the bootstrap snapshot is
    taken: the new owner's copy carries the packed authoritative state
    (the snapshot pack path); every other subscriber gets the
    identifier-only copy — encoded once, shared — plus a forced
    full-state resync (a delta stream is void across an authority
    change)."""
    from .message import MessageContext
    from .snapshot import pack_channel_state

    def _announce(c, owner=new_owner):
        base = build_msg(c)
        boot = type(base)()
        boot.CopyFrom(base)
        packed = pack_channel_state(c)
        if packed is not None:
            boot.channelData.CopyFrom(packed)
        owner.send(MessageContext(
            msg_type=msg_type, msg=boot, channel_id=c.id,
        ))
        shared = MessageContext(
            msg_type=msg_type, msg=base, channel_id=c.id,
        )
        shared.ensure_raw_body()
        for conn, sub in list(c.subscribed_connections.items()):
            if conn is owner or conn.is_closing():
                continue
            conn.send(shared)
            sub.fanout_conn.had_first_fanout = False

    ch.execute(_announce)


@dataclass
class HandoverRecord:
    txn_id: int
    entity_id: int
    src_channel_id: int
    dst_channel_id: int
    # The entity data message captured at prepare time — what an abort
    # re-adds to the src cell. None for group members that carried no
    # data (their "move" is removal-only, nothing to restore).
    data: object
    state: str = PREPARED
    # True for cross-gateway handovers (federation/plane.py): the dst
    # channel id names a REMOTE cell, so the local failover resolution
    # must never judge the txn by local channel existence — the
    # federation plane owns its commit/abort (trunk ack or timeout).
    remote: bool = False


class HandoverJournal:
    """Transactional per-entity handover ledger (one in-flight record per
    entity; a chained second hop overwrites the in-flight slot, and the
    first hop's commit only clears the slot if it still owns it)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._in_flight: dict[int, HandoverRecord] = {}
        self._txn = 0
        # entity id -> highest txn id whose commit flipped the placement
        # ledger. Commits land in CHANNEL-TICK order, not txn order — a
        # chained hop's commit can run before its predecessor's — so a
        # flip is only granted to a txn newer than the last granted one.
        self._flip_txn: dict[int, int] = {}
        # Python-side ledger; must match handover_journal_total exactly.
        self.counts: dict[str, int] = {}

    def _count(self, state: str, n: int = 1) -> None:
        self.counts[state] = self.counts.get(state, 0) + n
        from . import metrics

        metrics.handover_journal.labels(state=state).inc(n)

    def _wal_log(self, op: str, rec: "HandoverRecord") -> None:
        """Journal transitions ride the WAL (doc/persistence.md): a
        crash mid-handover replays to exactly one owning cell — the
        restored src on a lost commit, with a source-wins abort notice
        at a remote batch's destination."""
        from .wal import wal

        if wal.enabled:
            wal.log_journal(op, rec)

    # ---- the transaction surface (called from grid orchestration) -------

    def prepare(
        self, entities: dict, src_channel_id: int, dst_channel_id: int,
        remote: bool = False,
    ) -> list[HandoverRecord]:
        records = []
        for entity_id, data in entities.items():
            self._txn += 1
            rec = HandoverRecord(
                self._txn, entity_id, src_channel_id, dst_channel_id, data,
                remote=remote,
            )
            self._in_flight[entity_id] = rec
            records.append(rec)
            self._wal_log(PREPARED, rec)
        self._count(PREPARED, len(records))
        return records

    def note_removed(self, records: list[HandoverRecord]) -> None:
        """The src cell's remove ran (src tick). Aborted records stay
        aborted — their restoring re-add is already queued behind this
        very remove."""
        for rec in records:
            if rec.state == PREPARED:
                rec.state = REMOVED

    def commit(self, records: list[HandoverRecord]) -> list[int]:
        """The dst cell's add ran (dst tick): the entity now lives in
        exactly the dst cell. Returns the entity ids whose placement
        ledger should flip to this txn's dst — txn-id ordered, so a
        predecessor's late commit never clobbers a chained successor's
        flip."""
        committed = 0
        flips: list[int] = []
        for rec in records:
            if rec.state in (PREPARED, REMOVED):
                rec.state = COMMITTED
                committed += 1
                self._wal_log(COMMITTED, rec)
                # Flip only on a REAL commit: an ABORTED record (entity
                # destroyed mid-flight) must not resurrect a ledger row
                # its cleanup already removed.
                if self._flip_txn.get(rec.entity_id, 0) < rec.txn_id:
                    self._flip_txn[rec.entity_id] = rec.txn_id
                    flips.append(rec.entity_id)
            if self._in_flight.get(rec.entity_id) is rec:
                del self._in_flight[rec.entity_id]
        if committed:
            self._count(COMMITTED, committed)
        return flips

    def abort(self, rec: HandoverRecord) -> None:
        if rec.state not in (COMMITTED, ABORTED):
            rec.state = ABORTED
            self._count(ABORTED)
            self._wal_log(ABORTED, rec)
        if self._in_flight.get(rec.entity_id) is rec:
            del self._in_flight[rec.entity_id]

    # ---- queries ---------------------------------------------------------

    def pending_dst(self, entity_id: int) -> Optional[int]:
        """The dst channel id of the entity's in-flight handover, or
        None. The batched detector consults this BEFORE the committed
        placement ledger: mid-flight, the data is bound for the pending
        dst even though ``_data_cell`` still says src."""
        rec = self._in_flight.get(entity_id)
        return rec.dst_channel_id if rec is not None else None

    def in_flight_count(self) -> int:
        return len(self._in_flight)

    def remote_in_flight(self, entity_id: int) -> bool:
        """True while the entity's in-flight slot holds a CROSS-GATEWAY
        record: local orchestration (and a second remote offer) must
        skip it — the trunk ack tears it down on commit, the abort path
        restores and re-offers it. Orchestrating the entity locally
        mid-flight would double its data (the remote batch already
        captured a copy)."""
        rec = self._in_flight.get(entity_id)
        return (
            rec is not None and rec.remote
            and rec.state in (PREPARED, REMOVED)
        )

    def in_flight_records(self) -> list[HandoverRecord]:
        """ALL in-flight records, local hops included. The epoch
        replica exports these: an entity mid-LOCAL-crossing sits in
        NEITHER cell's data rows (removed from src, the dst add/commit
        still queued), so a snapshot of cell data alone goes blind to
        it — and a gateway killed with its final snapshot taken in that
        window would lose the entity for good (the herding storms that
        precede a death are exactly when crossings are densest)."""
        return [
            rec for rec in self._in_flight.values()
            if rec.state in (PREPARED, REMOVED)
        ]

    def in_flight_touching(self, channel_id: int) -> int:
        """In-flight handover records reading or writing one spatial
        channel — the balancer's drain barrier: a cell migration only
        executes once no transaction still references the cell."""
        return sum(
            1
            for rec in self._in_flight.values()
            if rec.src_channel_id == channel_id
            or rec.dst_channel_id == channel_id
        )

    def forget_entity(self, entity_id: int) -> None:
        """The entity was destroyed/untracked mid-flight: the transaction
        is moot (nothing left to place)."""
        self._flip_txn.pop(entity_id, None)
        rec = self._in_flight.pop(entity_id, None)
        if rec is not None and rec.state not in (COMMITTED, ABORTED):
            rec.state = ABORTED
            self._count(ABORTED)
            self._wal_log(ABORTED, rec)

    # ---- failover resolution --------------------------------------------

    def resolve_in_flight(self) -> list[HandoverRecord]:
        """Deterministic crash resolution: a record whose dst channel can
        never run its add (removed/missing) is aborted — the entity
        belongs to the SRC cell. The restoring re-add is queued on the
        src channel, so FIFO ordering guarantees it lands after any
        still-pending remove regardless of which hop had executed when
        the crash hit. Returns the aborted records (the caller re-offers
        them after failover completes)."""
        from .channel import get_channel

        aborted = []
        for entity_id, rec in list(self._in_flight.items()):
            if rec.remote:
                # Cross-gateway txn: the dst cell lives on another
                # gateway, so "no local dst channel" is its NORMAL
                # in-flight state — the federation plane resolves it
                # (trunk ack, timeout, or trunk loss), never this pass.
                continue
            dst = get_channel(rec.dst_channel_id)
            if dst is not None and not dst.is_removing():
                continue  # the queued add still runs; commit will land
            src = get_channel(rec.src_channel_id)
            if (
                src is not None
                and not src.is_removing()
                and rec.data is not None
            ):
                def _readd(ch, e=rec.entity_id, d=rec.data):
                    adder = getattr(ch.get_data_message(), "add_entity", None)
                    if adder is not None:
                        adder(e, d)

                src.execute(_readd)
            self.abort(rec)
            aborted.append(rec)
            logger.warning(
                "handover txn %d aborted: entity %d stays in cell %d "
                "(dst %d is gone)",
                rec.txn_id, entity_id, rec.src_channel_id,
                rec.dst_channel_id,
            )
        return aborted

    def report(self) -> dict:
        return {
            "counts": dict(self.counts),
            "in_flight": self.in_flight_count(),
        }


# The process-wide journal; grid orchestration and the failover plane
# share it (one attribute load on the handover hot path).
journal = HandoverJournal()


class FailoverPlane:
    """ServerLostEvent -> cell re-hosting. One instance (``plane``),
    (re-)installed by ``init_channels``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # Python-side re-host ledger; must match the prometheus counters.
        self.ledger: dict[str, int] = {
            "servers_lost": 0,
            "cells_rehosted": 0,
            "cells_unrehostable": 0,
            "entities_repointed": 0,
            "entities_stranded": 0,
            "handovers_aborted": 0,
        }
        self.events: list[dict] = []  # one record per ServerLost, for soaks

    def install(self) -> None:
        from . import events

        events.server_lost.unlisten_for(self)
        events.server_lost.listen_for(self, self._on_server_lost)

    # ---- event intake ----------------------------------------------------

    def _on_server_lost(self, data) -> None:
        self.ledger["servers_lost"] += 1
        if not global_settings.failover_enabled:
            logger.warning(
                "failover disabled: server %s (conn %d) lost for good; its "
                "%d owned channels stay ownerless",
                data.pit, data.prev_conn_id, len(data.owned_channel_ids),
            )
            return
        from .channel import get_global_channel

        gch = get_global_channel()
        if gch is None or gch.is_removing():
            self._run(data)  # no runtime (tests): resolve inline
        else:
            # Channel state is single-writer; re-hosting touches many
            # channels, so it runs where handover orchestration already
            # does — inside the GLOBAL channel tick.
            gch.execute(lambda _ch, d=data: self._run(d))

    # ---- the failover pass (GLOBAL tick context) -------------------------

    def _run(self, data) -> None:
        from . import metrics
        from .channel import all_channels, get_channel
        from ..spatial.controller import get_spatial_controller

        t0 = time.monotonic()
        st = global_settings
        ctl = get_spatial_controller()
        spatial_lo = st.spatial_channel_id_start
        spatial_hi = st.entity_channel_id_start

        # In-flight handovers whose dst died with the server resolve to
        # exactly one owning cell before any bootstrap is snapshotted.
        aborted = journal.resolve_in_flight()
        self.ledger["handovers_aborted"] += len(aborted)

        orphan_cells = []
        orphan_entities = []
        for cid in data.owned_channel_ids:
            ch = get_channel(cid)
            if ch is None or ch.is_removing():
                continue
            if spatial_lo <= cid < spatial_hi and not ch.has_owner():
                orphan_cells.append(cid)
            elif cid >= spatial_hi:
                orphan_entities.append(cid)

        # Surviving spatial servers by entity-weighted load (the shared
        # placement_score), updated as orphans are assigned so one loss
        # spreads evenly — an entity-heavy server is deprioritized even
        # when it owns few cells.
        loads = collect_spatial_loads()
        assignments: dict[int, object] = {}
        if loads:
            for cid in sorted(orphan_cells):
                target = pick_placement(loads)
                loads[target][0] += 1
                loads[target][1] += entity_count_of(get_channel(cid))
                assignments[cid] = target
        unrehostable = len(orphan_cells) - len(assignments)
        if unrehostable:
            self.ledger["cells_unrehostable"] += unrehostable
            logger.error(
                "no surviving spatial server: %d orphaned cells stay "
                "ownerless (updates to them are counted in "
                "ownerless_drops_total)", unrehostable,
            )

        # Orphaned entity channels re-point to the owner of the cell
        # their data lives in (the committed placement ledger when a TPU
        # controller runs; last-known position otherwise). The sweep
        # covers the dead server's stash AND every other ownerless
        # entity channel: a handover orchestrated INTO an orphaned cell
        # during the recovery window stamps the entity with that cell's
        # (dead) owner, and those channels appear in nobody's stash.
        repointed: dict[int, list[int]] = {}
        seen = set(orphan_entities)
        sweep = list(orphan_entities)
        for cid, ch in all_channels().items():
            if cid >= spatial_hi and cid not in seen and not ch.has_owner():
                sweep.append(cid)
        for eid in sweep:
            ech = get_channel(eid)
            if ech is None or ech.is_removing() or ech.has_owner():
                # Already re-owned by a live server (a handover landed
                # it in a living cell during the window): leave it.
                continue
            cell_id = self._cell_of_entity(ctl, eid)
            new_owner = assignments.get(cell_id)
            if new_owner is None and cell_id is not None:
                cell_ch = get_channel(cell_id)
                if cell_ch is not None and cell_ch.has_owner():
                    new_owner = cell_ch.get_owner()
            if new_owner is None:
                self.ledger["entities_stranded"] += 1
                continue
            self._repoint_entity(ech, new_owner)
            self.ledger["entities_repointed"] += 1
            if cell_id is not None:
                repointed.setdefault(cell_id, []).append(eid)

        for cid, target in assignments.items():
            self._rehost_cell(
                get_channel(cid), target, data.prev_conn_id,
                sorted(repointed.get(cid, [])),
            )

        # Aborted handovers re-offer once failover is done: the entity
        # re-orchestrates from its (restored) src cell to wherever its
        # position now maps — through the normal batched detector.
        for rec in aborted:
            self._reoffer(ctl, rec)

        elapsed_ms = (time.monotonic() - t0) * 1000.0
        metrics.failover_rehost_ms.observe(elapsed_ms)
        from .tracing import recorder as _trace

        if _trace.enabled:
            # A failover epoch is a flight-recorder anomaly: the frozen
            # timeline holds the ticks around the loss plus this whole
            # re-host pass (its span lands just below).
            _trace.span("failover.rehost", int(t0 * 1e9))
            _trace.note_anomaly(
                "failover_epoch",
                f"{data.pit}: {len(assignments)}/{len(orphan_cells)} "
                f"cells re-hosted in {elapsed_ms:.1f}ms",
            )
        deadline_ms = st.failover_rehost_deadline_s * 1000.0
        log = logger.warning if elapsed_ms > deadline_ms else logger.info
        log(
            "failover for %s (conn %d): %d/%d cells re-hosted, %d entity "
            "channels re-pointed (%d stranded), %d in-flight handovers "
            "aborted, %.1fms",
            data.pit, data.prev_conn_id, len(assignments),
            len(orphan_cells), sum(len(v) for v in repointed.values()),
            self.ledger["entities_stranded"], len(aborted), elapsed_ms,
        )
        self.events.append({
            "pit": data.pit,
            "prev_conn_id": data.prev_conn_id,
            "reason": data.reason,
            "orphan_cells": sorted(orphan_cells),
            "rehosted": {
                str(cid): conn.id for cid, conn in assignments.items()
            },
            "entities_repointed": sum(len(v) for v in repointed.values()),
            "handovers_aborted": len(aborted),
            "duration_ms": round(elapsed_ms, 3),
        })

    # ---- pieces ----------------------------------------------------------

    def _cell_of_entity(self, ctl, entity_id: int) -> Optional[int]:
        if ctl is None:
            return None
        cell = getattr(ctl, "_data_cell", {}).get(entity_id)
        if cell is not None:
            return cell
        info = getattr(ctl, "_last_positions", {}).get(entity_id)
        if info is not None:
            try:
                return ctl.get_channel_id(info)
            except ValueError:
                return None
        return None

    def _repoint_entity(self, ech, new_owner) -> None:
        from .subscription import subscribe_to_channel
        from .subscription_messages import send_subscribed

        ech.set_owner(new_owner)
        # Full first fan-out on purpose: the entity channel's own state
        # streams to the new authority (the cell bootstrap carries only
        # the spatial data).
        cs, should_send = subscribe_to_channel(new_owner, ech, None)
        if should_send and cs is not None:
            send_subscribed(new_owner, ech, new_owner, 0, cs.options)

    def _rehost_cell(self, ch, new_owner, prev_conn_id, entity_ids) -> None:
        from . import metrics
        from ..protocol import control_pb2, spatial_pb2
        from .subscription import subscribe_to_channel
        from .subscription_messages import send_subscribed

        ch.set_owner(new_owner)
        opts = control_pb2.ChannelSubscriptionOptions(
            dataAccess=ChannelDataAccess.WRITE_ACCESS,
            skipSelfUpdateFanOut=True,
            # The authoritative bootstrap rides the CellRehostedMessage;
            # a second full-state fan-out would be redundant bytes.
            skipFirstFanOut=True,
        )
        cs, should_send = subscribe_to_channel(new_owner, ch, opts)
        if should_send and cs is not None:
            send_subscribed(new_owner, ch, new_owner, 0, cs.options)
        self.ledger["cells_rehosted"] += 1
        metrics.failover_rehost.inc()

        announce_authority_change(
            ch, new_owner, MessageType.CELL_REHOSTED,
            lambda c, eids=list(entity_ids): spatial_pb2.CellRehostedMessage(
                channelId=c.id,
                prevOwnerConnId=prev_conn_id,
                newOwnerConnId=new_owner.id,
                entityIds=eids,
            ),
        )
        # Device plane: the new owner's WRITE sub registered a fresh
        # engine fan-out slot above (subscribe_to_channel); controllers
        # keeping extra per-cell state get the explicit hook.
        from ..spatial.controller import get_spatial_controller

        ctl = get_spatial_controller()
        hook = getattr(ctl, "on_cell_rehosted", None)
        if hook is not None:
            hook(ch.id, new_owner)

    def _reoffer(self, ctl, rec: HandoverRecord) -> None:
        """Queue an aborted handover for re-orchestration through the
        batched detector (TPU controller) once failover completed."""
        if ctl is None:
            return
        deferred = getattr(ctl, "_deferred_crossings", None)
        if deferred is None or rec.entity_id in deferred:
            return
        last = getattr(ctl, "_last_positions", {}).get(rec.entity_id)
        start = global_settings.spatial_channel_id_start
        try:
            old_info = ctl._cell_center(rec.src_channel_id - start)
        except AttributeError:
            return
        provider = getattr(ctl, "_providers", {}).get(
            rec.entity_id, lambda s, d, e=rec.entity_id: e
        )
        deferred[rec.entity_id] = (old_info, last or old_info, provider)

    def report(self) -> dict:
        return {
            "ledger": dict(self.ledger),
            "events": list(self.events),
            "journal": journal.report(),
        }


plane = FailoverPlane()


def reset_failover() -> None:
    """Test hook (also run by init_channels at world boot)."""
    journal.reset()
    plane.reset()
