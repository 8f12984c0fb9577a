"""The federation plane: cross-gateway handover + client redirect.

A crossing whose destination cell the shard directory maps to another
gateway (spatial/grid.py consults it on every crossing) becomes a
**cross-gateway handover** — the PR 3 transactional journal extended
over the trunk:

  initiator (src gateway)                 destination gateway
  -----------------------                 -------------------
  journal.prepare(remote=True)
  src cell remove (FIFO, src tick)
  src-side identifier-only fan-out
  TRUNK_HANDOVER_PREPARE  ─────────────►  overload L3? -> refuse with
                                          ServerBusyMessage semantics
                                          else: create entity channels,
                                          add to dst cell (dst tick),
                                          dst-side fan-out + subs
  ◄─────────────  TRUNK_HANDOVER_ACK
  committed: journal.commit, tear down
    local entity channels, redirect
    anchored clients (pre-staged
    recovery handle on the peer)
  refused/timeout/trunk loss:
    journal.abort -> restore to the
    src cell through the same FIFO
    queue, park for re-offer

**Determinism under partition.** On trunk loss every in-flight batch
aborts back to the source gateway — the entities keep being served from
src (availability wins during the partition). The destination may have
applied a batch whose ack was lost; it keeps a bounded journal of
applied batches, and on reconnect the initiator sends
``TRUNK_ABORT_NOTICE`` for everything it aborted: the destination
purges entities those batches left behind (source-wins reconciliation),
restoring exactly-once placement across the federation. The soak
(scripts/federation_soak.py) severs the trunk mid-burst and asserts the
final census balances to zero lost / zero duplicated.

Every terminal outcome is double-counted (python ledger here AND
``federation_handover_total{result}``) so the soak proves the
accounting exact.
"""

from __future__ import annotations

import asyncio
import secrets
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from ..core.settings import global_settings
from ..core.tracing import new_trace_id, recorder as _trace
from ..core.types import (
    ChannelDataAccess,
    ChannelType,
    MessageType,
)
from ..protocol import control_pb2, spatial_pb2
from ..utils.anyutil import pack_any, unpack_any
from ..utils.logger import get_logger
from .control import append_event, control as global_control
from .directory import directory
from .trunk import TrunkManager

logger = get_logger("federation.plane")

# Bounded journal of batches applied from remote initiators, kept for
# source-wins reconciliation after a partition heals.
MAX_APPLIED_BATCHES = 4096

# Abort notices have no end-to-end ack, and a trunk frame can be lost
# even when send() succeeded locally (chaos egress drop, a send racing
# the peer's crash). They are therefore RETRANSMITTED — kept queued and
# re-flushed periodically while the trunk is up (the receiver's
# reconcile is idempotent: unknown batch ids are ignored) — and only
# dropped after this TTL.
ABORT_NOTICE_TTL_S = 30.0
ABORT_NOTICE_RESEND_S = 1.0


@dataclass
class PendingBatch:
    batch_id: int
    peer: str
    src_channel_id: int
    dst_channel_id: int
    records: list  # HandoverRecord (remote=True)
    entities: dict  # entity id -> data message (None for data-less)
    deadline: float
    redirect_conns: list = field(default_factory=list)
    # Flight-recorder trace id: rides the trunk (TrunkHandoverPrepare/
    # Ack traceId) so both gateways' recorders stamp this handover's
    # spans with the same id (doc/observability.md).
    trace_id: str = ""


@dataclass
class ParkedCrossing:
    entity_id: int
    src_channel_id: int
    dst_channel_id: int
    not_before: float = 0.0


class FederationPlane:
    """One instance (``plane``); disarmed until :func:`init_federation`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.active = False
        self.manager: Optional[TrunkManager] = None
        self._tasks: list[asyncio.Task] = []
        # Initiator state.
        self._pending: dict[int, PendingBatch] = {}
        self._parked: dict[int, ParkedCrossing] = {}
        # peer -> {(initiator, batch id): first-queued monotonic ts};
        # re-flushed until the TTL (see ABORT_NOTICE_TTL_S). Initiator
        # "" = this gateway; the control plane queues notices on a DEAD
        # initiator's behalf under its id (batch ids are per-initiator
        # counters — the receiver resolves against (initiator, id)).
        self._abort_notices: dict[str, dict[tuple, float]] = {}
        self._notices_flushed_at: dict[str, float] = {}
        self._pending_redirects: dict[str, tuple] = {}  # pit -> (conn, eid, dst)
        self.client_anchors: dict[int, tuple] = {}  # conn id -> (conn, entity)
        # Receiver state: (initiator gateway, batch id) -> (dst cell,
        # entity ids). Batch ids are per-initiator counters — a bare-id
        # key would collide across initiators (fatal once a dead
        # gateway's registry is adopted: a third gateway's abort notice
        # would purge the WRONG batch's entities).
        self._applied: OrderedDict[tuple, tuple] = OrderedDict()
        # Double-entry accounting: this ledger must match
        # federation_handover_total{result} exactly.
        self.ledger: dict[str, int] = {}
        # ServerBusyMessage frames received over the trunk (the soak's
        # "refusals == busy frames" invariant's far end).
        self.busy_frames = 0
        self.events: list[dict] = []

    # ---- accounting ------------------------------------------------------

    def _count(self, result: str, n: int = 1) -> None:
        self.ledger[result] = self.ledger.get(result, 0) + n
        from ..core import metrics

        metrics.federation_handover.labels(result=result).inc(n)

    def _event(self, e: dict) -> None:
        append_event(self.events, e)

    # ---- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        if not directory.active:
            raise RuntimeError("init_federation must run before plane.start")
        self.manager = TrunkManager(
            directory, self._on_trunk_message, self._on_trunk_up,
            self._on_trunk_down,
        )
        await self.manager.start()
        self._tasks = [asyncio.ensure_future(self._timeout_loop())]
        self.active = True
        if global_settings.global_control_enabled:
            # The global control plane rides the trunks: load-vector
            # export, shard replication, leader planning, death
            # detection (doc/global_control.md).
            global_control.start(self)
        logger.info(
            "federation plane up: gateway %s hosting server indices %s, "
            "peers %s", directory.local_id,
            directory.local_server_indices(), directory.peers(),
        )

    def announce_goodbye(self) -> int:
        """Graceful-shutdown farewell on every live trunk: peers take
        the link down immediately and the control-plane leader
        re-maps this gateway's shard without waiting out the death-miss
        window (core/server.py drain_gateway). Returns how many peers
        heard it."""
        heard = 0
        for peer in directory.peers():
            link = self.link_to(peer)
            if link is not None and link.send(
                MessageType.TRUNK_HEARTBEAT,
                control_pb2.TrunkHeartbeatMessage(
                    sentAtMs=int(time.monotonic() * 1000.0),
                    goodbye=True,
                ),
            ):
                heard += 1
        if heard:
            self._event({"kind": "goodbye_sent", "peers": heard})
        return heard

    def stop(self) -> None:
        self.active = False
        global_control.stop()
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        if self.manager is not None:
            self.manager.stop()
            self.manager = None

    def link_to(self, peer: str):
        if self.manager is None:
            return None
        link = self.manager.links.get(peer)
        return link if link is not None and link.alive else None

    def set_client_anchor(self, conn, entity_id: int) -> None:
        """Declare ``entity_id`` the client's interest anchor (its
        possessed pawn, in engine terms): when that entity commits a
        cross-gateway handover, the client is redirected to the entity's
        new gateway with a pre-staged recovery handle. Wired to the
        UPDATE_SPATIAL_INTEREST follow path (spatial/messages.py) — a
        client following an entity IS anchored on it."""
        self.client_anchors[conn.id] = (conn, entity_id)

    def clear_client_anchor(self, conn_id: int) -> None:
        self.client_anchors.pop(conn_id, None)

    # ---- initiator: the cross-gateway handover ---------------------------

    def initiate_handover(
        self, src_channel_id: int, dst_channel_id: int, providers: list
    ) -> None:
        """Called from grid crossing orchestration when the dst cell is
        remote. Runs in the same execution context as local handover
        orchestration (the GLOBAL channel tick)."""
        from ..core.channel import get_channel
        from ..core.failover import journal

        peer = directory.gateway_of_cell(dst_channel_id)
        src_channel = get_channel(src_channel_id)
        if peer is None or src_channel is None:
            return
        link = self.link_to(peer)

        handover_entities: dict = {}
        for provider in providers:
            entity_id = provider(src_channel_id, dst_channel_id)
            if entity_id is None:
                continue
            entity_channel = get_channel(entity_id)
            if entity_channel is None:
                continue
            if link is None:
                # Trunk down at initiation: the entity stays home (no
                # journal churn, nothing removed) and is parked for
                # re-offer the moment the trunk returns.
                self._park(entity_id, src_channel_id, dst_channel_id)
                continue
            group = entity_channel.get_handover_entities(entity_id)
            if not group:
                continue  # a member is locked, or nothing to move
            handover_entities.update(group)
        if not handover_entities or link is None:
            return
        for eid in handover_entities:
            self._parked.pop(eid, None)

        records = journal.prepare(
            handover_entities, src_channel_id, dst_channel_id, remote=True
        )
        batch_id = records[0].txn_id
        trace_id = new_trace_id(directory.local_id)
        init_start = _trace.now()

        def _remove(ch):
            data_msg = ch.get_data_message()
            remover = getattr(data_msg, "remove_entity", None)
            if remover is None:
                ch.logger.warning("spatial data can't remove entities")
                return
            for entity_id in handover_entities:
                remover(entity_id)
            journal.note_removed(records)

        src_channel.execute(_remove)
        self._send_src_fanout(
            src_channel, src_channel_id, dst_channel_id, handover_entities
        )

        msg = control_pb2.TrunkHandoverPrepareMessage(
            batchId=batch_id,
            srcChannelId=src_channel_id,
            dstChannelId=dst_channel_id,
            traceId=trace_id,
        )
        for rec in records:
            e = msg.entities.add()
            e.entityId = rec.entity_id
            e.txnId = rec.txn_id
            if rec.data is not None:
                e.data.CopyFrom(pack_any(rec.data))
        batch = PendingBatch(
            batch_id=batch_id, peer=peer,
            src_channel_id=src_channel_id, dst_channel_id=dst_channel_id,
            records=records, entities=dict(handover_entities),
            deadline=time.monotonic()
            + global_settings.federation_handover_timeout_ms / 1000.0,
            trace_id=trace_id,
        )
        self._pending[batch_id] = batch
        from ..core import metrics

        metrics.handover_count.inc(len(handover_entities))
        global_control.note_crossing(len(handover_entities))
        from ..core.wal import wal as _wal

        if _wal.enabled:
            # Batch grouping in the WAL (doc/persistence.md): a crash
            # before the ack replays the prepared records to src and
            # sends a source-wins abort notice under THIS batch id.
            _wal.log_batch(batch_id, peer, list(handover_entities))
        # Eager replica delta BEFORE the prepare: if this gateway dies
        # with the prepare undelivered, some survivor's replica still
        # carries the batch for the adoption's source-wins replay.
        global_control.replicate_txns(records, peer, batch_id)
        sent = link.send(MessageType.TRUNK_HANDOVER_PREPARE, msg)
        # Prepare-side work on the initiator (journal prepare, src
        # remove, fan-out, trunk write), under the batch's trace id.
        _trace.span("fed.prepare", init_start, trace=trace_id)
        if not sent:
            # The link died under the write: deterministic abort, now.
            self._abort_batch(batch, "trunk lost at send")

    def _send_src_fanout(
        self, src_channel, src_channel_id: int, dst_channel_id: int,
        handover_entities: dict,
    ) -> None:
        """The identifier-only ChannelDataHandoverMessage every src-side
        subscriber gets — the only signal that the entities LEFT this
        gateway's cell (same shape as the local path, grid.py step 3)."""
        from ..core.data import reflect_channel_data_message
        from ..core.message import MessageContext

        spatial_data_msg = reflect_channel_data_message(ChannelType.SPATIAL)
        if spatial_data_msg is None:
            return
        initializer = getattr(spatial_data_msg, "init_data", None)
        if callable(initializer):
            initializer()
        for entity_id, entity_data in handover_entities.items():
            if entity_data is None:
                continue
            merger = getattr(entity_data, "merge_to", None)
            if callable(merger):
                merger(spatial_data_msg, False)
        shared = MessageContext(
            msg_type=MessageType.CHANNEL_DATA_HANDOVER,
            msg=spatial_pb2.ChannelDataHandoverMessage(
                srcChannelId=src_channel_id,
                dstChannelId=dst_channel_id,
                contextConnId=src_channel.latest_data_update_conn_id,
                data=pack_any(spatial_data_msg),
            ),
            channel_id=src_channel_id,
        )
        shared.ensure_raw_body()
        for conn in src_channel.get_all_connections():
            if conn is not None and not conn.is_closing():
                conn.send(shared)

    def _park(self, entity_id: int, src: int, dst: int,
              not_before: float = 0.0) -> None:
        prev = self._parked.get(entity_id)
        if prev is not None:
            # Chain: keep the ORIGINAL src (where the data actually
            # lives), follow the newest dst.
            src = prev.src_channel_id
        self._parked[entity_id] = ParkedCrossing(entity_id, src, dst,
                                                 not_before)

    def _abort_batch(self, batch: PendingBatch, reason: str,
                     busy=None) -> None:
        """Deterministic abort back to the source gateway: restore every
        entity's data to the src cell through the same FIFO queue the
        remove ran on, then park for re-offer."""
        from ..core.channel import get_channel
        from ..core.failover import journal

        if self._pending.pop(batch.batch_id, None) is None:
            return  # already resolved
        src = get_channel(batch.src_channel_id)
        restored = 0
        for rec in batch.records:
            journal.abort(rec)
            if rec.data is not None and src is not None \
                    and not src.is_removing():
                def _readd(ch, e=rec.entity_id, d=rec.data):
                    adder = getattr(ch.get_data_message(), "add_entity", None)
                    if adder is not None:
                        adder(e, d)

                src.execute(_readd)
                restored += 1
            retry_after = 0.0
            if busy is not None:
                retry_after = busy.retryAfterMs / 1000.0
            self._park(
                rec.entity_id, batch.src_channel_id, batch.dst_channel_id,
                not_before=time.monotonic() + retry_after,
            )
        self._count("aborted", len(batch.records))
        from ..core.wal import wal as _wal

        if _wal.enabled:
            _wal.log_batch_done(batch.batch_id, batch.peer, "aborted")
        if busy is not None:
            self._count("refused")  # batches, == busy frames received
        global_control.note_batch_aborted(batch, busy is not None)
        self._abort_notices.setdefault(batch.peer, {})[
            ("", batch.batch_id)
        ] = time.monotonic()
        link = self.link_to(batch.peer)
        if link is not None:
            self._flush_abort_notices(batch.peer, link)
        self._event({
            "kind": "abort", "batch": batch.batch_id, "peer": batch.peer,
            "reason": reason, "entities": len(batch.records),
            "restored": restored,
            "ids": [r.entity_id for r in batch.records],
        })
        if _trace.enabled:
            _trace.instant("fed.abort", trace=batch.trace_id or None)
            # An abort is a cross-gateway anomaly by definition: freeze
            # the timeline that led to it (cooldown-bounded).
            _trace.note_anomaly(
                "handover_abort",
                f"batch {batch.batch_id} -> {batch.peer}: {reason}",
            )
        logger.warning(
            "fed handover batch %d -> %s aborted (%s): %d entities "
            "restored to cell %d", batch.batch_id, batch.peer, reason,
            restored, batch.src_channel_id,
        )

    def _commit_batch(self, batch: PendingBatch) -> None:
        from ..core.channel import get_channel, remove_channel
        from ..core.failover import journal
        from ..spatial.controller import get_spatial_controller

        commit_start = _trace.now()
        flips = journal.commit(batch.records)
        ctl = get_spatial_controller()
        moved_hook = getattr(ctl, "_note_entity_data_moved", None)
        if moved_hook is not None and flips:
            moved_hook(flips, batch.dst_channel_id)
        simplane = getattr(ctl, "simplane", None)
        if simplane is not None:
            # Sim agents ride shard migration like any entity: the
            # remove_channel below untracks them (the agent flag clears
            # with the slot); the plane keeps its census accounting
            # exact (doc/simulation.md).
            simplane.on_agents_departed(batch.entities)
        redirected = []
        for eid in batch.entities:
            # The entity now lives on the peer: its local channel (and
            # any device tracking, via the channel_removed event) goes.
            ech = get_channel(eid)
            if ech is not None and not ech.is_removing():
                remove_channel(ech)
            for conn_id, (conn, anchor_eid) in list(
                self.client_anchors.items()
            ):
                if anchor_eid != eid:
                    continue
                if conn.is_closing():
                    del self.client_anchors[conn_id]
                    continue
                self._stage_redirect(conn, eid, batch)
                redirected.append(conn_id)
        self._count("committed", len(batch.records))
        from ..core.wal import wal as _wal

        if _wal.enabled:
            _wal.log_batch_done(batch.batch_id, batch.peer, "committed")
        # Commit retention (doc/global_control.md): the peer now holds
        # the only live copy; keep the batch until the peer's shard
        # replica covers it — the resurrection material if it dies
        # first.
        global_control.note_batch_committed(batch)
        self._event({
            "kind": "commit", "batch": batch.batch_id, "peer": batch.peer,
            "entities": len(batch.records), "redirect_conns": redirected,
            "ids": [r.entity_id for r in batch.records],
            "src": batch.src_channel_id, "dst": batch.dst_channel_id,
        })
        _trace.span("fed.commit", commit_start,
                    trace=batch.trace_id or None)

    # ---- initiator: client redirect --------------------------------------

    def _stage_redirect(self, conn, entity_id: int,
                        batch: PendingBatch) -> None:
        """Ask the destination to pre-stage the client's recovery state;
        the ClientRedirectMessage normally only goes out on its
        TrunkStageAck (the client must never arrive before its
        staging). But the redirect itself is never allowed to strand:
        if staging can't even be requested (trunk down), or the ack
        refuses or never comes (timeout loop), the client is redirected
        UNSTAGED — it re-joins the destination without recovery, which
        beats sitting on a gateway that no longer hosts its pawn."""
        if not conn.pit:
            return
        token = secrets.token_hex(8)
        link = self.link_to(batch.peer)
        if link is None:
            self._send_redirect(conn, batch.peer, entity_id,
                                batch.dst_channel_id, token, staged=False,
                                trace=batch.trace_id)
            return
        self._pending_redirects[conn.pit] = (
            conn, entity_id, batch.dst_channel_id, batch.peer, token,
            time.monotonic()
            + global_settings.federation_handover_timeout_ms / 1000.0,
            batch.trace_id,
        )
        link.send(
            MessageType.TRUNK_STAGE_REDIRECT,
            control_pb2.TrunkStageRedirectMessage(
                pit=conn.pit, entityId=entity_id,
                channelIds=[batch.dst_channel_id, entity_id], token=token,
                traceId=batch.trace_id,
            ),
        )

    def _send_redirect(self, conn, peer: str, entity_id: int,
                       dst_cid: int, token: str, staged: bool,
                       trace: str = "") -> None:
        from ..core.message import MessageContext

        if conn.is_closing():
            return
        _trace.instant("fed.redirect", trace=trace or None)
        addr = directory.client_addr(peer) or ""
        conn.send(MessageContext(
            msg_type=MessageType.CLIENT_REDIRECT,
            msg=control_pb2.ClientRedirectMessage(
                gatewayId=peer, addr=addr, entityId=entity_id,
                channelId=dst_cid, recoveryToken=token if staged else "",
            ),
            channel_id=0,
        ))
        conn.flush()
        self.client_anchors.pop(conn.id, None)
        from ..core import metrics

        metrics.redirects.inc()
        self.ledger["redirects"] = self.ledger.get("redirects", 0) + 1
        self._event({
            "kind": "redirect", "pit": conn.pit, "peer": peer,
            "entity": entity_id, "staged": staged,
        })
        log = logger.info if staged else logger.warning
        log(
            "client %s redirected to gateway %s (%s) for entity %d%s",
            conn.pit, peer, addr, entity_id,
            "" if staged else " UNSTAGED (staging unavailable)",
        )

    def _on_stage_ack(self, peer: str, msg) -> None:
        pending = self._pending_redirects.pop(msg.pit, None)
        if pending is None:
            return
        conn, entity_id, dst_cid, _peer, token, _deadline, trace = pending
        self._send_redirect(conn, peer, entity_id, dst_cid, token,
                            staged=bool(msg.ok), trace=trace)

    # ---- receiver: adopt / refuse / reconcile ----------------------------

    def _handle_prepare(self, peer: str, msg) -> None:
        from ..core.channel import (
            create_entity_channel,
            get_channel,
        )
        from ..core.overload import governor
        from ..spatial.controller import get_spatial_controller

        link = self.link_to(peer)
        # The initiator's trace id, propagated over the trunk: every
        # adoption span here carries it, so one id stitches the
        # handover across both gateways' recorders.
        trace = msg.traceId or None
        apply_start = _trace.now()

        def _ack(committed: bool, busy=None, reason: str = "") -> None:
            ack = control_pb2.TrunkHandoverAckMessage(
                batchId=msg.batchId, committed=committed, reason=reason,
                traceId=msg.traceId,
            )
            if busy is not None:
                ack.busy.CopyFrom(busy)
            if link is not None:
                link.send(MessageType.TRUNK_HANDOVER_ACK, ack)
            _trace.span("fed.apply" if committed else "fed.refuse",
                        apply_start, trace=trace)

        decision = governor.admit_federation_handover()
        if not decision.admitted:
            governor.count_shed("federation_handover")
            self._count("refused_remote")
            _ack(False, busy=control_pb2.ServerBusyMessage(
                reason=decision.reason,
                retryAfterMs=decision.retry_after_ms,
                overloadLevel=int(governor.level),
            ), reason="overload")
            return
        dst_ch = get_channel(msg.dstChannelId)
        if dst_ch is None or dst_ch.is_removing() or not dst_ch.has_owner():
            self._count("refused_remote")
            _ack(False, reason="no_channel")
            return

        # Validate the WHOLE batch before touching any state: a
        # committed ack covers every entity (the initiator tears all of
        # them down), so adoption is all-or-nothing — a partial apply
        # acked committed would silently lose the skipped entities
        # (already removed from the src cell at prepare time).
        owner = dst_ch.get_owner()
        validated: list[tuple[int, object]] = []
        for e in msg.entities:
            data_msg = None
            if e.data.type_url:
                try:
                    data_msg = unpack_any(e.data)
                except (KeyError, ValueError) as err:
                    logger.error(
                        "fed prepare %d: entity %d data undecodable (%s); "
                        "refusing the whole batch",
                        msg.batchId, e.entityId, err,
                    )
                    self._count("refused_remote")
                    _ack(False, reason="undecodable")
                    return
            if e.entityId < global_settings.entity_channel_id_start:
                self._count("refused_remote")
                _ack(False, reason="bad_entity_id")
                return
            validated.append((e.entityId, data_msg))
        if not validated:
            self._count("refused_remote")
            _ack(False, reason="no_entities")
            return

        adopted: dict[int, object] = {}
        created: list[int] = []
        try:
            for eid, data_msg in validated:
                ech = get_channel(eid)
                if ech is None or ech.is_removing():
                    ech = create_entity_channel(eid, owner)
                    created.append(eid)
                    if data_msg is not None:
                        ech.init_data(data_msg, None)
                    ctl = get_spatial_controller()
                    if ctl is not None:
                        ech.spatial_notifier = ctl
                else:
                    # The entity already lives here (a bounce-back, or
                    # a copy an abort restored while the peer's
                    # matching abort notice is still in flight): the
                    # incoming prepare is authoritative — purge the
                    # stale placement so the add below leaves exactly
                    # one copy, and replace the stale entity-channel
                    # data (the next handover out of here ships the
                    # channel's data; keeping the old copy would
                    # silently drop the peer's updates).
                    self._purge_local_placement(eid, msg.dstChannelId)
                    if data_msg is not None:
                        if ech.data is None:
                            ech.init_data(data_msg, None)
                        else:
                            def _replace(c, d=data_msg):
                                c.get_data_message().CopyFrom(d)

                            ech.execute(_replace)
                adopted[eid] = data_msg
        except Exception as err:  # noqa: BLE001 - must stay atomic
            from ..core.channel import remove_channel

            logger.error(
                "fed prepare %d: adoption failed mid-batch (%s); rolling "
                "back %d created channels and refusing",
                msg.batchId, err, len(created),
            )
            for eid in created:
                ech = get_channel(eid)
                if ech is not None and not ech.is_removing():
                    remove_channel(ech)
            self._count("refused_remote")
            _ack(False, reason="adoption_failed")
            return

        def _add(ch):
            data_msg = ch.get_data_message()
            adder = getattr(data_msg, "add_entity", None)
            if adder is None:
                return
            for eid, edata in adopted.items():
                if edata is not None:
                    adder(eid, edata)

        dst_ch.execute(_add)
        ctl = get_spatial_controller()
        if ctl is not None:
            # Device tracking + the authoritative placement ledger (the
            # TPU controller's _data_cell); host controllers have
            # neither.
            tracker = getattr(ctl, "track_entity", None)
            center = None
            if hasattr(ctl, "_cell_center"):
                center = ctl._cell_center(
                    msg.dstChannelId
                    - global_settings.spatial_channel_id_start
                )
            if tracker is not None and center is not None:
                for eid in adopted:
                    tracker(eid, center)
            moved_hook = getattr(ctl, "_note_entity_data_moved", None)
            if moved_hook is not None:
                moved_hook(list(adopted), msg.dstChannelId)
            simplane = getattr(ctl, "simplane", None)
            if simplane is not None:
                # Ids in the reserved agent range rejoin THIS gateway's
                # simulated population (doc/simulation.md): re-flagged
                # as agents, channel-backed by the adoption above.
                simplane.on_agents_adopted(list(adopted))

        self._dst_fanout(dst_ch, msg.srcChannelId, msg.dstChannelId, adopted)
        self._applied[(peer, msg.batchId)] = (msg.dstChannelId,
                                              list(adopted))
        while len(self._applied) > MAX_APPLIED_BATCHES:
            self._applied.popitem(last=False)
        from ..core.wal import wal as _wal

        if _wal.enabled:
            # The applied registry must survive a crash-restart: the
            # initiator's retransmitted abort notices key on it
            # (source-wins reconciliation, doc/persistence.md).
            _wal.log_applied(peer, msg.batchId, msg.dstChannelId,
                             list(adopted))
        self._count("applied", len(adopted))
        self._event({
            "kind": "applied", "batch": msg.batchId, "peer": peer,
            "entities": len(adopted), "dst": msg.dstChannelId,
            "ids": list(adopted),
        })
        _ack(True)

    def _dst_fanout(
        self, dst_ch, src_channel_id: int, dst_channel_id: int,
        adopted: dict,
    ) -> None:
        """Destination-side handover fan-out: subscribe every dst-cell
        connection to the adopted entity channels (WRITE for the cell
        owner), then one full-state ChannelDataHandoverMessage each
        (skipFirstFanOut on the subs — the handover message IS the full
        state, same contract as the local path's step 4-2)."""
        from ..core.channel import get_channel
        from ..core.data import reflect_channel_data_message
        from ..core.message import MessageContext
        from ..core.subscription import subscribe_to_channel
        from ..core.subscription_messages import send_subscribed

        spatial_data_msg = reflect_channel_data_message(ChannelType.SPATIAL)
        if spatial_data_msg is None:
            return
        initializer = getattr(spatial_data_msg, "init_data", None)
        if callable(initializer):
            initializer()
        for eid, edata in adopted.items():
            if edata is None:
                continue
            merger = getattr(edata, "merge_to", None)
            if callable(merger):
                merger(spatial_data_msg, True)  # full state: all new here
        write_opts = control_pb2.ChannelSubscriptionOptions(
            skipSelfUpdateFanOut=True, skipFirstFanOut=True,
            dataAccess=ChannelDataAccess.WRITE_ACCESS,
        )
        read_opts = control_pb2.ChannelSubscriptionOptions(
            skipSelfUpdateFanOut=True, skipFirstFanOut=True,
            dataAccess=ChannelDataAccess.READ_ACCESS,
        )
        ctx = MessageContext(
            msg_type=MessageType.CHANNEL_DATA_HANDOVER,
            msg=spatial_pb2.ChannelDataHandoverMessage(
                srcChannelId=src_channel_id,
                dstChannelId=dst_channel_id,
                data=pack_any(spatial_data_msg),
            ),
            channel_id=dst_channel_id,
        )
        ctx.ensure_raw_body()
        owner = dst_ch.get_owner()
        for conn in dst_ch.get_all_connections():
            if conn is None or conn.is_closing():
                continue
            for eid in adopted:
                ech = get_channel(eid)
                if ech is None:
                    continue
                opts = write_opts if conn is owner else read_opts
                cs, should_send = subscribe_to_channel(conn, ech, opts)
                if should_send and cs is not None:
                    send_subscribed(conn, ech, conn, 0, cs.options)
            conn.send(ctx)

    def _purge_local_placement(self, entity_id: int,
                               except_cell: Optional[int] = None) -> None:
        """Remove an entity from every local spatial cell's data (rare
        reconcile paths only; the entity may have crossed cells locally
        since it was applied, so the applied dst alone can't be
        trusted). Covers the data scan AND a local in-flight crossing's
        pending dst: that crossing's add is already queued on the dst
        channel but not yet visible in its data — queueing the purge on
        the same channel lands it AFTER the add (per-channel FIFO), so
        no ghost copy survives."""
        from ..core.channel import all_channels, get_channel
        from ..core.failover import journal

        lo = global_settings.spatial_channel_id_start
        hi = global_settings.entity_channel_id_start
        targets = []
        for cid, ch in all_channels().items():
            if not (lo <= cid < hi) or ch.is_removing():
                continue
            ents = getattr(ch.get_data_message(), "entities", None)
            if ents is None or entity_id not in ents:
                continue
            targets.append((cid, ch))
        pend_dst = journal.pending_dst(entity_id)
        if pend_dst is not None and lo <= pend_dst < hi:
            pch = get_channel(pend_dst)
            if pch is not None and not pch.is_removing() \
                    and all(cid != pend_dst for cid, _ in targets):
                targets.append((pend_dst, pch))
        for cid, ch in targets:
            if cid == except_cell:
                continue

            def _purge(c, e=entity_id):
                remover = getattr(c.get_data_message(), "remove_entity", None)
                if remover is not None:
                    remover(e)

            ch.execute(_purge)

    def _handle_abort_notice(self, peer: str, msg) -> None:
        """Source-wins reconciliation: purge entities an aborted batch
        left behind (applied here, but the initiator restored them after
        the partition)."""
        from ..core.channel import get_channel, remove_channel

        purged = 0
        purged_ids: list[int] = []
        # Batch ids are per-initiator: the notice names its initiator
        # when sent on a dead gateway's behalf, else it IS the sender.
        initiator = msg.initiator or peer
        for batch_id in msg.batchIds:
            applied = self._applied.pop((initiator, batch_id), None)
            if applied is None:
                continue
            _dst_cid, eids = applied
            for eid in eids:
                # Purge from wherever the entity sits NOW (it may have
                # crossed local cells since the apply).
                self._purge_local_placement(eid)
                ech = get_channel(eid)
                if ech is not None and not ech.is_removing():
                    remove_channel(ech)
                purged += 1
                purged_ids.append(eid)
        if purged:
            self._count("reconciled", purged)
            self._event({
                "kind": "reconciled", "peer": peer, "entities": purged,
                "ids": purged_ids,
            })
            logger.warning(
                "reconciled %d entities from %s's abort notices "
                "(source-wins)", purged, peer,
            )

    def _handle_stage_redirect(self, peer: str, msg) -> None:
        from ..core.connection_recovery import stage_recovery_handle

        _trace.instant("fed.stage", trace=msg.traceId or None)
        link = self.link_to(peer)
        try:
            handle = stage_recovery_handle(msg.pit, list(msg.channelIds))
        except RuntimeError as e:
            logger.warning("redirect staging for %s failed: %s", msg.pit, e)
            if link is not None:
                link.send(MessageType.TRUNK_STAGE_ACK,
                          control_pb2.TrunkStageAckMessage(
                              pit=msg.pit, ok=False))
            return
        self.ledger["staged"] = self.ledger.get("staged", 0) + 1
        if link is not None:
            link.send(MessageType.TRUNK_STAGE_ACK,
                      control_pb2.TrunkStageAckMessage(
                          pit=msg.pit, ok=True,
                          stagedConnId=handle.prev_conn_id))

    # ---- trunk callbacks -------------------------------------------------

    def _in_global_tick(self, fn) -> None:
        """Channel state is single-writer; handover resolution touches
        many channels, so it runs where local orchestration already does
        — inside the GLOBAL channel tick (inline when no runtime, e.g.
        sync tests)."""
        from ..core.channel import get_global_channel

        gch = get_global_channel()
        if gch is None or gch.is_removing():
            fn()
        else:
            gch.execute(lambda _ch: fn())

    def _on_trunk_message(self, peer: str, msg_type: int, msg) -> None:
        if msg_type == MessageType.TRUNK_HANDOVER_PREPARE:
            self._in_global_tick(lambda: self._handle_prepare(peer, msg))
        elif msg_type == MessageType.TRUNK_HANDOVER_ACK:
            self._in_global_tick(lambda: self._on_ack(peer, msg))
        elif msg_type == MessageType.TRUNK_ABORT_NOTICE:
            self._in_global_tick(
                lambda: self._handle_abort_notice(peer, msg)
            )
        elif msg_type == MessageType.TRUNK_STAGE_REDIRECT:
            self._in_global_tick(
                lambda: self._handle_stage_redirect(peer, msg)
            )
        elif msg_type == MessageType.TRUNK_STAGE_ACK:
            self._on_stage_ack(peer, msg)
        elif msg_type == MessageType.TRUNK_DIRECTORY_UPDATE:
            overrides = {o.channelId: o.gatewayId for o in msg.overrides}
            if msg.replaceOverrides:
                # Leader anti-entropy full sync: REPLACES the map, and
                # the lifecycle below runs for every changed mapping —
                # including overrides this gateway minted while
                # partitioned that the leader's map no longer carries.
                changed = directory.replace_update(overrides, msg.version)
            else:
                changed = overrides if directory.apply_update(
                    overrides, msg.version) else None
            if changed and global_control.active:
                # Cells newly mapped here come up; cells mapped away
                # while still hosted (returned-zombie) purge — channel
                # mutations, so inside the GLOBAL tick.
                self._in_global_tick(
                    lambda: global_control.on_directory_update(changed)
                )
        elif msg_type == MessageType.CELL_GEOMETRY_UPDATE:
            # A peer asserted its cell geometry (adaptive partitioning):
            # channel mutations may follow, so inside the GLOBAL tick.
            self._in_global_tick(
                lambda: global_control.on_geometry_update(peer, msg)
            )
        elif msg_type == MessageType.TRUNK_HELLO:
            pass  # re-hello after establishment: harmless
        elif msg_type == MessageType.TRUNK_HEARTBEAT:
            # Only goodbye heartbeats are forwarded by the link
            # (ordinary liveness probes are handled inside TrunkLink):
            # the peer is draining gracefully — the control plane skips
            # the death-miss window for it.
            global_control.on_peer_goodbye(peer)
        elif MessageType.TRUNK_LOAD_REPORT <= msg_type \
                <= MessageType.TRUNK_RESURRECT_HELLO:
            # Global-control + resurrection traffic (38-46): channel
            # mutations, so it dispatches inside the GLOBAL tick like
            # handover traffic.
            self._in_global_tick(
                lambda: global_control.on_trunk_message(peer, msg_type,
                                                        msg)
            )
        else:
            logger.error("unhandled trunk msgType %d from %s",
                         msg_type, peer)

    def _on_ack(self, peer: str, msg) -> None:
        batch = self._pending.pop(msg.batchId, None)
        refused_busy = msg.HasField("busy")
        if refused_busy and batch is not None:
            # Counted only when the batch is still ours to refuse: a
            # late busy ack for a batch the timeout already aborted
            # would otherwise break the refusals == busy-frames double
            # entry (nothing counts 'refused' for it).
            self.busy_frames += 1
        if batch is None:
            if msg.committed:
                # We already aborted (timeout / trunk flap) and restored
                # the entities locally, but the peer applied the batch:
                # tell it to purge (source wins) before the dup is
                # observable for more than a reconcile round-trip.
                link = self.link_to(peer)
                if link is not None:
                    link.send(
                        MessageType.TRUNK_ABORT_NOTICE,
                        control_pb2.TrunkAbortNoticeMessage(
                            batchIds=[msg.batchId]),
                    )
            return
        if msg.committed:
            self._commit_batch(batch)
        else:
            self._pending[msg.batchId] = batch  # _abort_batch pops it
            self._abort_batch(
                batch, f"remote refusal ({msg.reason or 'unspecified'})",
                busy=msg.busy if refused_busy else None,
            )

    def _on_trunk_up(self, peer: str, link) -> None:
        self._flush_abort_notices(peer, link)
        global_control.on_trunk_up(peer)
        # Re-offer parked crossings bound for this peer.
        self._in_global_tick(lambda: self._reoffer_parked(peer))
        self._event({"kind": "trunk_up", "peer": peer})

    def _on_trunk_down(self, peer: str, link) -> None:
        global_control.on_trunk_down(peer)
        self._event({"kind": "trunk_down", "peer": peer})

        def _abort_all():
            for batch in [b for b in self._pending.values()
                          if b.peer == peer]:
                self._abort_batch(batch, "trunk down")

        self._in_global_tick(_abort_all)

    def _flush_abort_notices(self, peer: str, link) -> None:
        """Send (and keep) the peer's queued abort notices: there is no
        end-to-end ack, so a successful local send proves nothing — the
        queue drains by TTL, with the timeout loop re-flushing while
        the trunk is up (idempotent on the receiver)."""
        notices = self._abort_notices.get(peer)
        if not notices:
            return
        now = time.monotonic()
        for key in [k for k, t0 in notices.items()
                    if now - t0 > ABORT_NOTICE_TTL_S]:
            del notices[key]
        if not notices:
            return
        self._notices_flushed_at[peer] = now
        # One message per initiator (the receiver's registry is keyed
        # (initiator, batch id); "" = this gateway, resolved to the
        # sender on the far end).
        by_initiator: dict[str, list[int]] = {}
        for initiator, batch_id in notices:
            by_initiator.setdefault(initiator, []).append(batch_id)
        for initiator, batch_ids in by_initiator.items():
            link.send(
                MessageType.TRUNK_ABORT_NOTICE,
                control_pb2.TrunkAbortNoticeMessage(
                    batchIds=batch_ids, initiator=initiator),
            )

    # ---- re-offer / timeout machinery ------------------------------------

    def _reoffer_parked(self, peer: Optional[str] = None) -> None:
        from ..core.channel import get_channel
        from ..core.failover import journal
        from ..spatial.controller import get_spatial_controller

        ctl = get_spatial_controller()
        ledger = getattr(ctl, "_data_cell", {})
        now = time.monotonic()
        for eid, parked in list(self._parked.items()):
            if parked.not_before > now:
                continue
            if get_channel(eid) is None:
                del self._parked[eid]  # entity destroyed while parked
                continue
            if journal.pending_dst(eid) is not None \
                    or journal.remote_in_flight(eid):
                continue  # mid-flight elsewhere: next sweep re-checks
            # The parked src can be STALE: a local crossing orchestrated
            # while the entity waited moved its data to another cell
            # (the park only freezes the trunked hop, not the entity).
            # Removing from the parked src would leave the live copy
            # behind as a duplicate — the placement ledger has the
            # authoritative cell.
            src = ledger.get(eid, parked.src_channel_id)
            dst_peer = directory.gateway_of_cell(parked.dst_channel_id)
            if dst_peer is None or dst_peer == directory.local_id:
                # A directory override re-shard landed the dst cell on
                # THIS gateway while the crossing was parked: it is a
                # plain local crossing now — run it through local
                # orchestration instead of stranding it forever.
                del self._parked[eid]
                if parked.dst_channel_id == src:
                    # A reverted shard migration (or the data already
                    # chained into the dst cell): nothing to move.
                    continue
                orchestrate = getattr(ctl, "_orchestrate_pair", None)
                if orchestrate is not None and get_channel(
                        parked.dst_channel_id) is not None:
                    orchestrate(src, parked.dst_channel_id,
                                [lambda s, d, e=eid: e])
                continue
            if peer is not None and dst_peer != peer:
                continue
            if self.link_to(dst_peer) is None:
                continue
            del self._parked[eid]
            if src == parked.dst_channel_id:
                continue  # data already sits in the dst cell
            self.initiate_handover(
                src, parked.dst_channel_id, [lambda s, d, e=eid: e],
            )

    async def _timeout_loop(self) -> None:
        while self.active:
            try:
                await asyncio.sleep(0.1)
            except asyncio.CancelledError:
                return
            now = time.monotonic()
            expired = [b for b in self._pending.values() if now > b.deadline]
            if expired:
                def _expire(batches=expired):
                    for b in batches:
                        if b.batch_id in self._pending:
                            self._abort_batch(b, "ack timeout")

                self._in_global_tick(_expire)
            if self._parked:
                self._in_global_tick(lambda: self._reoffer_parked())
            for peer, notices in list(self._abort_notices.items()):
                if not notices:
                    continue
                if now - self._notices_flushed_at.get(peer, 0.0) \
                        < ABORT_NOTICE_RESEND_S:
                    continue
                link = self.link_to(peer)
                if link is not None:
                    self._flush_abort_notices(peer, link)
            # Staged redirects whose ack never came: redirect UNSTAGED
            # rather than strand the client (its pawn is already gone
            # from this gateway).
            for pit, pending in list(self._pending_redirects.items()):
                if now <= pending[5]:
                    continue
                del self._pending_redirects[pit]
                conn, entity_id, dst_cid, peer, token, _d, trace = pending
                self._send_redirect(conn, peer, entity_id, dst_cid,
                                    token, staged=False, trace=trace)

    # ---- reporting -------------------------------------------------------

    def report(self) -> dict:
        return {
            "directory": directory.report(),
            "ledger": dict(self.ledger),
            "busy_frames": self.busy_frames,
            "pending": len(self._pending),
            "parked": len(self._parked),
            "applied_batches": len(self._applied),
            "events": list(self.events),
        }


plane = FederationPlane()


def init_federation(
    config, gateway_id: str, controller=None
) -> None:
    """Arm the federation plane: load the shard directory (``config`` is
    a path or a dict), attach the controller's geometric cell->server
    resolver, and reset plane state. ``plane.start()`` (async) then
    brings the trunks up."""
    plane.reset()
    if isinstance(config, dict):
        directory.load_dict(config, gateway_id)
    else:
        directory.load(config, gateway_id)
    if controller is not None:
        attach_controller(controller)


def attach_controller(controller) -> None:
    def _resolver(cell_channel_id: int):
        try:
            return controller.server_index_of_cell(cell_channel_id)
        except (ValueError, AttributeError):
            return None

    directory.attach_resolver(_resolver)


def reset_federation() -> None:
    """Test hook (also the disarm path)."""
    plane.stop()
    plane.reset()
    global_control.reset()
    directory.reset()
